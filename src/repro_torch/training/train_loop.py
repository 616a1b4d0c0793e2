"""Training loop: loss -> gradients -> AdamW, the data stream, periodic
checkpoints and a metric log.

Port of the reference ``training/train_loop.py``, with its defaults and
its history records (``loss``, ``ce_loss``, ``moe_aux``, ``step``,
``elapsed_s``). The step is eager: ``train_loss`` under autograd,
``backward()``, then ``adamw_update`` in place (the reference jits its
step and donates the buffers; here the parameters and moments are
updated where they lie). The loop runs on the card unless the caller
passes the CPU; the parameters train with gradients on and are handed
back with them off, as the serving path keeps them.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_train_batches
from repro_torch.models.model import Model, build_model
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                            cosine_schedule)


@dataclass
class TrainLoopConfig:
    num_steps: int = 100
    batch_size: int = 8
    seq_len: int = 256
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    log_every: int = 10
    remat: bool = True
    seed: int = 0


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to train on the CPU")
    return device


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """One numpy batch on ``device``: integer arrays (tokens, targets) as
    int64, float arrays (mask, frontend embeddings) as fp32."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.long() if not t.is_floating_point() else t.float()
        out[k] = t.to(device, non_blocking=True)
    return out


@contextlib.contextmanager
def trainable(params: nn.Module):
    """Gradients on for every parameter, restored on exit."""
    flags = [(p, p.requires_grad) for p in params.parameters()]
    for p, _ in flags:
        p.requires_grad_(True)
    try:
        yield params
    finally:
        for p, flag in flags:
            p.grad = None
            p.requires_grad_(flag)


def make_train_step(model: Model, loop_cfg: TrainLoopConfig) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics),
    with the parameters' gradients on (``trainable``); metrics stay 0-dim
    tensors on the device."""
    lr = cosine_schedule(loop_cfg.lr, loop_cfg.warmup, loop_cfg.num_steps)

    def step(params, opt_state, batch):
        loss, metrics = model.train_loss(params, batch,
                                         remat=loop_cfg.remat)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.named_parameters()}
        params, opt_state = adamw_update(
            grads, opt_state, params, lr=lr,
            weight_decay=loop_cfg.weight_decay,
            grad_clip=loop_cfg.grad_clip)
        for p in params.parameters():
            p.grad = None
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return params, opt_state, metrics

    return step


def train(cfg: ModelConfig, loop_cfg: TrainLoopConfig,
          batches: Optional[Iterator[Dict[str, Any]]] = None,
          params: Optional[nn.Module] = None, *, device=None
          ) -> Dict[str, Any]:
    """Train for ``loop_cfg.num_steps`` steps on ``device`` (the card by
    default), from ``params`` or from a fresh init drawn by a generator
    seeded with ``loop_cfg.seed``. With ``ckpt_dir``, resume from its
    latest checkpoint, and save every ``ckpt_every`` steps. ``batches``
    (numpy dicts; default: the synthetic stream of ``loop_cfg.seed``) are
    read from their start, whatever step the run resumes at, as the
    reference reads them. Returns {"params", "opt_state", "history"}."""
    device = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(
            torch.Generator(device).manual_seed(loop_cfg.seed), device)
    params = params.to(device)
    opt_state = adamw_init(params)

    start_step = 0
    if loop_cfg.ckpt_dir:
        latest = ckpt_lib.latest_checkpoint(loop_cfg.ckpt_dir)
        if latest:
            start_step, params, opt_state = ckpt_lib.restore_checkpoint(
                latest, params, opt_state)

    step_fn = make_train_step(model, loop_cfg)

    if batches is None:
        batches = make_train_batches(cfg, loop_cfg.batch_size,
                                     loop_cfg.seq_len, seed=loop_cfg.seed)
    history: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    with trainable(params):
        for step_idx in range(start_step, loop_cfg.num_steps):
            batch = to_device(next(batches), device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if (loop_cfg.log_every and step_idx % loop_cfg.log_every == 0) \
                    or step_idx == loop_cfg.num_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step_idx
                m["elapsed_s"] = time.perf_counter() - t0
                history.append(m)
                print(f"step {step_idx:5d} loss {m['loss']:.4f} "
                      f"ce {m.get('ce_loss', 0.0):.4f} "
                      f"({m['elapsed_s']:.1f}s)", flush=True)
            if (loop_cfg.ckpt_dir and loop_cfg.ckpt_every
                    and (step_idx + 1) % loop_cfg.ckpt_every == 0):
                ckpt_lib.save_checkpoint(loop_cfg.ckpt_dir, step_idx + 1,
                                         params, opt_state)
    return {"params": params, "opt_state": opt_state, "history": history}
