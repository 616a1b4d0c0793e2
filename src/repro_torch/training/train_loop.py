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

With a ``mesh`` (``launch/mesh.make_host_mesh``) the run is the
reference's pjit run under its training rules: the parameters are
sharded over the mesh's ``data`` axis by FSDP (``fully_shard``), each on
the dim that the rules put on ``data`` (dim 0 where they put none), and
every rank takes its rows of the same global batch. The arithmetic stays
the global batch's: the loss divides by the global mask count, the MoE
layers take the global capacity, positions and aux means
(``sharding.data_parallel``), the gradients are summed over the ranks, the
clip's norm spans every shard, and AdamW updates each shard where it lies.
Every rank logs the same history.

A mesh whose ``model`` axis is larger than 1 adds tensor parallelism
(every family): every parameter becomes a ``DTensor`` at the placements
the rules give it over the whole 2-D mesh, ``data`` on its FSDP dim and
``model`` on its heads, FFN, vocab, expert or inner (SSM, RG-LRU) dim
(the MoE layer expert parallel, ``models/moe.py``; the state families'
mixers on local tensors, ``tensor_parallel.block_call``), and each rank's
rows of the batch a ``DTensor`` split over ``data``. The step is the
unmeshed one on these values (``sharding/tensor_parallel.py``): each
weight is gathered over ``data`` where its product reads it and its
gradient reduce-scattered back, as FSDP does, and the partial sums of the
``model`` axis are reduced where the rules pin the activations.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_train_batches
from repro_torch.models.model import Model, build_model
from repro_torch.sharding import data_parallel as dp
from repro_torch.sharding.specs import (TRAIN_RULES, current_rules,
                                        named_sharding_tree, param_specs)
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
    """Gradients on for every parameter, restored on exit (by name: FSDP
    replaces the parameter objects)."""
    flags = {n: p.requires_grad for n, p in params.named_parameters()}
    for p in params.parameters():
        p.requires_grad_(True)
    try:
        yield params
    finally:
        for n, p in params.named_parameters():
            p.grad = None
            p.requires_grad_(flags[n])


class _LossRoot(nn.Module):
    """FSDP's unit: its ``forward`` is the family's ``train_loss``, so that
    FSDP's hooks gather the parameters that the family's code reads as
    attributes."""

    def __init__(self, model: Model, params: nn.Module, remat: bool):
        super().__init__()
        self.model, self.params, self.remat = model, params, remat

    def forward(self, batch):
        return self.model.train_loss(self.params, batch, remat=self.remat)


@dataclass
class Sharded:
    """Parameters under FSDP over one mesh axis: the root unit, the axis'
    process group, and the parameters left whole on every rank."""
    root: nn.Module
    group: Any
    whole: List[nn.Parameter]

    def reduce_whole(self) -> None:
        """Sum the whole parameters' gradients over the ranks."""
        for p in self.whole:
            if p.grad is not None:
                dist.all_reduce(p.grad, group=self.group)


def _data_dim(spec) -> int:
    """The tensor dim that a resolved spec puts on ``data``; 0 if none."""
    return next((i for i, ax in enumerate(spec) if ax == "data" or
                 (isinstance(ax, tuple) and "data" in ax)), 0)


def shard_params(model: Model, params: nn.Module, mesh, *,
                 remat: bool = True) -> Sharded:
    """``fully_shard`` ``params`` (gradients on) over ``mesh``'s ``data``
    axis, each parameter on the dim that the installed rules (else
    ``TRAIN_RULES``) put on ``data``, dim 0 where they put none. FSDP
    gathers one dtype per unit, so parameters of another dtype than the
    bulk's (an fp32 router among bf16 weights) stay whole on every rank
    and their gradients are summed (``Sharded.reduce_whole``).
    Gradients are summed over the ranks, not averaged: each rank's loss is
    its share of the global mean."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    if mesh["model"].size() > 1:
        raise ValueError("a model axis of more than 1: tensor_parallel")
    specs = param_specs(params, current_rules() or TRAIN_RULES, mesh)
    dims = {id(p): _data_dim(specs[n]) for n, p in params.named_parameters()}
    sizes = Counter()
    for p in params.parameters():
        sizes[p.dtype] += p.numel()
    bulk = sizes.most_common(1)[0][0]
    whole = [p for p in params.parameters() if p.dtype != bulk]
    root = _LossRoot(model, params, remat)
    fully_shard(root, mesh=mesh["data"],
                shard_placement_fn=lambda p: Shard(dims[id(p)]),
                ignored_params=set(whole) or None)
    root.set_gradient_divide_factor(1.0)
    root.set_force_sum_reduction_for_comms(True)     # gloo has no PREMUL_SUM
    return Sharded(root, mesh.get_group("data"), whole)


def tensor_parallel(model: Model, params: nn.Module, mesh) -> None:
    """Place every parameter of ``params`` (gradients on) as a ``DTensor``
    at its rules' placements over the 2-D ``mesh`` (the installed rules,
    else ``TRAIN_RULES``), in place, for every family's module: the
    dense family's layers, or the others' ``ParamTree``."""
    placed = named_sharding_tree(params, current_rules() or TRAIN_RULES,
                                 mesh)
    for name, t in placed.items():
        *path, leaf = name.split(".")
        params.get_submodule(".".join(path)).register_parameter(
            leaf, nn.Parameter(t, requires_grad=True))


def _replicated(v: torch.Tensor) -> torch.Tensor:
    """A metric's value on this rank: a ``DTensor``'s whole value."""
    if not isinstance(v, DTensor):
        return v
    return v.redistribute(v.device_mesh,
                          [Replicate()] * v.device_mesh.ndim).to_local()


def _grad(p: nn.Parameter) -> torch.Tensor:
    """``p``'s gradient (zeros where it has none) at ``p``'s placements:
    a meshed product leaves the gradient of a replicated weight a partial
    sum of the ranks'."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def batch_rows(batch: Dict[str, np.ndarray], rank: int, world: int
               ) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows of a global batch split over ``world`` ranks
    in row order (``"batch": "data"``)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"batch of {v.shape[0]} rows does not split "
                             f"over {world} ranks")
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def make_train_step(model: Model, loop_cfg: TrainLoopConfig,
                    sharded: Optional[Sharded] = None) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics),
    with the parameters' gradients on (``trainable``); metrics stay 0-dim
    tensors on the device. With ``sharded`` the batch is this rank's rows
    and the metrics are the global batch's."""
    lr = cosine_schedule(loop_cfg.lr, loop_cfg.warmup, loop_cfg.num_steps)

    def step(params, opt_state, batch):
        if sharded is None:
            loss, metrics = model.train_loss(params, batch,
                                             remat=loop_cfg.remat)
            loss.backward()
        else:
            # remat recomputes the MoE layers' collectives in the backward
            with dp.data_parallel(sharded.group):
                _, metrics = sharded.root(batch)
                ce, aux = metrics["ce_loss"], metrics["moe_aux"]
                # each rank's share of the global loss: its rows' ce, and
                # 1/W of the aux, whose means every rank computes whole
                (ce + aux / dp.world()).backward()
                ce = dp.global_sum(ce)
            sharded.reduce_whole()
            loss, metrics = ce + aux, {"ce_loss": ce, "moe_aux": aux}
        grads = {n: _grad(p) for n, p in params.named_parameters()}
        params, opt_state = adamw_update(
            grads, opt_state, params, lr=lr,
            weight_decay=loop_cfg.weight_decay,
            grad_clip=loop_cfg.grad_clip)
        for p in params.parameters():
            p.grad = None
        metrics = {k: _replicated(v.detach())
                   for k, v in dict(metrics, loss=loss).items()}
        return params, opt_state, metrics

    return step


def train(cfg: ModelConfig, loop_cfg: TrainLoopConfig,
          batches: Optional[Iterator[Dict[str, Any]]] = None,
          params: Optional[nn.Module] = None, *, device=None, mesh=None
          ) -> Dict[str, Any]:
    """Train for ``loop_cfg.num_steps`` steps on ``device`` (the card by
    default), from ``params`` or from a fresh init drawn by a generator
    seeded with ``loop_cfg.seed``. With ``ckpt_dir``, resume from its
    latest checkpoint, and save every ``ckpt_every`` steps. ``batches``
    (numpy dicts; default: the synthetic stream of ``loop_cfg.seed``) are
    read from their start, whatever step the run resumes at, as the
    reference reads them. With ``mesh``, every rank of the process group
    calls it with the same arguments, and the parameters and moments come
    back sharded (``DTensor``). Returns {"params", "opt_state",
    "history"}."""
    device = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(
            torch.Generator(device).manual_seed(loop_cfg.seed), device)
    params = params.to(device)
    if batches is None:
        batches = make_train_batches(cfg, loop_cfg.batch_size,
                                     loop_cfg.seq_len, seed=loop_cfg.seed)
    history: List[Dict[str, float]] = []
    with trainable(params):
        sharded, rank, world, tp_mesh = None, 0, 1, None
        if mesh is not None and mesh["model"].size() > 1:
            tensor_parallel(model, params, mesh)
            tp_mesh = mesh
            names = mesh.mesh_dim_names
            rows = [Shard(0) if n in ("pod", "data") else Replicate()
                    for n in names]
            for n in ("pod", "data"):     # the batch splits over both
                if n in names:
                    rank = rank * mesh[n].size() + mesh.get_local_rank(n)
                    world *= mesh[n].size()
        elif mesh is not None:
            sharded = shard_params(model, params, mesh,
                                   remat=loop_cfg.remat)
            rank, world = dist.get_rank(sharded.group), \
                dist.get_world_size(sharded.group)
        opt_state = adamw_init(params)
        start_step = 0
        if loop_cfg.ckpt_dir:
            latest = ckpt_lib.latest_checkpoint(loop_cfg.ckpt_dir)
            if latest:
                start_step, params, opt_state = ckpt_lib.restore_checkpoint(
                    latest, params, opt_state)
        step_fn = make_train_step(model, loop_cfg, sharded)
        loud = not dist.is_initialized() or dist.get_rank() == 0
        t0 = time.perf_counter()
        for step_idx in range(start_step, loop_cfg.num_steps):
            batch = next(batches)
            if world > 1:
                batch = batch_rows(batch, rank, world)
            batch = to_device(batch, device)
            if tp_mesh is not None:
                batch = {k: DTensor.from_local(v, tp_mesh, rows,
                                               run_check=False)
                         for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if (loop_cfg.log_every and step_idx % loop_cfg.log_every == 0) \
                    or step_idx == loop_cfg.num_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step_idx
                m["elapsed_s"] = time.perf_counter() - t0
                history.append(m)
                if loud:
                    print(f"step {step_idx:5d} loss {m['loss']:.4f} "
                          f"ce {m.get('ce_loss', 0.0):.4f} "
                          f"({m['elapsed_s']:.1f}s)", flush=True)
            if (loop_cfg.ckpt_dir and loop_cfg.ckpt_every
                    and (step_idx + 1) % loop_cfg.ckpt_every == 0):
                ckpt_lib.save_checkpoint(loop_cfg.ckpt_dir, step_idx + 1,
                                         params, opt_state)
    return {"params": params, "opt_state": opt_state, "history": history}
