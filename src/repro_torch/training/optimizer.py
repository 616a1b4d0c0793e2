"""AdamW and a cosine schedule over the port's parameter modules.

Port of the reference ``training/optimizer.py``, with its arithmetic: the
moments are fp32 whatever the parameters' dtype, one global-norm clip
over every gradient, the update ``mhat / (sqrt(nhat) + eps) + wd * p``
computed in fp32 and rounded once into the parameter's dtype, and the
schedule read at ``step + 1``. ``torch.optim.AdamW`` is not used: it keeps
its moments in the parameter's dtype and decays and clips otherwise.

The state's moments are dicts keyed by the module's parameter names
(``named_parameters()``); the update writes the parameters and moments
in place, one leaf at a time, so no more than one leaf's fp32
temporaries live at once (the reference's functional update returns new
trees). Scalars that the reference computes in fp32 (the schedule, the
bias corrections) are computed in fp32 here too.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch
from torch import nn

Moments = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    mu: Moments
    nu: Moments


def adamw_init(params: nn.Module) -> AdamWState:
    """Zero fp32 moments beside every parameter, on its device."""
    def zeros() -> Moments:
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.named_parameters()}
    return AdamWState(0, zeros(), zeros())


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[int], float]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine to
    0 at ``total``; evaluated in fp32, returned as a Python float (an fp32
    value)."""
    def lr(step: int) -> float:
        s = _f32(step)
        if step < warmup:
            return float(_f32(base_lr) * s / max(warmup, 1))
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return float(_f32(0.5 * base_lr) * (1.0 + torch.cos(math.pi * prog)))
    return lr


def global_norm(grads: Moments) -> torch.Tensor:
    """sqrt of the sum of every gradient's fp32 squares: a 0-dim fp32
    tensor on the gradients' device (no host sync)."""
    total = 0
    for g in grads.values():
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Moments, state: AdamWState, params: nn.Module, *,
                 lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0
                 ) -> Tuple[nn.Module, AdamWState]:
    """One AdamW step: ``grads`` (by parameter name) clipped to a global
    norm of ``grad_clip``, then every parameter and its moments updated in
    place. Returns (params, the state with ``step + 1``)."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, grad_clip)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = float(1 - torch.pow(_f32(b1), _f32(step)))
    bc2 = float(1 - torch.pow(_f32(b2), _f32(step)))
    for name, p in params.named_parameters():
        m, n = state.mu[name], state.nu[name]
        g = grads[name].float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        n.mul_(b2).add_((1 - b2) * g * g)
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(n / bc2) + eps) + weight_decay * pf
        p.copy_(pf - lr_t * delta)
    return params, AdamWState(step, state.mu, state.nu)
