"""The data-parallel group of a training step, and the batch-wide sums it
needs.

Under the reference's pjit every reduction over the batch spans the
global batch. The port's ranks each hold their rows of it, so the few
places where the arithmetic couples rows across the batch ask this module
for the group: the loss's mask count (``models/dense.lm_loss``), and the
MoE layer's expert capacity, slot positions and load-balancing means
(``models/moe.moe_ffn``). Outside ``data_parallel`` (serving, one-device
training) there is no group and every function here is the identity.

The group is a module global, not a thread-local: on the card autograd
runs the backward pass, and with it the recompute of a remat'd layer, on
a device thread of its own, which must see the group that the forward
pass saw.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_group: Optional[dist.ProcessGroup] = None


def data_group() -> Optional[dist.ProcessGroup]:
    """The installed data-parallel group, or None."""
    return _group


@contextlib.contextmanager
def data_parallel(group: Optional[dist.ProcessGroup]):
    """Install ``group`` (the ranks that split the batch, in row order) for
    the duration of the block."""
    global _group
    prev, _group = _group, group
    try:
        yield group
    finally:
        _group = prev


def world() -> int:
    """The number of ranks splitting the batch (1 without a group)."""
    g = data_group()
    return 1 if g is None else dist.get_world_size(g)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the group's ranks, outside autograd."""
    g = data_group()
    if g is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=g)
    return t


class _AllReduce(torch.autograd.Function):
    """Sum over the group's ranks, whose backward sums the ranks'
    gradients of the sum (each rank's input reaches every rank's output)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group), None


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean over the ranks of each rank's ``t`` (each rank's batch mean
    gives the global batch mean: the ranks hold equal rows), under
    autograd: the backward pass sums the ranks' gradients, so a loss that
    every rank counts once in W must enter each rank's share as 1/W."""
    g = data_group()
    if g is None:
        return t
    return _AllReduce.apply(t, g) / dist.get_world_size(g)


def ranks_before(counts: torch.Tensor) -> torch.Tensor:
    """Sum of ``counts`` over the ranks before this one in the installed
    group: the exclusive prefix that turns a rank-local position into a
    global one."""
    g = data_group()
    parts = [torch.empty_like(counts) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, counts.contiguous(), group=g)
    rank = dist.get_rank(g)
    return torch.stack(parts[:rank]).sum(0) if rank else \
        torch.zeros_like(counts)
