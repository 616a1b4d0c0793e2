"""Capacity-based (dropping) Mixture-of-Experts FFN.

Port of the reference ``models/moe.py``. Token dispatch uses the one-hot
cumsum position trick (GShard/Switch) with scatter/gather data movement
rather than the O(T·E·C·d) dispatch einsum, so only the active experts'
GEMMs run. Slots are token-major (token t's K choices are slots
t*K .. t*K+K-1), and a slot's position in its expert's batch is its rank
among the slots routed there, so earlier rows win capacity. The capacity
counts every row handed in (padding and free slots too), as the
reference's does: the same rows give the same drops.

In a data-parallel training step (``sharding.data_parallel``) each rank
holds its rows of the global batch, in row order, and the layer computes
what the reference computes over the global batch: the capacity of the
global token count, each slot's position after the slots of earlier
ranks, and the aux loss's batch means over every rank.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import MoEConfig
from repro_torch.core.router import top_k
from repro_torch.sharding import data_parallel as dp


@torch.no_grad()
def moe_init(p, generator: torch.Generator, d_model: int, d_ff: int
             ) -> None:
    """Draw ``p``'s leaves (``router`` fp32 (d, E), ``e_gate``/``e_up``
    (E, d, f), ``e_down`` (E, f, d)) with the reference's scales: normal
    times 1/sqrt(fan_in)."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    for name, std in (("router", s_in), ("e_gate", s_in), ("e_up", s_in),
                      ("e_down", s_out)):
        t = p[name]
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * std)


def moe_capacity(num_tokens: int, cfg: MoEConfig) -> int:
    cap = int(math.ceil(num_tokens * cfg.top_k * cfg.capacity_factor
                        / cfg.num_experts))
    return max(8, int(math.ceil(cap / 8) * 8))


def moe_ffn(x: torch.Tensor, p, cfg: MoEConfig,
            capacity: Optional[int] = None,
            rec: Optional[obs.DeviceRecorder] = None, with_aux: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (T, d) flattened tokens -> (y: (T, d), aux_loss: fp32 scalar, or
    None with ``with_aux=False``: serving drops it, and eager PyTorch would
    launch its kernels all the same).

    The router scores ``x.float()`` in fp32; a kept slot's token is
    written into its expert's batch (E, capacity, d), a dropped one into a
    trash row whose expert output reads as 0. The gate-weighted sum over
    the K choices runs in x's dtype. ``rec`` counts the kept slots on the
    device (``moe/dispatched_slots``) and the routed ones, T·K, on the host
    (``moe/routed_slots``): the dropped ones are their difference.
    """
    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    sharded = dp.data_group() is not None
    T_all = T * dp.world()                 # the ranks hold equal rows
    if capacity is None:
        capacity = moe_capacity(T_all, cfg)
    capacity = min(capacity, T_all * K)

    probs = torch.softmax(x.float() @ p["router"], dim=-1)        # (T, E)
    gates, ids = top_k(probs, K)                                  # (T, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    aux = None
    if with_aux:
        # load-balancing aux loss (Switch): E * sum(frac_tokens * frac_probs)
        me = probs.mean(dim=0)
        ce = F.one_hot(ids[:, 0], E).float().mean(dim=0)
        if sharded:
            me, ce = dp.global_mean(me), dp.global_sum(ce) / dp.world()
        aux = E * (me * ce).sum() * cfg.aux_loss_weight

    flat = ids.reshape(-1)                                        # (T*K,)
    onehot = F.one_hot(flat, E)
    pos = (onehot.cumsum(dim=0) - 1).mul_(onehot).sum(dim=1)
    if sharded:
        # a slot's place among its expert's slots of the global batch
        keep = pos + dp.ranks_before(onehot.sum(dim=0))[flat] < capacity
    else:
        keep = pos < capacity
    rows = min(capacity, T * K)            # this rank's kept slots fit
    row = torch.where(keep, pos, rows)                            # trash row
    if rec is not None:
        rec.inc("moe/dispatched_slots", keep.sum(dtype=torch.float32))
        rec.inc("moe/routed_slots", T * K)

    xe = x.new_zeros((E, rows + 1, d))
    xe[flat, row] = x[:, None].expand(T, K, d).reshape(T * K, d)
    xe = xe[:, :rows]
    h = F.silu(torch.bmm(xe, p["e_gate"])) * torch.bmm(xe, p["e_up"])
    ye = F.pad(torch.bmm(h, p["e_down"]), (0, 0, 0, 1))          # trash: 0

    y_slots = ye[flat, row]                                       # (T*K, d)
    y = (y_slots.view(T, K, d) * gates[..., None].to(x.dtype)).sum(dim=1)
    return y.to(x.dtype), aux
