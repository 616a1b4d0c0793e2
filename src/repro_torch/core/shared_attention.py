"""Shared KV Attention (paper §III.A, Fig. 2a) — the core contribution.

Port of the reference ``core/shared_attention.py``. N concurrent query
groups routed to the same shared chunk are gathered into one (N x d) query
matrix and attended against the chunk's KV in one GEMM:

    route -> dispatch_plan -> scatter Q to (chunks, capacity, ...)
          -> per-chunk GEMM attention (the ``shared_chunk_attention`` kernel)
          -> LSE-merge over the k selected chunks, each partial read where
             the chunk's attention wrote it (the ``lse_merge`` kernel's
             routed entry).

On a CUDA tensor both steps launch the hand-written kernels; on the CPU
the same wrappers take their plain versions. The kernel keeps the softmax
probabilities in fp32 through PV, as the TPU kernel does (the reference's
jnp path casts them to v.dtype first). An int8 store (``k_scale`` and
``v_scale`` given) goes to the ``shared_chunk_attention_q8`` kernel, which
dequantizes the int8 K/V in its loads: no dequantized copy of the store
is made.

``shared_attention_gather_ref`` is the per-request gather oracle (what a
non-batched system does), plain PyTorch.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.core import router as router_lib
from repro_torch.kernels import ops
from repro_torch.sharding.specs import lsc


class SharedPartial(NamedTuple):
    out: torch.Tensor     # (G, Q, H, D)
    lse: torch.Tensor     # (G, Q, H) fp32; -1e30 where nothing attended


def _record_dispatch(rec: Optional[obs.DeviceRecorder], qmask: torch.Tensor,
                     keep: torch.Tensor, layer_idx: Optional[int]) -> None:
    """Dispatch-density metrics, queued as device tensors (no sync): the
    fraction of (chunk, capacity) slots filled, and how many (group, k)
    routes fell off the capacity cliff, overall and per layer."""
    if rec is None:
        return
    util = qmask.float().mean()
    dropped = (~keep).sum()
    rec.observe("moska/dispatch_capacity_utilization", util,
                obs.FRACTION_EDGES)
    if layer_idx is not None:
        rec.observe(f"moska/dispatch_capacity_utilization_by_layer/"
                    f"L{layer_idx}", util, obs.FRACTION_EDGES)
        rec.inc(f"moska/dropped_queries_by_layer/L{layer_idx}", dropped)
    rec.inc("moska/dispatched_queries", keep.sum())
    rec.inc("moska/dropped_queries", dropped)


def shared_attention_batched(
    q: torch.Tensor,                 # (G, Q, H, D) query groups (Q=1 decode)
    layer_store_k: torch.Tensor,     # (E, C, KH, D)
    layer_store_v: torch.Tensor,     # (E, C, KH, D)
    routing: router_lib.Routing,
    *,
    capacity: Optional[int] = None,
    capacity_factor: float = 2.0,
    layer_idx: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # (E, C, KH) f32: int8 store
    v_scale: Optional[torch.Tensor] = None,
    rec: Optional[obs.DeviceRecorder] = None,
    chunk_offset: int = 0,
    num_chunks: Optional[int] = None,
) -> SharedPartial:
    """Batched Shared KV Attention over routed chunks. With ``k_scale``
    and ``v_scale`` the store is int8 and the output is in q's dtype.

    ``num_chunks``: the store is one owner's slice of a store of that
    many chunks, whose first is chunk ``chunk_offset``; the routing names
    global chunks. The dispatch (capacity and slot positions) is the whole
    store's, and only the routes into this slice are attended: the others
    are empty partials, which the owners' combine fills in."""
    G, Q, H, D = q.shape
    E = layer_store_k.shape[0]
    K = routing.chunk_ids.shape[1]
    E_all = E if num_chunks is None else num_chunks
    if capacity is None:
        capacity = router_lib.required_capacity(G, K, E_all, capacity_factor)
    capacity = min(capacity, G * K)

    flat, pos, keep = router_lib.dispatch_plan(routing.chunk_ids, E_all,
                                               capacity)
    if num_chunks is not None:
        keep = keep & (flat >= chunk_offset) & (flat < chunk_offset + E)
        flat = (flat - chunk_offset).clamp(0, E - 1)
    # slot (chunk, pos) -> row chunk * capacity + pos of a flat buffer with
    # one extra trash row: dropped routes land there, which realises the
    # reference's scatter mode="drop" without a host sync
    trash = E * capacity
    lin = torch.where(keep, flat * capacity + pos,
                      torch.full_like(pos, trash))
    q_slots = q.repeat_interleave(K, dim=0)                # (G*K, Q, H, D)
    qd = q.new_zeros((trash + 1, Q, H, D))
    qd[lin] = q_slots
    qmask = torch.zeros(trash + 1, dtype=torch.bool, device=q.device)
    qmask[lin] = keep
    qmask = qmask[:trash].view(E, capacity)
    _record_dispatch(rec, qmask, keep, layer_idx)

    # the kernel takes (E, cap, H, D): fold the per-group query dim into cap
    qd = lsc(qd[:trash].view(E, capacity * Q, H, D), "chunks", None,
             "heads", None)
    kv = (layer_store_k.contiguous(), layer_store_v.contiguous())
    qmask_d = qmask.repeat_interleave(Q, dim=1).contiguous()
    if k_scale is None:
        od, lsed = ops.shared_chunk_attention(qd, *kv, qmask_d)
    else:
        od, lsed = ops.shared_chunk_attention_q8(
            qd, *kv, k_scale.contiguous(), v_scale.contiguous(), qmask_d)
    od = lsc(od, "chunks", None, "heads", None)
    lsed = lsc(lsed, "chunks", None, "heads")

    # LSE-merge over the K selected chunks, reading partial k of group g
    # from row lin[g * K + k] of the kernel's output where it lies; the
    # trash row is an empty partial (the reference's gather mode="fill")
    out, lse = ops.lse_merge_routed(od.reshape(trash, Q, H, D),
                                    lsed.reshape(trash, Q, H),
                                    lin.view(G, K))
    return SharedPartial(out.view(G, Q, H, D), lse.view(G, Q, H))


def shared_attention_gather_ref(
    q: torch.Tensor,                 # (G, Q, H, D)
    layer_store_k: torch.Tensor,     # (E, C, KH, D)
    layer_store_v: torch.Tensor,
    routing: router_lib.Routing,
) -> SharedPartial:
    """Per-request chunk gather + attention. Semantically identical to the
    batched path when no capacity drops occur; memory-bound (each request
    re-reads its chunks) — the baseline MoSKA's GEMM batching beats."""
    G, Q, H, D = q.shape
    E, C, KH, _ = layer_store_k.shape
    K = routing.chunk_ids.shape[1]
    scale = 1.0 / math.sqrt(D)
    ksel = layer_store_k[routing.chunk_ids].reshape(G, K * C, KH, D)
    vsel = layer_store_v[routing.chunk_ids].reshape(G, K * C, KH, D)
    qg = q.reshape(G, Q, KH, H // KH, D)
    s = torch.einsum("gqkhd,gskd->gqkhs", qg.float(), ksel.float()) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("gqkhs,gskd->gqkhd", p.to(vsel.dtype).float(),
                     vsel.float())
    o = o / l.clamp_min(1e-37)[..., None]
    lse = (m + torch.log(l.clamp_min(1e-37))).reshape(G, Q, H)
    return SharedPartial(o.reshape(G, Q, H, D).to(q.dtype), lse)
