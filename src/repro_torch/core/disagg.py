"""Disaggregated execution of MoSKA attention (paper §III.C, Fig. 3) over
``torch.distributed``.

Port of the reference ``core/disagg.py``. The paper's Shared-KV node pool
is the chunk store split chunk-major over a mesh axis: each rank owns a
range of chunks (``local_chunks``) and serves every request's queries on
them. Per rank:

  route each query against the LOCAL chunks (top-k among them)
  routed batched attention on the local chunks (the hand-written kernels)
  exact LSE merge across owners: all-reduce MAX of the LSE, then
  all-reduce SUM of o * w and w, w = exp(lse - max)

The reference runs this body under ``shard_map`` with ``pmax``/``psum``;
here each rank runs it and the combine is two collectives on the mesh's
process groups. Per-owner top-k is the reference's own documented
deviation: a query's chunks are its best k of each owner, not its best k
overall.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs.base import MoSKAConfig
from repro_torch.core import router as router_lib
from repro_torch.core import shared_attention as sa

NEG_INF = -1e30
Axes = Union[str, Sequence[str]]


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def local_shard(x: torch.Tensor, mesh, axis: Optional[Axes], dim: int = 0
                ) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` when that dim is split over
    the mesh axis (or axes, major first) ``axis``, as a ``P(axis)`` spec
    splits it: a view; all of ``x`` when ``axis`` is None."""
    if axis is None:
        return x
    idx, n = 0, 1
    for ax in _axes(axis):
        size = mesh.size(mesh.mesh_dim_names.index(ax))
        idx = idx * size + mesh.get_local_rank(ax)
        n *= size
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {axis} ({n} ranks)")
    step = x.shape[dim] // n
    return x.narrow(dim, idx * step, step)


def local_chunks(store_k: torch.Tensor, store_v: torch.Tensor,
                 emb: torch.Tensor, mesh, chunk_axis: Axes = "data"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's chunk range of a whole layer store (E, C, KH, D) and its
    embeddings (E, KH, D)."""
    return tuple(local_shard(t, mesh, chunk_axis)
                 for t in (store_k, store_v, emb))


def disaggregated_shared_attention(
    q: torch.Tensor,              # (B, H, D), or this rank's batch rows
    store_k: torch.Tensor,        # (E_local, C, KH, D): this rank's chunks
    store_v: torch.Tensor,
    emb: torch.Tensor,            # (E_local, KH, D)
    cfg: MoSKAConfig,
    mesh,
    *,
    chunk_axis: Axes = "data",
    batch_axis: Optional[Axes] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merged shared partial (out (B, H, D) in q's dtype, lse (B, H)
    fp32; -1e30 where no owner attended) of ``q`` over every owner's
    chunks. Every rank of the chunk axis calls it with the same queries
    (with ``batch_axis``: the same rows of its batch shard) and its own
    chunks; each gets the merged result of its rows."""
    axes = _axes(chunk_axis)
    if batch_axis is not None and set(_axes(batch_axis)) & set(axes):
        # owners along a chunk axis must merge partials of the same rows
        raise ValueError(f"batch axis {batch_axis} is a chunk axis")
    topk = min(cfg.top_k_chunks, store_k.shape[0])
    routing = router_lib.route(q, emb, topk)
    part = sa.shared_attention_batched(
        q[:, None], store_k, store_v, routing,
        capacity_factor=cfg.query_capacity_factor)
    o_l = part.out[:, 0].float()                 # (B, H, D)
    lse_l = part.lse[:, 0]                       # (B, H)
    # --- the disaggregated combine: exact LSE merge across owners ---
    groups = [mesh.get_group(ax) for ax in axes]
    m = lse_l.clone()
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    w = torch.where(lse_l > NEG_INF / 2, torch.exp(lse_l - m),
                    torch.zeros_like(lse_l))
    # the numerator and the denominator travel in one buffer
    B, H, D = o_l.shape
    buf = torch.cat([(o_l * w[..., None]).reshape(-1), w.reshape(-1)])
    for g in groups:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g)
    num, den = buf[:B * H * D].view(B, H, D), buf[B * H * D:].view(B, H)
    den_c = den.clamp_min(1e-37)
    out = num / den_c[..., None]
    lse = torch.where(den > 0, m + torch.log(den_c),
                      torch.full_like(m, NEG_INF))
    return out.to(q.dtype), lse
