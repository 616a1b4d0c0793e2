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
from repro_torch.kernels import ops
from repro_torch.sharding import tensor_parallel as tp

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
    out, lse = lse_combine(part.out[:, 0].float(), part.lse[:, 0], mesh,
                           axes)
    return out.to(q.dtype), lse


def lse_combine(o_l: torch.Tensor, lse_l: torch.Tensor, mesh,
                axes: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The disaggregated combine: the exact LSE merge of every rank's
    partial (o_l (N, H, D) fp32, lse_l (N, H); -1e30 where it attended
    nothing) over the mesh axes ``axes``: all-reduce MAX of the LSE, then
    one all-reduce SUM of o * w and w, w = exp(lse - max). Returns the
    merged (out fp32, lse), the same on every rank of those axes."""
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
    return out, lse


# ---------------------------------------------------------------------------
# the tensor-parallel decode step: the unique cache split by position over
# ``model``, the store split by chunk and by chunk position
# ---------------------------------------------------------------------------

def _gather_cat(t: torch.Tensor, mesh, axes: Sequence[str], dim: int
                ) -> torch.Tensor:
    """Every rank's ``t`` of the mesh axes ``axes`` (major first), laid
    end to end along ``dim`` in the order that a split over those axes
    has."""
    for ax in reversed(axes):
        g = mesh.get_group(ax)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, t.contiguous(), group=g)
        t = torch.cat(parts, dim=dim)
    return t


def _first_on(mesh, axes: Sequence[str]) -> bool:
    """Whether this rank is at coordinate 0 of every mesh axis in
    ``axes``: the one rank of each such line that contributes a partial
    which its peers there compute alike."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    return all(coord[names.index(ax)] == 0 for ax in axes)


@torch.no_grad()
def meshed_decode_attention(q, k_new, v_new, kc, vc, lengths, shared,
                            cfg: MoSKAConfig, *, window: int = 0):
    """``moska_decode_attention`` (with the new token's K/V appended to the
    cache first) on ``DTensor`` values: q (B, H, D), k_new/v_new (B, KH,
    D), caches kc/vc (B, S, KH, D) split by row and by position or by kv
    head, lengths (B,), and ``shared`` (a layer's store: k/v (E, C, KH, D)
    split by chunk and by chunk position or by kv head, emb (E, KH, D) by
    chunk and by kv head) or None. Without ``k_new`` nothing is appended
    and the cache's first ``lengths`` positions are attended (every
    position without ``lengths``: an encoder's cross cache); without
    ``kc`` the store's partial is the whole output (the enc-dec
    cross-attention over a shared audio).

    Each rank appends the token where its positions hold it and takes the
    unique partial of its rows over its positions (the ``decode_attention``
    kernel). With a store it gathers every row's query, scores its own
    chunks (a ``model`` share of them where they divide), gathers the
    scores and routes every query over the whole store (each rank the
    same top-k, as one device routes), and attends the routes into its
    slice (the ``shared_chunk_attention`` kernel, its merge over a query's
    chunks the ``lse_merge`` kernel). Its unique partial joins its rows of
    the shared one (the ``lse_merge`` pair entry), and ``lse_combine``
    over every mesh axis makes the partials one: each rank contributes
    once what its peers compute alike. Where the cache or the store is
    split by kv head, each rank keeps its query heads (the kv heads' split
    must put whole GQA groups on a rank) and does all of this for them
    alone, its router scores summed over the heads' axes. Returns o (B,
    H, D) at q's row placement, whole over the heads or split as the kv
    heads."""
    from repro_torch.core.router import Routing, top_k
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    row_axes = tp.split_axes(q, 0)
    pos_axes = () if kc is None else tp.split_axes(kc, 1)
    head_axes = tp.split_axes(kc if kc is not None else shared.k, 2)
    if shared is not None and kc is not None and \
            tp.split_axes(shared.k, 2) != head_axes:
        raise NotImplementedError("a cache and a store split by kv head "
                                  "over other axes")
    if head_axes and tp.split_axes(q, 1) != head_axes:
        raise ValueError(f"query heads over {tp.split_axes(q, 1)}, kv heads "
                         f"over {head_axes}")
    q = tp.keep_shards(q, row_axes + head_axes)
    new = [t if t is None else tp.keep_shards(t, row_axes + head_axes)
           for t in (k_new, v_new)]
    row0, nrows = tp.local_range(q, 0)
    qh0, nqh = tp.local_range(q, 1)
    args = [q, *new, kc, vc, lengths]
    if kc is not None:
        pos0, npos = tp.local_range(kc, 1)
        S = kc.shape[1]
        kh0, nkh = tp.local_range(kc, 2)
        if tp.split_axes(kc, 2) and (qh0, nqh) != (
                kh0 * (q.shape[1] // kc.shape[2]),
                nkh * (q.shape[1] // kc.shape[2])):
            raise ValueError(f"query heads {qh0}+{nqh} over kv heads "
                             f"{kh0}+{nkh}: a rank needs whole groups")
    if shared is not None:
        chunk_axes = tp.split_axes(shared.k, 0)
        cpos_axes = tp.split_axes(shared.k, 1)
        c0, _ = tp.local_range(shared.k, 0)
        E = shared.k.shape[0]
        # every kv head on every rank (the embeddings' heads may be
        # split), unless the store splits them
        keep = chunk_axes + cpos_axes + head_axes
        args += [None if t is None else tp.keep_shards(t, keep)
                 for t in (shared.k, shared.v)]
        args.append(tp.keep_shards(shared.emb, chunk_axes + head_axes))
        args += [None if t is None else tp.keep_shards(t, keep)
                 for t in (shared.k_scale, shared.v_scale)]
    if window and pos_axes:
        raise NotImplementedError("a sliding window over a cache split by "
                                  "position")
    rest = set(names) - set(head_axes)

    def body(ql, kn, vn, kcl, vcl, lens, sk=None, sv=None, emb=None,
             ks=None, vs=None):
        B = ql.shape[0]
        if kcl is not None:
            n = (torch.full((B,), S, dtype=torch.int32, device=ql.device)
                 if lens is None else lens + (kn is not None))
            if kn is not None:
                rows = torch.arange(B, device=ql.device)
                at = lens.long().clamp(0, S - 1) - pos0  # the reference's
                mine = ((at >= 0) & (at < npos))[:, None, None]   # clamp
                at = at.clamp(0, npos - 1)
                for cl, new_t in ((kcl, kn), (vcl, vn)):
                    cl[rows, at] = torch.where(mine, new_t.to(cl.dtype),
                                               cl[rows, at])
            n_local = (n - pos0).clamp(0, npos).to(torch.int32)
            o_u, lse_u = ops.decode_attention(ql, kcl, vcl, n_local,
                                              window=window)
            if sk is None:
                out, _ = lse_combine(o_u.float(), lse_u, mesh, pos_axes)
                return out.to(ql.dtype)
        q_all = _gather_cat(ql, mesh, row_axes, 0)
        # score this rank's chunks (its model share of them), gather
        mshare = ("model",) if "model" in rest and "model" not in \
            chunk_axes and emb.shape[0] % mesh["model"].size() == 0 else ()
        emb_m = emb
        for ax in mshare:
            emb_m = local_shard(emb, mesh, ax)
        s = ops.router_scores(q_all.contiguous(), emb_m.contiguous())
        for ax in head_axes:             # the heads' partial scores
            dist.all_reduce(s, group=mesh.get_group(ax))
        s = _gather_cat(_gather_cat(s, mesh, mshare, 1), mesh, chunk_axes, 1)
        scores, ids = top_k(s, min(cfg.top_k_chunks, E))
        part = sa.shared_attention_batched(
            q_all[:, None], sk, sv, Routing(ids, scores, s),
            capacity_factor=cfg.query_capacity_factor, k_scale=ks,
            v_scale=vs, chunk_offset=c0, num_chunks=E)
        o_c, lse_c = part.out[:, 0], part.lse[:, 0]
        if not _first_on(mesh, rest - set(chunk_axes) - set(cpos_axes)):
            o_c = torch.zeros_like(o_c)
            lse_c = torch.full_like(lse_c, NEG_INF)
        if kcl is not None and _first_on(mesh, rest - set(row_axes)
                                         - set(pos_axes)):
            sl = slice(row0, row0 + nrows)
            o_r, lse_r = ops.lse_merge_pair(
                o_u.contiguous(), lse_u.float().contiguous(),
                o_c[sl].contiguous(), lse_c[sl].float().contiguous())
            o_c = torch.cat([o_c[:row0], o_r, o_c[row0 + nrows:]])
            lse_c = torch.cat([lse_c[:row0], lse_r, lse_c[row0 + nrows:]])
        out, _ = lse_combine(o_c.float(), lse_c, mesh, sorted(
            rest, key=names.index))
        return out[row0:row0 + nrows].to(ql.dtype)

    return tp.local_call(body, args, q.placements, mesh)
