"""MoSKA mixture attention: unique-KV partial ⊕ routed shared-KV partial.

Port of the reference ``core/moska_attention.py``. The unique path is the
memory-bound GEMV over the request's own cache (the ``decode_attention``
kernel over a slotted cache, the ``paged_decode_attention`` kernel over a
page pool, blocked flash attention at prefill); the shared path is the
routed, batched GEMM (``shared_attention_batched``); the two partials are
merged exactly through their LSEs (the ``lse_merge`` kernel).
``moska_decode_merge`` is the shared half of a decode step, so each cache
layout computes its own unique partial and hands it over. A sliding-window
layer never routes: ``shared_tail_merge`` merges its unique partial with
one call over the document's tail, which every row shares.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import MoSKAConfig
from repro_torch.core import router as router_lib
from repro_torch.core import shared_attention as sa
from repro_torch.kernels import ops
from repro_torch.models import layers as L


class MoskaLayerContext(NamedTuple):
    """Per-layer shared store slices + routing, computed once per step.
    An int8 store keeps its int8 K/V here with their scales; the shared
    attention dequantizes them in the ``shared_chunk_attention_q8``
    kernel."""
    k: torch.Tensor                       # (E, C, KH, D), or int8
    v: torch.Tensor                       # (E, C, KH, D)
    routing: router_lib.Routing
    k_scale: Optional[torch.Tensor] = None   # (E, C, KH) f32 when int8
    v_scale: Optional[torch.Tensor] = None


def _shared_partial(q: torch.Tensor, ctx: MoskaLayerContext,
                    cfg: MoSKAConfig, phase: str,
                    rec: Optional[obs.DeviceRecorder]) -> sa.SharedPartial:
    """q: (G, Q, H, D) query groups against the context's store; counts
    the call under ``moska/{phase}/calls``."""
    if rec is not None:
        rec.inc(f"moska/{phase}/calls", 1)
    return sa.shared_attention_batched(
        q, ctx.k, ctx.v, ctx.routing,
        capacity_factor=cfg.query_capacity_factor,
        k_scale=ctx.k_scale, v_scale=ctx.v_scale, rec=rec)


def moska_decode_merge(
    q: torch.Tensor,                      # (B, H, D) one token per request
    o_u: torch.Tensor,                    # (B, H, D) unique partial
    lse_u: torch.Tensor,                  # (B, H) fp32
    ctx: Optional[MoskaLayerContext],
    cfg: MoSKAConfig,
    *,
    rec: Optional[obs.DeviceRecorder] = None,
) -> torch.Tensor:
    """The routed shared partial of a decode step, merged with the unique
    partial ``(o_u, lse_u)`` however the caller's cache layout computed
    it. Returns (B, H, D); the unique partial alone without a store."""
    if ctx is None or not cfg.enabled:
        return o_u
    part = _shared_partial(q[:, None], ctx, cfg, "decode", rec)
    with obs.profiled_span("layer.merge"):
        out, _ = L.merge_partial_attention([o_u, part.out[:, 0]],
                                           [lse_u, part.lse[:, 0]])
    return out


#: the profiler range around a sliding-window layer's tail call and merge
TAIL_RANGE = "layer.shared_tail"


def record_tail(rec: Optional[obs.DeviceRecorder], first: torch.Tensor,
                tail: int, calls: int) -> None:
    """The counts of ``calls`` tail calls of one model call, which share
    their rows, their first keys and a tail of ``tail`` keys (every sliding
    layer of the model), queued once as device tensors (no sync): rows
    with at least one visible tail key (``moska/tail_rows``) and visible
    (row, key) pairs (``moska/tail_keys``); on the host the calls, their
    rows and the tail keys they read (``moska/tail_calls``,
    ``moska/tail_query_rows``, ``moska/tail_kv_rows``). Each counter sums
    over the calls."""
    if rec is None or not calls:
        return
    seen = (tail - first.long()).clamp(0, tail)
    rec.inc("moska/tail_rows", (seen > 0).sum() * calls)
    rec.inc("moska/tail_keys", seen.sum() * calls)
    rec.inc("moska/tail_calls", calls)
    rec.inc("moska/tail_query_rows", first.numel() * calls)
    rec.inc("moska/tail_kv_rows", tail * calls)


def shared_tail_merge(
    q: torch.Tensor,                      # (N, H, D) every row's query
    o_u: torch.Tensor,                    # (N, H, D) unique partial
    lse_u: torch.Tensor,                  # (N, H) fp32
    k_tail: torch.Tensor,                 # (T, KH, D) the shared tail
    v_tail: torch.Tensor,
    first: torch.Tensor,                  # (N,) int32
) -> torch.Tensor:
    """A sliding-window layer's attention over a shared document: its
    window reaches back only into the document's last keys, the tail
    (``SharedTail``), which every row shares. Row n (at unique offset t
    after the document, window W, tail of W - 1 keys) sees tail keys t ..
    W - 2: ``first[n] = t``, none once t >= W - 1. One
    ``shared_tail_attention`` call over every row, merged with the
    windowed unique partial ``(o_u, lse_u)``. Returns (N, H, D). The model
    call counts its layers' calls once (``record_tail``)."""
    with obs.profiled_span(TAIL_RANGE):
        o_t, lse_t = ops.shared_tail_attention(
            q.contiguous(), k_tail.contiguous(), v_tail.contiguous(),
            first.to(torch.int32).contiguous())
        out, _ = L.merge_partial_attention([o_u, o_t], [lse_u, lse_t])
    return out


def moska_decode_attention(
    q: torch.Tensor,                      # (B, H, D) one token per request
    k_cache: torch.Tensor,                # (B, S, KH, D) unique cache
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,                 # (B,) int32
    ctx: Optional[MoskaLayerContext],
    cfg: MoSKAConfig,
    *,
    window: int = 0,
    rec: Optional[obs.DeviceRecorder] = None,
) -> torch.Tensor:
    """Returns the merged attention output (B, H, D)."""
    with obs.profiled_span("layer.unique_attention"):
        o_u, lse_u = L.decode_attention(q, k_cache, v_cache, kv_len,
                                        window=window, return_lse=True)
    return moska_decode_merge(q, o_u, lse_u, ctx, cfg, rec=rec)


def moska_prefill_attention(
    q: torch.Tensor,                      # (B, S, H, D)
    k: torch.Tensor,                      # (B, S, KH, D) fresh unique keys
    v: torch.Tensor,
    ctx: Optional[MoskaLayerContext],
    cfg: MoSKAConfig,
    *,
    q_offset: int = 0,
    window: int = 0,
    route_block: int = 128,
    rec: Optional[obs.DeviceRecorder] = None,
) -> torch.Tensor:
    """Prefill: causal attention over the unique prefix, plus routed shared
    attention for every query block when a shared corpus is attached."""
    with obs.profiled_span("layer.unique_attention"):
        o_u, lse_u = L.flash_attention(q, k, v, causal=True,
                                       q_offset=q_offset, kv_offset=q_offset,
                                       window=window, return_lse=True)
    if ctx is None or not cfg.enabled:
        return o_u
    B, S, H, D = q.shape
    nb = S // route_block
    part = _shared_partial(q.reshape(B * nb, route_block, H, D), ctx, cfg,
                           "prefill", rec)
    with obs.profiled_span("layer.merge"):
        out, _ = L.merge_partial_attention(
            [o_u, part.out.reshape(B, S, H, D)],
            [lse_u, part.lse.reshape(B, S, H)])
    return out
