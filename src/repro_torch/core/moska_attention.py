"""MoSKA mixture attention: unique-KV partial ⊕ routed shared-KV partial.

Port of the reference ``core/moska_attention.py``. The unique path is the
memory-bound GEMV over the request's own cache (the ``decode_attention``
kernel over a slotted cache, the ``paged_decode_attention`` kernel over a
page pool, blocked flash attention at prefill); the shared path is the
routed, batched GEMM (``shared_attention_batched``); the two partials are
merged exactly through their LSEs (the ``lse_merge`` kernel).
``moska_decode_merge`` is the shared half of a decode step, so each cache
layout computes its own unique partial and hands it over.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import MoSKAConfig
from repro_torch.core import router as router_lib
from repro_torch.core import shared_attention as sa
from repro_torch.models import layers as L


def _record_merge(rec: Optional[obs.DeviceRecorder], lse_u: torch.Tensor,
                  lse_s: torch.Tensor, phase: str) -> None:
    """Mixture diagnostics, queued as device tensors: how often the routed
    shared path outweighs the request's unique cache, per head."""
    if rec is None:
        return
    rec.inc(f"moska/{phase}/calls", torch.ones((), device=lse_u.device))
    rec.observe(f"moska/{phase}/shared_win_frac",
                (lse_s > lse_u).float().mean(), obs.FRACTION_EDGES)


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
                    cfg: MoSKAConfig, layer_idx: Optional[int],
                    rec: Optional[obs.DeviceRecorder]) -> sa.SharedPartial:
    """q: (G, Q, H, D) query groups against the context's store."""
    return sa.shared_attention_batched(
        q, ctx.k, ctx.v, ctx.routing,
        capacity_factor=cfg.query_capacity_factor, layer_idx=layer_idx,
        k_scale=ctx.k_scale, v_scale=ctx.v_scale, rec=rec)


def moska_decode_merge(
    q: torch.Tensor,                      # (B, H, D) one token per request
    o_u: torch.Tensor,                    # (B, H, D) unique partial
    lse_u: torch.Tensor,                  # (B, H) fp32
    ctx: Optional[MoskaLayerContext],
    cfg: MoSKAConfig,
    *,
    layer_idx: Optional[int] = None,
    rec: Optional[obs.DeviceRecorder] = None,
) -> torch.Tensor:
    """The routed shared partial of a decode step, merged with the unique
    partial ``(o_u, lse_u)`` however the caller's cache layout computed
    it. Returns (B, H, D); the unique partial alone without a store."""
    if ctx is None or not cfg.enabled:
        return o_u
    part = _shared_partial(q[:, None], ctx, cfg, layer_idx, rec)
    o_s, lse_s = part.out[:, 0], part.lse[:, 0]
    _record_merge(rec, lse_u, lse_s, "decode")
    out, _ = L.merge_partial_attention([o_u, o_s], [lse_u, lse_s])
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
    layer_idx: Optional[int] = None,
    rec: Optional[obs.DeviceRecorder] = None,
) -> torch.Tensor:
    """Returns the merged attention output (B, H, D)."""
    o_u, lse_u = L.decode_attention(q, k_cache, v_cache, kv_len,
                                    window=window, return_lse=True)
    return moska_decode_merge(q, o_u, lse_u, ctx, cfg, layer_idx=layer_idx,
                              rec=rec)


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
    layer_idx: Optional[int] = None,
    rec: Optional[obs.DeviceRecorder] = None,
) -> torch.Tensor:
    """Prefill: causal attention over the unique prefix, plus routed shared
    attention for every query block when a shared corpus is attached."""
    o_u, lse_u = L.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                   kv_offset=q_offset, window=window,
                                   return_lse=True)
    if ctx is None or not cfg.enabled:
        return o_u
    B, S, H, D = q.shape
    nb = S // route_block
    part = _shared_partial(q.reshape(B * nb, route_block, H, D), ctx, cfg,
                           layer_idx, rec)
    o_s = part.out.reshape(B, S, H, D)
    lse_s = part.lse.reshape(B, S, H)
    _record_merge(rec, lse_u, lse_s, "prefill")
    out, _ = L.merge_partial_attention([o_u, o_s], [lse_u, lse_s])
    return out
