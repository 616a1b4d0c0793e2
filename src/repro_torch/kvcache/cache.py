"""Unique (per-request) KV cache — the paper's 'Unique KV' pool.

Port of the reference ``kvcache/cache.py``. Layer-stacked layout: k/v
(L, B, S, KH, D), lengths (B,) int32. Every write happens in place on the
cache's tensors (the counterpart of the reference's buffer donation), so a
decode step or an admission never copies the other slots.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.sharding.tensor_parallel import fake_tensors


class KVCache(NamedTuple):
    k: torch.Tensor          # (L, B, S, KH, D)
    v: torch.Tensor          # (L, B, S, KH, D)
    length: torch.Tensor     # (B,) int32 — valid tokens in this buffer
    offset: torch.Tensor     # (B,) int32 — absolute position of slot 0
                             # (= shared-corpus length when a store precedes it)

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @property
    def positions(self) -> torch.Tensor:
        """Absolute position of the next token per request."""
        return self.offset + self.length

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def init_kv_cache(num_layers: int, batch: int, max_seq: int, kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    shape = (num_layers, batch, max_seq, kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def abstract_kv_cache(num_layers: int, batch: int, max_seq: int,
                      kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                      device=None) -> KVCache:
    """``init_kv_cache``'s shapes as fake tensors (no allocation; the dry
    run's stand-in)."""
    with fake_tensors():
        return init_kv_cache(num_layers, batch, max_seq, kv_heads, head_dim,
                             dtype, device)


def write_slot_prefix(cache: KVCache, slot_cache: KVCache, slot: int,
                      true_len: Optional[int] = None) -> KVCache:
    """Write a prefilled 1-batch cache into batch slot ``slot``, in place.

    ``slot_cache`` holds a (L, 1, S_new, KH, D) prefix with S_new <=
    cache.max_seq (S_new may be a padded prefill bucket). ``true_len``,
    when given, is the real prompt length: positions >= true_len are
    zeroed and the slot length is set to it, so a reused slot never leaks
    stale or pad KV. The slot tail beyond S_new is always zeroed.
    """
    S, S_new = cache.max_seq, slot_cache.max_seq
    if S_new > S:
        raise ValueError(f"slot prefix length {S_new} > cache max_seq {S}")
    keep = S_new if true_len is None else min(int(true_len), S_new)
    for dst, src in ((cache.k, slot_cache.k), (cache.v, slot_cache.v)):
        dst[:, slot, :keep] = src[:, 0, :keep]
        dst[:, slot, keep:] = 0
    if true_len is None:
        cache.length[slot] = slot_cache.length[0]
    else:
        cache.length[slot] = int(true_len)
    cache.offset[slot] = slot_cache.offset[0]
    return cache


def read_slot(cache: KVCache, slot: int) -> KVCache:
    """1-batch view of slot ``slot`` (tests / debugging)."""
    return KVCache(cache.k[:, slot:slot + 1], cache.v[:, slot:slot + 1],
                   cache.length[slot:slot + 1], cache.offset[slot:slot + 1])


def write_prefix(k_layer: torch.Tensor, v_layer: torch.Tensor,
                 new_k: torch.Tensor, new_v: torch.Tensor):
    """Write a full prefix (B, S_new, KH, D) at position 0, in place."""
    S_new = new_k.shape[1]
    k_layer[:, :S_new] = new_k
    v_layer[:, :S_new] = new_v
    return k_layer, v_layer


def append_token(k_layer: torch.Tensor, v_layer: torch.Tensor,
                 new_k: torch.Tensor, new_v: torch.Tensor,
                 lengths: torch.Tensor):
    """Append one token per request at its current length, in place.

    k_layer: (B, S, KH, D); new_k: (B, KH, D); lengths: (B,). A length at
    or past S writes at S - 1, as the reference's clamped
    ``dynamic_update_slice`` does (idle slots keep advancing).
    """
    B, S = k_layer.shape[:2]
    rows = torch.arange(B, device=k_layer.device)
    idx = lengths.long().clamp(0, S - 1)
    k_layer[rows, idx] = new_k.to(k_layer.dtype)
    v_layer[rows, idx] = new_v.to(v_layer.dtype)
    return k_layer, v_layer
