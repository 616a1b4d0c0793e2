"""The work of one call of each hand-written kernel: the operations of its
products and the bytes it must move (each input read once, each output
written once), from its arguments' shapes.

Operations are the products' multiply-adds, two to each, as the
reference's counter counts dots and ``torch.utils.flop_counter`` counts
the plain versions' matmuls: the shared, decode and prefill kernels' QK
and PV (the prefill's over its valid pairs alone), the router's dot of
each kv head's folded queries with the chunk embeddings. The merges
multiply no matrices: their operations are 0, and their bytes bound
them.

``chip_smoke.py`` reads it for each kernel's bound (phase 5), and the dry
run's counter (``launch/op_cost.py``) for every kernel call it traces, so
the two count the same work whatever implements the kernel. Where the
work depends on the data (the dispatched queries of the shared kernels,
the visible tail keys of the tail kernel, the cached tokens of the decode
kernels), the caller that has the data
passes its counts; without them (a dry run's fake tensors have no values)
the count is bounded by capacity: every dispatch slot valid, every chunk
with a query, every request's cache full.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _nb(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def shared_chunk_attention(qd, k, v, qmask, k_scale=None, v_scale=None, *,
                           valid: Optional[int] = None,
                           active: Optional[int] = None
                           ) -> Tuple[float, float]:
    """(operations, bytes) of ``shared_chunk_attention`` (and of its int8
    entry, with the scales). ``valid``: dispatched (chunk, slot) pairs;
    ``active``: chunks with a query."""
    E, cap, H, D = qd.shape
    C, KH = k.shape[1], k.shape[2]
    valid = E * cap if valid is None else valid
    active = E if active is None else active
    # K/V (and an int8 store's f32 scales) of the chunks with a query
    per_token = 2 * KH * (D * k.element_size() + 4 * (k_scale is not None))
    byts = (valid * H * D * qd.element_size() + active * C * per_token
            + _nb(qmask) + _nb(qd) + E * cap * H * 4)
    return 4.0 * valid * H * C * D, float(byts)


def shared_chunk_attention_q8(qd, k, v, k_scale, v_scale, qmask, **counts):
    return shared_chunk_attention(qd, k, v, qmask, k_scale, v_scale,
                                  **counts)


def shared_tail_attention(q, k, v, first, *, keys: Optional[int] = None
                          ) -> Tuple[float, float]:
    """``keys``: the visible (row, key) pairs, summed over the rows
    (capacity: every row sees the whole tail). The tail's K and V are read
    once; each row's q, out, lse and first are moved once."""
    N, H, D = q.shape
    T, KH = k.shape[0], k.shape[1]
    keys = N * T if keys is None else keys
    byts = (2 * T * KH * D * k.element_size() + 2 * _nb(q) + N * H * 4
            + _nb(first))
    return 4.0 * keys * H * D, float(byts)


def decode_attention(q, k, v, kv_len, window: int = 0, *,
                     tokens: Optional[int] = None) -> Tuple[float, float]:
    """``tokens``: the cached tokens attended, summed over the requests
    (capacity: every request's S)."""
    B, H, D = q.shape
    KH = k.shape[-2]
    tokens = B * k.shape[1] if tokens is None else tokens
    byts = (2 * _nb(q) + 2 * tokens * KH * D * k.element_size()
            + _nb(kv_len) + B * H * 4)
    return 4.0 * tokens * H * D, float(byts)


def paged_decode_attention(q, k_pool, v_pool, table, kv_len, window: int = 0,
                           *, tokens: Optional[int] = None
                           ) -> Tuple[float, float]:
    """``tokens`` as for ``decode_attention`` (capacity: every request's
    table of pages full)."""
    B, H, D = q.shape
    KH = k_pool.shape[-2]
    cap = table.shape[1] * k_pool.shape[1]
    tokens = B * cap if tokens is None else tokens
    byts = (2 * _nb(q) + 2 * tokens * KH * D * k_pool.element_size()
            + _nb(kv_len) + B * H * 4 + _nb(table))
    return 4.0 * tokens * H * D, float(byts)


def lse_merge(outs, lses) -> Tuple[float, float]:
    byts = _nb(outs) + _nb(lses) + _nb(outs[0]) + _nb(lses[0])
    return 0.0, float(byts)


def lse_merge_pair(o0, l0, o1, l1) -> Tuple[float, float]:
    return 0.0, float(3 * _nb(o0) + 3 * _nb(l0))


def lse_merge_routed(od, lsed, lin) -> Tuple[float, float]:
    """Each of the G groups reads its K partials' rows of Q queries."""
    R, Q, H, D = od.shape
    G, K = lin.shape
    row = Q * H * (D * od.element_size() + 4)
    return 0.0, float(G * K * row + _nb(lin) + G * row)


def router_scores(q, emb) -> Tuple[float, float]:
    """The queries of each kv head are summed before the dot."""
    G, H, D = q.shape
    E, KH = emb.shape[:2]
    return 2.0 * G * E * KH * D, float(_nb(q) + _nb(emb) + G * E * 4)


def flash_prefill_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                            kv_offset: int = 0, kv_len=None,
                            window: int = 0) -> Tuple[float, float]:
    """The valid (query, key) pairs' QK and PV, for every head; bytes: q,
    the keys and values some row attends, the output and the lse. A row
    with no valid key does no work (the kernel's average over its masked
    keys is not counted). Counted from the shapes and offsets alone, in
    numpy, so a dry run's fake tensors give it too."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.full(Sq, min(Sk, Sk if kv_len is None else kv_len), np.int64)
    if causal:
        hi = np.minimum(hi, pos - kv_offset + 1)
    lo = (np.maximum(0, pos - window + 1 - kv_offset) if window
          else np.zeros(Sq, np.int64))
    valid = hi > lo
    pairs = int((hi - lo)[valid].sum())
    keys = int(hi[valid].max() - lo[valid].min()) if valid.any() else 0
    byts = (2 * _nb(q) + 2 * B * keys * KH * D * k.element_size()
            + B * Sq * H * 4)
    return 4.0 * B * pairs * H * D, float(byts)


#: every kernel entry of ``kernels/ops.py`` by name
WORK: Dict[str, Callable[..., Tuple[float, float]]] = {
    f.__name__: f for f in (shared_chunk_attention, shared_chunk_attention_q8,
                            shared_tail_attention, decode_attention, paged_decode_attention,
                            lse_merge, lse_merge_pair, lse_merge_routed,
                            router_scores, flash_prefill_attention)}

#: the counters that take each traced kernel call (``launch/op_cost.py``)
_listeners: List[Callable[[str, float, float], None]] = []


def report(name: str, *args, **kwargs) -> None:
    """Hand the work of one call of kernel entry ``name`` to every
    listening counter."""
    if _listeners:
        flops, byts = WORK[name](*args, **kwargs)
        for fn in _listeners:
            fn(name, flops, byts)
