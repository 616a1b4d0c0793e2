"""MoE-inspired, training-free chunk router (paper §III.B).

Port of the reference ``core/router.py``. Relevance is the inner product
of the query with each chunk's mean key, scored by the ``router_scores``
kernel; top-k chunks are chosen per query group (one decode token, or a
block of prefill queries), so all queries of a group hit the same chunks
and batch into one GEMM.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


class Routing(NamedTuple):
    chunk_ids: torch.Tensor     # (G, K) int64 — selected chunk per group
    scores: torch.Tensor        # (G, K) fp32 — router scores of the selection
    full_scores: torch.Tensor   # (G, E) fp32 — all scores (diagnostics)


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last dim, lower index first among equal scores
    (``lax.top_k``'s order, which ``torch.topk`` does not promise): a
    stable descending sort keeps equal scores in index order."""
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(q_group: torch.Tensor, emb: torch.Tensor, top_k_chunks: int
          ) -> Routing:
    """q_group: (G, H, D) pooled query per group; emb: (E, KH, D).

    Every q head scores its kv head's chunk embedding; the scores are
    summed over heads into one scalar per (group, chunk).
    """
    s = ops.router_scores(q_group.contiguous(), emb.contiguous())
    scores, ids = top_k(s, min(top_k_chunks, emb.shape[0]))
    return Routing(ids, scores, s)


def route_blocks(q: torch.Tensor, emb: torch.Tensor, top_k_chunks: int,
                 block: int) -> Routing:
    """Prefill routing: mean-pool queries into blocks of ``block``, then
    route. q: (S, H, D) -> groups (S // block, H, D)."""
    S, H, D = q.shape
    nb = S // block
    pooled = q[: nb * block].reshape(nb, block, H, D).mean(dim=1)
    return route(pooled, emb, top_k_chunks)


def dispatch_plan(chunk_ids: torch.Tensor, num_chunks: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Invert routing: each (group, k) slot's position within its
    destination chunk's query batch (MoE-style capacity dispatch).

    Returns (flat_chunk, pos_in_chunk, keep) over the flattened (G*K,)
    slots, in request-major order. Slots at or past ``capacity`` are
    dropped (keep False).
    """
    flat = chunk_ids.reshape(-1)
    onehot = F.one_hot(flat, num_chunks)
    pos = (onehot.cumsum(dim=0) - 1).mul_(onehot).sum(dim=1)
    return flat, pos, pos < capacity


def required_capacity(num_groups: int, top_k_chunks: int, num_chunks: int,
                      capacity_factor: float) -> int:
    """Per-chunk query capacity: >= ceil(G*K/E) * cf, aligned to 8."""
    mean = num_groups * top_k_chunks / max(num_chunks, 1)
    cap = int(math.ceil(mean * capacity_factor))
    cap = max(cap, min(num_groups, 8))
    return int(math.ceil(cap / 8) * 8)
