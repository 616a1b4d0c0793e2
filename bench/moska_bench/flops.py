"""Model FLOPs that every architecture's layout (``bench/archs/<arch>/
layout.py``) counts alike, two per multiply-add: attention's QK and PV
products, the keys of the chunks a MoSKA query routes to, and the logits of
one position."""
from __future__ import annotations


def attention(m: dict, queries: float, keys: float) -> float:
    """QK and PV of ``queries`` query positions over ``keys`` keys (summed
    over the query positions where they differ) at every query head."""
    return 4.0 * m["num_heads"] * m["head_dim"] * queries * keys


def shared_keys(m: dict, chunks: int) -> int:
    """The keys of the chunks a query routes to in a store of ``chunks``
    chunks (none without a store)."""
    if not chunks:
        return 0
    ms = m["moska"]
    return min(ms["top_k_chunks"], chunks) * ms["chunk_size"]


def logits(m: dict) -> float:
    """The unembedding of one position."""
    return 2.0 * m["d_model"] * m["vocab_size"]
