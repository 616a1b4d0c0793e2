"""Model FLOPs of the work a window served, counted from the configuration
and each step's shapes (never from the program): two per multiply-add.

A token through a layer costs its projections (q, k, v, o), its FFN
(SwiGLU, or the router and the ``top_k`` experts it is sent to) and its
attention: QK and PV over its own earlier tokens and, with a store, over
every key of the ``top_k_chunks`` chunks it routes to. A prefill computes
the logits of its last position only; a decode step those of its token.
"""
from __future__ import annotations


def _per_layer(m: dict) -> float:
    d, f = m["d_model"], m["d_ff"]
    hq = m["num_heads"] * m["head_dim"]
    hkv = m["num_kv_heads"] * m["head_dim"]
    proj = d * hq + 2 * d * hkv + hq * d
    moe = m.get("moe")
    if moe:
        ffn = d * moe["num_experts"] + moe["top_k"] * 3 * d * f
    else:
        ffn = 3 * d * f
    return 2.0 * (proj + ffn)


def _attn(m: dict, queries: float, keys: float) -> float:
    return 4.0 * m["num_heads"] * m["head_dim"] * queries * keys


def _shared_keys(m: dict, chunks: int) -> int:
    if not chunks:
        return 0
    ms = m["moska"]
    return min(ms["top_k_chunks"], chunks) * ms["chunk_size"]


def prefill(m: dict, prompt: int, chunks: int) -> float:
    """A prompt of ``prompt`` tokens (its real length, not its bucket)."""
    L = m["num_layers"]
    causal = prompt * (prompt + 1) / 2
    per = (prompt * _per_layer(m) + _attn(m, 1, causal)
           + _attn(m, prompt, _shared_keys(m, chunks)))
    return L * per + 2.0 * m["d_model"] * m["vocab_size"]


def decode(m: dict, context: int, chunks: int) -> float:
    """One token that attends ``context`` unique rows (its own included)."""
    L = m["num_layers"]
    per = _per_layer(m) + _attn(m, 1, context + _shared_keys(m, chunks))
    return L * per + 2.0 * m["d_model"] * m["vocab_size"]
