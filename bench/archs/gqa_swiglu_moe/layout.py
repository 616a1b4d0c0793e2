"""The block's layout: its weight leaves, its model FLOPs and whether a decode
step couples the batch's slots. It imports nothing of the program.

The block: pre-norm GQA attention (q, k, v, o projections) and a SwiGLU FFN,
or an MoE FFN of SwiGLU experts behind a float32 router.

Model FLOPs are counted from the configuration and each step's shapes
(never from the program), two per multiply-add. A token through a layer
costs its projections, its FFN (SwiGLU, or the router and the ``top_k``
experts it is sent to) and its attention: QK and PV over its own earlier
tokens and, with a store, over every key of the chunks it routes to. A
prefill computes the logits of its last position only; a decode step those
of its token.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from moska_bench import flops
from moska_bench.check import store_coupled


def leaves(m: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, scale group) of every leaf, in a fixed order."""
    d, f, V = m["d_model"], m["d_ff"], m["vocab_size"]
    hq = m["num_heads"] * m["head_dim"]
    hkv = m["num_kv_heads"] * m["head_dim"]
    moe = m.get("moe")
    out = [("embed", (V, d), "d")]
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), "z"), (p + "ln2", (d,), "z"),
                (p + "wq", (d, hq), "d"), (p + "wk", (d, hkv), "d"),
                (p + "wv", (d, hkv), "d"), (p + "wo", (hq, d), "o")]
        if moe:
            E = moe["num_experts"]
            out += [(p + "router", (d, E), "r"),
                    (p + "e_gate", (E, d, f), "d"),
                    (p + "e_up", (E, d, f), "d"),
                    (p + "e_down", (E, f, d), "f")]
        else:
            out += [(p + "w_gate", (d, f), "d"), (p + "w_up", (d, f), "d"),
                    (p + "w_down", (f, d), "f")]
    out.append(("final_norm", (d,), "z"))
    if not m.get("tie_embeddings", False):
        out.append(("unembed", (V, d), "d"))
    return out


def groups(m: dict) -> Dict[str, Tuple[float, bool]]:
    """Each scale group's standard deviation and whether it is float32
    (otherwise the served type), in the order they are drawn: "d" N(0,
    1/d_model), "o" N(0, 1/(heads*head_dim)), "f" N(0, 1/d_ff), "r" the
    float32 router (the program scores it in float32), "z" zeros (the norm
    multiplies by 1 + scale)."""
    return {"d": (1 / math.sqrt(m["d_model"]), False),
            "o": (1 / math.sqrt(m["num_heads"] * m["head_dim"]), False),
            "f": (1 / math.sqrt(m["d_ff"]), False),
            "r": (1 / math.sqrt(m["d_model"]), True),
            "z": (0.0, False)}


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


def prefill(m: dict, prompt: int, chunks: int) -> float:
    """A prompt of ``prompt`` tokens (its real length, not its bucket)."""
    causal = prompt * (prompt + 1) / 2
    per = (prompt * _per_layer(m) + flops.attention(m, 1, causal)
           + flops.attention(m, prompt, flops.shared_keys(m, chunks)))
    return m["num_layers"] * per + flops.logits(m)


def decode(m: dict, context: int, chunks: int) -> float:
    """One token that attends ``context`` unique rows (its own included)."""
    per = _per_layer(m) + flops.attention(
        m, 1, context + flops.shared_keys(m, chunks))
    return m["num_layers"] * per + flops.logits(m)


def batch_coupled(m: dict, chunks: int) -> bool:
    """Whether a decode step's outputs depend on the other slots: an MoE
    FFN's expert capacity, or the store's chunk capacity."""
    return bool(m.get("moe")) or store_coupled(m, chunks)
