"""The afmoe block's layout (arcee-ai's Trinity): its weight leaves, its
model FLOPs and whether a decode step couples the batch's slots. It imports
nothing of the program.

The block: pre-norm GQA attention with q and k norms over head_dim, an
output gate sigmoid(h Wg) and sandwich norms, on sliding-window layers
(window ``max(layer_windows)``, RoPE) and full layers (NoPE); the first
``num_dense_layers`` take a dense SwiGLU of ``dense_d_ff``, the others an
MoE of SwiGLU experts behind a float32 sigmoid router with a float32
selection bias, plus a shared SwiGLU expert.

Model FLOPs are counted from the configuration and each step's shapes
(never from the program), two per multiply-add. A token through a layer
costs its projections (q, k, v, the gate, o), its FFN (the dense SwiGLU,
or the router, the ``top_k`` experts it is sent to and the shared expert;
never the capacity rows) and its attention: QK and PV over the keys it
sees. On a sliding layer that is min(position + 1, window) keys, wherever
they lie (its own, or the document's tail); on a full layer its own
earlier tokens and, with a store, every key of the chunks it routes to.
A request's positions follow the document (``chunks`` chunks of
``chunk_size``). A prefill computes the logits of its last position only;
a decode step those of its token.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from moska_bench import flops
from moska_bench.check import store_coupled


def leaves(m: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, scale group) of every leaf, in a fixed order."""
    d, V, D = m["d_model"], m["vocab_size"], m["head_dim"]
    hq, hkv = m["num_heads"] * D, m["num_kv_heads"] * D
    moe = m["moe"]
    E, f, fs = moe["num_experts"], m["d_ff"], moe["shared_expert_width"]
    fd = m["dense_d_ff"]
    out = [("embed", (V, d), "d")]
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), "n"), (p + "ln2", (d,), "n"),
                (p + "q_norm", (D,), "n"), (p + "k_norm", (D,), "n"),
                (p + "post_attn", (d,), "n"), (p + "post_mlp", (d,), "n"),
                (p + "wq", (d, hq), "d"), (p + "wk", (d, hkv), "d"),
                (p + "wv", (d, hkv), "d"), (p + "wg", (d, hq), "d"),
                (p + "wo", (hq, d), "o")]
        if i < m["num_dense_layers"]:
            out += [(p + "w_gate", (d, fd), "d"), (p + "w_up", (d, fd), "d"),
                    (p + "w_down", (fd, d), "F")]
        else:
            out += [(p + "router", (d, E), "r"), (p + "expert_bias", (E,), "b"),
                    (p + "e_gate", (E, d, f), "d"),
                    (p + "e_up", (E, d, f), "d"),
                    (p + "e_down", (E, f, d), "f"),
                    (p + "sh_gate", (d, fs), "d"), (p + "sh_up", (d, fs), "d"),
                    (p + "sh_down", (fs, d), "s")]
    return out + [("final_norm", (d,), "n"), ("unembed", (V, d), "d")]


#: the seeded norm scales' and expert bias's standard deviations (assumed:
#: random weights carry no trained values; non-zero so that every norm
#: and the bias act). A trained bias balances the experts' load; this one
#: moves a quarter of the rows' top-8 and keeps the 32,768-token
#: registration's load under the capacity on isotropic rows (0.02 overfills
#: the busiest expert by half, and the drops then cascade)
NORM_STD = 0.1
BIAS_STD = 0.005


def groups(m: dict) -> Dict[str, Tuple[float, bool]]:
    """Each scale group's standard deviation and whether it is float32
    (otherwise the served type), in the order they are drawn: "d" N(0,
    1/d_model), "o" N(0, 1/(heads*head_dim)), "f" N(0, 1/d_ff) (the
    experts' down projections), "s" the shared expert's, "F" the dense
    layers', "r" the float32 router, "b" the float32 expert bias, "n" the
    norm scales (the norm multiplies by 1 + scale)."""
    return {"d": (1 / math.sqrt(m["d_model"]), False),
            "o": (1 / math.sqrt(m["num_heads"] * m["head_dim"]), False),
            "f": (1 / math.sqrt(m["d_ff"]), False),
            "s": (1 / math.sqrt(m["moe"]["shared_expert_width"]), False),
            "F": (1 / math.sqrt(m["dense_d_ff"]), False),
            "r": (1 / math.sqrt(m["d_model"]), True),
            "b": (BIAS_STD, True),
            "n": (NORM_STD, False)}


def _kinds(m: dict) -> Tuple[int, int, int, int]:
    """(sliding layers, full layers, dense-FFN layers, MoE layers)."""
    w = m["layer_windows"]
    sliding = sum(1 for x in w if x)
    dense = m["num_dense_layers"]
    return sliding, len(w) - sliding, dense, len(w) - dense


def _per_token(m: dict) -> float:
    """A token's projections and FFNs over every layer."""
    d, D = m["d_model"], m["head_dim"]
    hq, hkv = m["num_heads"] * D, m["num_kv_heads"] * D
    moe = m["moe"]
    _, _, dense, moe_layers = _kinds(m)
    proj = 2 * d * hq + 2 * d * hkv + hq * d
    ffn_dense = 3 * d * m["dense_d_ff"]
    ffn_moe = (d * moe["num_experts"] + moe["top_k"] * 3 * d * m["d_ff"]
               + 3 * d * moe["shared_expert_width"])
    return 2.0 * (len(m["layer_windows"]) * proj + dense * ffn_dense
                  + moe_layers * ffn_moe)


def _band(first: int, n: int, window: int) -> float:
    """Sum over positions p = first .. first + n - 1 of min(p + 1, window)."""
    lo, hi = first + 1, first + n              # the p + 1 values
    below = max(0, min(hi, window) - lo + 1)   # those under the window
    a = lo
    b = lo + below - 1
    return below * (a + b) / 2 + (n - below) * window


def prefill(m: dict, prompt: int, chunks: int) -> float:
    """A prompt of ``prompt`` tokens (its real length, not its bucket)."""
    sliding, full, _, _ = _kinds(m)
    base = chunks * m["moska"]["chunk_size"] if chunks else 0
    causal = prompt * (prompt + 1) / 2
    att = (sliding * flops.attention(m, 1, _band(base, prompt,
                                                 max(m["layer_windows"])))
           + full * (flops.attention(m, 1, causal) + flops.attention(
               m, prompt, flops.shared_keys(m, chunks))))
    return prompt * _per_token(m) + att + flops.logits(m)


def decode(m: dict, context: int, chunks: int) -> float:
    """One token that attends ``context`` unique rows (its own included)."""
    sliding, full, _, _ = _kinds(m)
    base = chunks * m["moska"]["chunk_size"] if chunks else 0
    window = max(m["layer_windows"])
    att = (sliding * flops.attention(m, 1, min(base + context, window))
           + full * flops.attention(m, 1, context + flops.shared_keys(
               m, chunks)))
    return _per_token(m) + att + flops.logits(m)


def batch_coupled(m: dict, chunks: int) -> bool:
    """Whether a decode step's outputs depend on the other slots: the MoE
    FFN's expert capacity, or the store's chunk capacity."""
    return bool(m.get("moe")) or store_coupled(m, chunks)
