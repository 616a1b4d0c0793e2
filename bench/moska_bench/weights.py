"""Seeded random weights, made on the device in a few large calls, and the
configuration file read into the program's config and the reference's.

Every matrix is drawn from N(0, 1/fan_in) in the type the model is served
in (the configuration's ``dtype``): the leaves that share a scale lie in one buffer, filled by
``torch.randn`` in pieces of at most 2**30 elements and scaled by one
multiply. The MoE router is float32 (the program scores it in float32),
norm scales are zero (the norm multiplies by 1 + scale). The program's
parameter structure (``DenseLM``) is built on the meta device and its
leaves pointed at views of these buffers; the reference gets the same
views as a plain dict.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import torch

PIECE = 1 << 30
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_spec(path: Path) -> dict:
    """The configuration file: the model's sizes under the program's field
    names, and its provenance (source, reduced, assumed, deployment)."""
    return json.loads(Path(path).read_text())


def program_config(spec: dict):
    """The program's ``ModelConfig`` for the sizes in ``spec``."""
    from repro_torch.configs import MoEConfig, ModelConfig, MoSKAConfig
    m = spec["model"]
    fields = {k: v for k, v in m.items() if k not in ("moe", "moska")}
    moe = MoEConfig(**m["moe"]) if m.get("moe") else MoEConfig()
    moska = dataclasses.replace(MoSKAConfig(), **m["moska"])
    return ModelConfig(name=spec["name"], moe=moe, moska=moska, **fields)


def _shapes(m: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, scale group) of every leaf, in a fixed order. Scale
    groups: "d" N(0, 1/d_model), "o" N(0, 1/(heads*head_dim)), "f" N(0,
    1/d_ff), "r" the float32 router, "z" zeros."""
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


def make_weights(spec: dict, seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """Every leaf of the model as a view of one buffer per scale group."""
    m = spec["model"]
    shapes = _shapes(m)
    scale = {"d": 1 / math.sqrt(m["d_model"]),
             "o": 1 / math.sqrt(m["num_heads"] * m["head_dim"]),
             "f": 1 / math.sqrt(m["d_ff"]),
             "r": 1 / math.sqrt(m["d_model"]), "z": 0.0}
    served = DTYPES[m["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for group, std in scale.items():
        leaves = [(n, s) for n, s, g in shapes if g == group]
        if not leaves:
            continue
        dt = torch.float32 if group == "r" else served
        total = sum(math.prod(s) for _, s in leaves)
        buf = torch.empty(total, dtype=dt, device=device)
        if std:
            for a in range(0, total, PIECE):
                piece = buf[a:a + PIECE]
                torch.randn(piece.shape, generator=gen, dtype=dt,
                            device=device, out=piece)
            buf.mul_(std)
        else:
            buf.zero_()
        at = 0
        for name, s in leaves:
            n = math.prod(s)
            out[name] = buf[at:at + n].view(s)
            at += n
    return out


def program_params(cfg, w: Dict[str, torch.Tensor]):
    """The program's ``DenseLM`` with its leaves pointed at ``w``."""
    from torch import nn
    from repro_torch.models.dense import DenseLM

    def put(pd, key, t):
        pd[key] = nn.Parameter(t, requires_grad=False)

    model = DenseLM(cfg, device="meta")
    put(model.embed, "embed", w["embed"])
    for i, lp in enumerate(model.layers):
        p = f"layers.{i}."
        put(lp.ln1, "scale", w[p + "ln1"])
        put(lp.ln2, "scale", w[p + "ln2"])
        for k in ("wq", "wk", "wv", "wo"):
            put(lp.attn, k, w[p + k])
        if cfg.moe.enabled:
            for k in ("router", "e_gate", "e_up", "e_down"):
                put(lp.moe, k, w[p + k])
        else:
            for k in ("w_gate", "w_up", "w_down"):
                put(lp.mlp, k, w[p + k])
    put(model.final_norm, "scale", w["final_norm"])
    if model.unembed is not None:
        put(model.unembed, "unembed", w["unembed"])
    return model
