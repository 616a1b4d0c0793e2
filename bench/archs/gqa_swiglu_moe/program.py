"""The program under test for this block: the port's ``ModelConfig`` for a
configuration's sizes, its ``DenseLM`` with every leaf pointed at the
benchmark's weights, and where the program makes the choices that the
judge follows (``moska_bench/capture.py``).

It imports the program only inside its functions, so that loading it
loads nothing of the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

#: per kind of choice, the program's function that makes it (module,
#: attribute: the names the model calls) and the ids in what it returns
CHOICES = {
    "route": ("repro_torch.core.router", "route",
              lambda out: out.chunk_ids),
    "expert": ("repro_torch.models.moe", "top_k", lambda out: out[1]),
}


def program_config(spec: dict):
    """The program's ``ModelConfig`` for the sizes in ``spec``."""
    from repro_torch.configs import MoEConfig, ModelConfig, MoSKAConfig
    m = spec["model"]
    fields = {k: v for k, v in m.items() if k not in ("moe", "moska")}
    moe = MoEConfig(**m["moe"]) if m.get("moe") else MoEConfig()
    moska = dataclasses.replace(MoSKAConfig(), **m["moska"])
    return ModelConfig(name=spec["name"], moe=moe, moska=moska, **fields)


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
