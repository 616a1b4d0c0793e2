"""The program under test for the afmoe block: the port's ``ModelConfig``
for a configuration's sizes, its ``DenseLM`` with every leaf pointed at
the benchmark's weights, and where the program makes the choices that the
judge follows (``moska_bench/capture.py``): the chunks each full layer
routes to (sliding layers never route), and each MoE layer's experts, the
top k by sigmoid score plus the expert bias.

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
    from repro_torch.configs import AfmoeConfig, AfmoeMoEConfig, MoSKAConfig
    m = spec["model"]
    fields = {k: v for k, v in m.items() if k not in ("moe", "moska")}
    fields["layer_windows"] = tuple(m["layer_windows"])
    moska = dataclasses.replace(MoSKAConfig(), **m["moska"])
    return AfmoeConfig(name=spec["name"], moe=AfmoeMoEConfig(**m["moe"]),
                       moska=moska, **fields)


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
        put(lp.qk_norm, "q", w[p + "q_norm"])
        put(lp.qk_norm, "k", w[p + "k_norm"])
        put(lp.post_norm, "attn", w[p + "post_attn"])
        put(lp.post_norm, "mlp", w[p + "post_mlp"])
        for k in ("wq", "wk", "wv", "wg", "wo"):
            put(lp.attn, k, w[p + k])
        if hasattr(lp, "moe"):
            for k in ("router", "expert_bias", "e_gate", "e_up", "e_down",
                      "sh_gate", "sh_up", "sh_down"):
                put(lp.moe, k, w[p + k])
        else:
            for k in ("w_gate", "w_up", "w_down"):
                put(lp.mlp, k, w[p + k])
    put(model.final_norm, "scale", w["final_norm"])
    put(model.unembed, "unembed", w["unembed"])
    return model
