"""Convert the reference package's dense parameters to the port's.

Input is the reference ``dense.init_params`` pytree as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the caller's side), with
layer-stacked leaves ``(L, ...)`` (MoE layers: ``moe.{router, e_gate,
e_up, e_down}``, and ``mlp`` beside them under a dense residual);
bfloat16 leaves may arrive as numpy's ``bfloat16`` extension dtype. The
port itself never imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dense import DenseLM


def to_tensor(a) -> torch.Tensor:
    """numpy array (incl. the bfloat16 extension dtype) -> CPU tensor,
    bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _copy(dst: torch.Tensor, src) -> None:
    t = to_tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
    dst.copy_(t.to(dst.dtype))


@torch.no_grad()
def from_reference_params(cfg: ModelConfig, tree: dict,
                          device=None) -> DenseLM:
    """Build a :class:`DenseLM` holding the reference's weights."""
    model = DenseLM(cfg, device)
    _copy(model.embed["embed"], tree["embed"]["embed"])
    _copy(model.final_norm["scale"], tree["final_norm"]["scale"])
    if model.unembed is not None:
        _copy(model.unembed["unembed"], tree["unembed"]["unembed"])
    stacked = tree["layers"]
    for i, lp in enumerate(model.layers):
        # ln1, ln2, attn, and mlp and/or moe (the router stays fp32)
        for group, pd in lp.named_children():
            for name, p in pd.items():
                _copy(p, np.asarray(stacked[group][name])[i])
    return model
