"""Convert the reference package's parameters to the port's.

Input is the reference ``init_params`` pytree of the config's family as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's side);
bfloat16 leaves may arrive as numpy's ``bfloat16`` extension dtype. The
dense family's tree has layer-stacked leaves ``(L, ...)`` (MoE layers:
``moe.{router, e_gate, e_up, e_down}``, and ``mlp`` beside them under a
dense residual), which go to the per-layer modules of a ``DenseLM``. The
SSM (``layers``, ``final_norm``, ``embed``), hybrid (``super``, ``tail``,
``final_norm``, ``embed``) and enc-dec (``enc_layers``, ``dec_layers``,
``enc_norm``, ``final_norm``, ``embed``) trees go leaf for leaf into a
:class:`~repro_torch.models.params.ParamTree` of the same shape.
``to_reference_params`` is the inverse. The port itself never imports
jax.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import DENSE, MOE, VLM, ModelConfig
from repro_torch.models.dense import DenseLM
from repro_torch.models.model import empty_params
from repro_torch.models.params import ParamTree


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


def _copy_tree(module: ParamTree, tree: dict) -> None:
    names = set(module._parameters) | set(module._modules)
    if names != set(tree):
        raise ValueError(f"tree keys {sorted(tree)} != {sorted(names)}")
    for name, p in module._parameters.items():
        _copy(p, tree[name])
    for name, child in module._modules.items():
        if isinstance(child, ParamTree):
            _copy_tree(child, tree[name])
        else:                                   # a list of subtrees
            if len(child) != len(tree[name]):
                raise ValueError(f"{name}: {len(tree[name])} subtrees, "
                                 f"expected {len(child)}")
            for sub, t in zip(child, tree[name]):
                _copy_tree(sub, t)


@torch.no_grad()
def from_reference_params(cfg: ModelConfig, tree: dict, device=None):
    """Build the port's parameters of ``cfg``'s family (a ``DenseLM`` or a
    :class:`ParamTree`) holding the reference's weights."""
    model = empty_params(cfg, device)
    if cfg.family not in (DENSE, VLM, MOE):
        _copy_tree(model, tree)
        return model
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



def _to_numpy(t: torch.Tensor, bf16_as_float32: bool) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    if bf16_as_float32:
        return t.float().numpy()
    import ml_dtypes             # numpy's bfloat16 dtype, for exact leaves
    return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16).copy()


def to_reference_params(params: nn.Module,
                        values: Optional[Mapping[str, torch.Tensor]] = None,
                        *, bf16_as_float32: bool = False) -> Dict:
    """The inverse of :func:`from_reference_params`: the reference's
    pytree of the port's parameters ``params`` (a ``DenseLM`` or a
    :class:`ParamTree`), with numpy leaves. ``values`` replaces each
    parameter's value by the tensor of its name (``named_parameters()``)
    in that mapping: the optimizer's moments, which the reference keeps as
    trees of the parameters' shape. The dense family's per-layer leaves
    are stacked into ``(L, ...)`` leaves; a ``ModuleList`` (the hybrid's
    tail) becomes a list. bfloat16 leaves become numpy's ``bfloat16``
    extension dtype (ml_dtypes), or fp32 with ``bf16_as_float32`` (what
    a checkpoint stores)."""
    if values is None:
        values = dict(params.named_parameters())

    def leaf(name: str) -> np.ndarray:
        return _to_numpy(values[name], bf16_as_float32)

    def walk(module: nn.Module, prefix: str):
        if isinstance(module, nn.ModuleList):
            return [walk(m, f"{prefix}{i}.") for i, m in enumerate(module)]
        tree = {name: leaf(prefix + name)
                for name in module._parameters}
        for name, child in module._modules.items():
            if child is not None:
                tree[name] = walk(child, f"{prefix}{name}.")
        return tree

    if not isinstance(params, DenseLM):
        return walk(params, "")
    tree = {name: walk(child, f"{name}.")
            for name, child in params.named_children() if name != "layers"}
    per_layer = [walk(lp, f"layers.{i}.")
                 for i, lp in enumerate(params.layers)]
    tree["layers"] = {group: {name: np.stack([t[group][name]
                                              for t in per_layer])
                              for name in leaves}
                      for group, leaves in per_layer[0].items()}
    return tree


def reference_paths(params: nn.Module
                    ) -> Iterator[Tuple[str, Tuple[str, ...], Optional[int]]]:
    """(parameter name, its path in the reference's pytree, its row of
    that leaf or None) of every parameter of ``params``: the dense
    family's ``layers.{i}.{group}.{leaf}`` is row i of the stacked
    ``layers/{group}/{leaf}``; every other name is its path."""
    dense = isinstance(params, DenseLM)
    for name, _ in params.named_parameters():
        parts = tuple(name.split("."))
        if dense and parts[0] == "layers":
            yield name, ("layers", *parts[2:]), int(parts[1])
        else:
            yield name, parts, None
