"""Parameter trees of the SSM, hybrid and enc-dec families.

The reference keeps each family's weights as a nested dict pytree, with
layer-stacked leaves (``(L, ...)``, the hybrid's ``(n_superblocks,
per_cycle, ...)``) and, for the hybrid's tail, a list of per-layer trees.
:class:`ParamTree` holds the same tree as an ``nn.Module`` under the same
names, so ``params["layers"]["in_proj"]`` reads what the reference reads,
``state_dict()`` names every leaf by its path, and ``to(device)`` moves
the whole model. A spec is the tree with ``(shape, dtype)`` leaves.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Union

import torch
from torch import nn

Spec = Dict[str, Any]


class ParamTree(nn.Module):
    """A nested parameter tree: a dict in the spec is a subtree, a list a
    ``ModuleList`` of subtrees, a ``(shape, dtype)`` pair a parameter
    (``torch.empty``; the caller fills it)."""

    def __init__(self, spec: Spec, device=None):
        super().__init__()
        for name, leaf in spec.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf, device))
            elif isinstance(leaf, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(s, device) for s in leaf))
            else:
                shape, dtype = leaf
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device),
                    requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def stacked(spec: Spec, *lead: int) -> Spec:
    """``spec`` with every leaf's shape prefixed by ``lead`` (a layer
    stack)."""
    return {name: (stacked(s, *lead) if isinstance(s, dict)
                   else ((*lead, *s[0]), s[1]))
            for name, s in spec.items()}


class Layer(dict):
    """One layer's parameters, by name or as attributes (``lp["attn"]``,
    ``lp.attn``), as the dense family's layer modules read them."""

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def select(tree: Union[ParamTree, Dict[str, Any]],
           idx=None) -> Layer:
    """One layer of a stacked tree: every leaf indexed by ``idx`` (views,
    no copy); with ``idx`` None the leaves as they are."""
    items = (tree.items() if isinstance(tree, dict) else
             list(tree._parameters.items()) + list(tree._modules.items()))
    return Layer((name, select(t, idx) if isinstance(t, (dict, ParamTree))
                  else t if idx is None else t[idx])
                 for name, t in items)


Rule = Callable[[torch.Tensor, torch.Generator], None]


@torch.no_grad()
def fill(tree: ParamTree, generator: torch.Generator,
         rules: Dict[str, Rule]) -> ParamTree:
    """Fill every parameter by the rule of its leaf name (the last part of
    its path). ``generator`` must live on the parameters' device."""
    for path, p in tree.named_parameters():
        rules[path.rsplit(".", 1)[-1]](p, generator)
    return tree


def normal(std: float) -> Rule:
    def rule(p: torch.Tensor, g: torch.Generator) -> None:
        p.copy_(torch.randn(p.shape, generator=g, device=p.device,
                            dtype=torch.float32) * std)
    return rule


def const(value: float) -> Rule:
    def rule(p: torch.Tensor, g: torch.Generator) -> None:
        p.fill_(value)
    return rule


def fan_in(n: int) -> Rule:
    """Normal with std 1/sqrt(n): the reference's projections."""
    return normal(1.0 / math.sqrt(n))


def attn_spec(d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, qkv_bias: bool, dtype) -> Spec:
    hq, hkv = num_heads * head_dim, num_kv_heads * head_dim
    spec = {"wq": ((d_model, hq), dtype), "wk": ((d_model, hkv), dtype),
            "wv": ((d_model, hkv), dtype), "wo": ((hq, d_model), dtype)}
    if qkv_bias:
        spec.update(bq=((hq,), dtype), bk=((hkv,), dtype),
                    bv=((hkv,), dtype))
    return spec


def mlp_spec(d_model: int, d_ff: int, dtype, gated: bool = True) -> Spec:
    spec = {"w_up": ((d_model, d_ff), dtype),
            "w_down": ((d_ff, d_model), dtype)}
    if gated:
        spec["w_gate"] = ((d_model, d_ff), dtype)
    return spec

