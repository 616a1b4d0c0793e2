"""Logical-axis sharding rules (t5x-style), over a ``DeviceMesh``.

Port of the reference ``sharding/specs.py``. A rule set maps logical
names ("batch", "p_dm", "chunks", ...) to mesh axes; ``_resolve`` turns the
names of a tensor's dims into the reference's spec: one entry per dim,
each None, one axis name or a tuple of names, with the same guards (an
axis whose size does not divide the dim is dropped, each axis is used
once, axes the mesh lacks are dropped). ``placements`` turns such a spec
into DTensor placements, one per mesh dim.

The reference threads ``lsc`` through its model code and lets pjit place
every activation. The port runs eagerly and keeps its sharded paths
explicit: the shared chunk pool in ``core/disagg.py``, the weights under
FSDP in ``training/train_loop.py``. ``lsc`` is the identity on a plain
tensor or without rules, and a ``redistribute`` on a ``DTensor``.

Rule sets
---------
``TRAIN_RULES``    FSDP + TP: batch over (pod, data); parameter dim-0 /
                   d_model over data (fully-sharded); heads / d_ff / vocab /
                   experts over model.
``SERVE_RULES``    inference: batch over (pod, data); params replicated over
                   data, TP over model; shared KV *chunks* over data (the
                   paper's Shared-KV-node pool); unique KV batch-sharded
                   (the Unique-KV-node pool).
``LONGCTX_RULES``  batch=1 decode: context/chunk parallelism — chunks over
                   (pod, data).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

AxisVal = Union[None, str, Tuple[str, ...]]
LogicalRules = Dict[str, AxisVal]
Spec = Tuple[AxisVal, ...]

_state = threading.local()


def set_rules(rules: Optional[LogicalRules]) -> None:
    _state.rules = rules


def current_rules() -> Optional[LogicalRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[LogicalRules]):
    prev = current_rules()
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def _resolve(rules: LogicalRules, names: Sequence[Optional[str]],
             mesh_axes: Sequence[str],
             shape: Optional[Sequence[int]] = None,
             axis_sizes: Optional[Dict[str, int]] = None) -> Spec:
    """Resolve logical names to mesh axes; with ``shape`` given, drop any
    axis whose size does not divide the dimension (e.g. 8 kv heads cannot
    shard over model=16 — replicate instead)."""
    out = []
    used: set = set()
    for i, n in enumerate(names):
        if n is None:
            out.append(None)
            continue
        ax = rules.get(n)
        if ax is None:
            out.append(None)
            continue
        cand = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                     if a in mesh_axes and a not in used)
        if shape is not None and axis_sizes is not None:
            kept = []
            size = 1
            for a in cand:
                if shape[i] % (size * axis_sizes[a]) == 0:
                    kept.append(a)
                    size *= axis_sizes[a]
            cand = tuple(kept)
        used.update(cand)
        if not cand:
            out.append(None)
        elif len(cand) == 1:
            out.append(cand[0])
        else:
            out.append(cand)
    return tuple(out)


def _mesh_axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(axis names in mesh order, {name: size}) of a ``DeviceMesh`` or of
    a mapping of axis sizes."""
    if isinstance(mesh, Mapping):
        return tuple(mesh), dict(mesh)
    names = tuple(mesh.mesh_dim_names)
    return names, dict(zip(names, mesh.mesh.shape))


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a resolved spec over ``mesh`` (a
    ``DeviceMesh`` with named dims): ``Shard(i)`` on each mesh dim that
    dim i of the spec names, ``Replicate()`` on the others. A dim over
    several mesh axes is sharded over each; DTensor splits it in mesh-dim
    order, so the spec must name them in that order (the reference's
    major-to-minor order over a mesh laid out pod, data, model) wherever
    more than one of them has more than one device."""
    from torch.distributed.tensor import Replicate, Shard
    names, sizes = _mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for i, ax in enumerate(spec):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        real = [a for a in axes if sizes[a] > 1]
        if real != sorted(real, key=names.index):
            raise ValueError(f"dim {i} over {axes}: DTensor shards a dim "
                             f"in mesh order {names}")
        for a in axes:
            out[names.index(a)] = Shard(i)
    return tuple(out)


def logical_sharding_constraint(x: torch.Tensor, *names: Optional[str]
                                ) -> torch.Tensor:
    """Redistribute a ``DTensor`` to the placements its logical names
    resolve to; identity on a plain tensor or without rules."""
    from torch.distributed.tensor import DTensor
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    # align names to rank from the right (decode drops leading seq dims)
    if len(names) > x.ndim:
        names = names[len(names) - x.ndim:]
    elif len(names) < x.ndim:
        names = (None,) * (x.ndim - len(names)) + tuple(names)
    from repro_torch.sharding.tensor_parallel import redistribute
    mesh = x.device_mesh
    axes, sizes = _mesh_axes(mesh)
    ps = _resolve(rules, names, axes, x.shape, sizes)
    return redistribute(x, placements(ps, mesh))


lsc = logical_sharding_constraint


# ---------------------------------------------------------------------------
# Rule sets
# ---------------------------------------------------------------------------

TRAIN_RULES: LogicalRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": None,            # residual-stream seq dim (seqpar variant)
    "kv_seq": None,
    "chunk_seq": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_model": None,            # activations keep d_model replicated
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "expert_dm": None,
    "chunks": "data",
    "state": "model",
    # parameter logical dims
    "p_dm": "data",             # FSDP: weight d_model dim over data
    "p_heads": "model",
    "p_ff": "model",
    "p_vocab": "model",
    "p_experts": "model",
    "p_inner": "model",
}

SERVE_RULES: LogicalRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": None,
    # KV caches / chunk stores shard their *sequence/content* dim over the
    # model axis (flash-decoding KV split): GQA kv_heads (often 8 or 1)
    # cannot shard over model=16, but seq always divides.
    "kv_seq": "model",
    "chunk_seq": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_model": None,
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "expert_dm": None,
    # shared KV chunk pool over (pod, data) = the Shared-KV node pool;
    # single-pod meshes resolve this to plain data. Replicating per pod
    # instead makes a multi-pod mesh re-gather the store every layer.
    "chunks": ("pod", "data"),
    "state": "model",
    # weight-stationary serving does not fit >100B models on 16GB chips:
    # serve also shards the d_model weight dim over data (a per-layer
    # all-gather)
    "p_dm": "data",
    "p_heads": "model",
    "p_ff": "model",
    "p_vocab": "model",
    "p_experts": "model",
    "p_inner": "model",
}

LONGCTX_RULES: LogicalRules = {
    **SERVE_RULES,
    "batch": None,              # batch=1: cannot shard
    "chunks": ("pod", "data"),  # context parallelism over chunks
}


# ---------------------------------------------------------------------------
# Named rule overrides applied on top of a baseline rule set, each one
# hypothesis about where the collectives should go.
# ---------------------------------------------------------------------------

VARIANTS: Dict[str, LogicalRules] = {
    # decode: keep weights resident (TP over model only) instead of
    # FSDP-gathering every layer's weights each step — trades per-chip
    # weight memory for zero weight all-gather traffic.
    "weights_resident": {"p_dm": None},
    # MoE decode: experts resident over the *data* axis, expert weight
    # matrices TP-sharded over model — removes the per-layer expert-weight
    # all-gather; dispatch all-to-all routes activations instead.
    "expert_resident": {"p_experts": "data", "experts": "data",
                        "p_dm": "model", "expert_dm": "model"},
    # train: sequence-parallel residual stream — the per-layer saved
    # activation for backward is sharded over model; attention/FFN
    # re-gather, adding collectives but dividing the dominant activation
    # memory by the model-axis size.
    "seqpar": {"seq_res": "model"},
    # train: combine seqpar with kv_seq sharding of fresh K/V (prefill)
    "seqpar+kv": {"seq_res": "model", "kv_seq": "model"},
    # multi-pod decode: shard the chunk pool over (pod, data) — each pod
    # owns half the chunks (true two-pool disagg) instead of replicating
    # the store per pod and re-gathering it
    "chunks_global": {"chunks": ("pod", "data")},
    # train: FSDP on the *model-sharded* weight dim instead of d_model —
    # the weight-grad product then reduce-scatters its partial sums over
    # data instead of gathering global-batch activations
    "fsdp2": {"p_dm": None,
              "p_ff": ("model", "data"),
              "p_heads": ("model", "data"),
              "p_vocab": ("model", "data"),
              "p_inner": ("model", "data")},
}


def apply_variant(rules: LogicalRules, variant: Optional[str]
                  ) -> LogicalRules:
    if not variant:
        return rules
    out = dict(rules)
    for key in variant.split(","):
        out.update(VARIANTS[key])
    return out


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

# Map param leaf names -> logical dim names. Leading layer-stack dims are
# detected by rank mismatch and mapped to None.
_PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("p_vocab", None),
    "unembed": ("p_vocab", None),
    "wq": ("p_dm", "p_heads"),
    "wk": ("p_dm", "p_heads"),
    "wv": ("p_dm", "p_heads"),
    "wo": ("p_heads", "p_dm"),
    "bq": ("p_heads",),
    "bk": ("p_heads",),
    "bv": ("p_heads",),
    "w_gate": ("p_dm", "p_ff"),
    "w_up": ("p_dm", "p_ff"),
    "w_down": ("p_ff", "p_dm"),
    "router": ("p_dm", None),
    # experts over model axis (expert parallel); per-expert mats FSDP over
    # data on the d_model dim. d_ff stays local (per-expert FFNs are small).
    "e_gate": ("p_experts", "p_dm", None),
    "e_up": ("p_experts", "p_dm", None),
    "e_down": ("p_experts", None, "p_dm"),
    "scale": (None,),
    "bias": (None,),
    "in_proj": ("p_dm", "p_inner"),
    "out_proj": ("p_inner", "p_dm"),
    "conv_w": (None, "p_inner"),
    "conv_b": ("p_inner",),
    "a_log": ("p_inner",),
    "d_skip": ("p_inner",),
    "dt_bias": ("p_inner",),
    "lru_in": ("p_dm", "p_inner"),
    "lru_out": ("p_inner", "p_dm"),
    "lru_a": ("p_inner",),
    "lru_gate_w": (None, "p_inner"),
    "lru_gate_b": ("p_inner",),
    "pos_embed": (None, None),
}


def param_spec(name: str, shape: Sequence[int], rules: LogicalRules,
               mesh) -> Spec:
    """The spec of one parameter by the last part of its name (unknown
    names are replicated: an empty spec); extra leading dims (a layer
    stack) map to None. ``mesh``: a ``DeviceMesh``, or its axis sizes by
    name in mesh order."""
    dims = _PARAM_AXES.get(name.rsplit(".", 1)[-1])
    if dims is None:
        return ()
    axes, sizes = _mesh_axes(mesh)
    names = (None,) * (len(shape) - len(dims)) + tuple(dims)
    return _resolve(rules, names, axes, tuple(shape), sizes)


def param_specs(params: nn.Module, rules: LogicalRules, mesh
                ) -> Dict[str, Spec]:
    """{``named_parameters()`` name: spec} of a parameter module. The
    dense family's per-layer modules hold one layer of the reference's
    stacked leaves, so their specs are the reference's without its
    leading layer-stack None."""
    return {n: param_spec(n, p.shape, rules, mesh)
            for n, p in params.named_parameters()}


def param_pspecs(params: nn.Module, rules: LogicalRules, mesh
                 ) -> Dict[str, tuple]:
    """{``named_parameters()`` name: DTensor placements over ``mesh``}."""
    return {n: placements(s, mesh)
            for n, s in param_specs(params, rules, mesh).items()}


def named_sharding_tree(params: nn.Module, rules: LogicalRules, mesh
                        ) -> Dict[str, torch.Tensor]:
    """{name: each parameter's value as a ``DTensor`` at its placements}:
    ``distribute_tensor`` over ``param_pspecs``."""
    from torch.distributed.tensor import distribute_tensor
    pl = param_pspecs(params, rules, mesh)
    return {n: distribute_tensor(p.detach(), mesh, pl[n])
            for n, p in params.named_parameters()}
