"""Tensor parallelism over a mesh's ``model`` axis, and whole tensors from
their shards by hand.

The reference gets tensor parallelism from pjit: it places the weights by
the rules and lets ``lsc`` pin the activations. The port runs eagerly, so
its meshed path is explicit. The weights are ``DTensor`` leaves placed by
the rules (``sharding.specs.named_sharding_tree``) and the activations are
``DTensor`` values on the weights' mesh: a product of a replicated
activation with a column-sharded weight is column-sharded, a product with
a row-sharded weight is a partial sum, and ``lsc`` redistributes (the
all-reduce of the row-parallel product). Each weight is read through
``gather_weight``: its data and pod shards (the FSDP dims of the rules)
are gathered, its ``model`` shard stays, as pjit gathers a weight that the
rules put on ``data`` before its product. Code that mixes the activations
with plain tensors (RoPE, the attention, the kernels) runs on this rank's
local tensors (``local_call``); where such code splits a dim across ranks
(the unique cache's ``kv_seq`` and the store's ``chunk_seq`` over
``model``) the partials are combined by the exact LSE all-reduce of
``core/disagg.py``.

``full_tensor`` and ``local_part`` move between a ``DTensor`` and the
whole tensor without DTensor's own collectives: a checkpoint gathers its
leaves by hand with ``all_gather`` (DTensor's all-gather kills the rank
over gloo on CUDA tensors, torch 2.11, where its all-reduce and
reduce-scatter run) and restores each rank's shard by cutting it out of
the whole leaf, with no collective at all. ``redistribute`` is DTensor's
redistribution with its all-gathers run so by hand; ``lsc`` and the
weight and head gathers here go through it.

The expert-parallel MoE layer (``models/moe.py``) runs on local tensors
and moves them with plain c10d collectives over named mesh axes, each
under autograd with its adjoint: ``ScatterSum`` (a reduce-scatter),
``Gather`` (an all-gather), ``Piece`` (a local cut), ``SumGrad`` and
``SumOver`` (all-reduces of the gradient or the value); ``rows_before``
turns a rank's slot counts into the global positions' offsets.

``place`` and ``place_fields`` put a tensor, a cache or a store at the
placements that its logical names resolve to (the serving inputs of a
meshed step and the dry run's arguments); ``fake_tensors`` makes new
tensors fake for the dry run's abstract state.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import specs as sp


def is_meshed(t) -> bool:
    return isinstance(t, DTensor)


def _chunks(total: int, n: int) -> List[int]:
    """The sizes of ``torch.chunk``'s n pieces of a dim of ``total``
    (DTensor's split: ceil-sized pieces, the last ones short or empty)."""
    step = math.ceil(total / n) if total else 0
    return [max(0, min(step, total - i * step)) for i in range(n)]


def _levels(shape: Sequence[int], mesh, placements
            ) -> List[Tuple[int, int, int, int]]:
    """(mesh dim, tensor dim, size of that tensor dim before this mesh dim
    splits it, this rank's coordinate) for each ``Shard`` placement, in
    mesh-dim order: DTensor splits a dim over its mesh dims in that
    order."""
    cur = list(shape)
    coord = mesh.get_coordinate()
    out = []
    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            n, c = mesh.size(md), coord[md]
            out.append((md, p.dim, cur[p.dim], c))
            cur[p.dim] = _chunks(cur[p.dim], n)[c]
    return out


def local_part(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full`` at ``placements``
    over ``mesh``, cut out locally (a view): what ``distribute_tensor``
    would keep, with no collective."""
    out = full
    for md, dim, size, c in _levels(full.shape, mesh, placements):
        sizes = _chunks(size, mesh.size(md))
        out = out.narrow(dim, sum(sizes[:c]), sizes[c])
    return out


def _gather_levels(local: torch.Tensor, mesh, steps) -> torch.Tensor:
    """``local`` gathered along each (mesh dim, tensor dim, size before
    that mesh dim splits it) of ``steps``, in their order (innermost
    first)."""
    for md, dim, size in steps:
        local = all_gather_dim(local, dim, mesh, mesh.mesh_dim_names[md],
                               size)
    return local


def full_tensor(t: DTensor) -> torch.Tensor:
    """The whole value of ``t``, built from every rank's ``to_local()``
    shard with ``all_gather`` over each sharded mesh dim (the last first),
    each rank's shard padded to the largest one and trimmed after. A
    collective that every rank of ``t``'s mesh joins; ``Partial``
    placements are refused."""
    mesh = t.device_mesh
    if any(isinstance(p, Partial) for p in t.placements):
        raise ValueError(f"full_tensor: partial placements {t.placements}")
    return _gather_levels(t.to_local().detach(), mesh, [
        (md, dim, size) for md, dim, size, _ in
        reversed(_levels(t.shape, mesh, t.placements))])


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

class _GatherShards(torch.autograd.Function):
    """Forward: a ``DTensor``'s shards gathered by hand along the tensor
    dims of ``steps`` ((mesh dim, tensor dim, size before that mesh dim
    splits it), innermost first), replicated there (``mid``). Backward:
    the gradient redistributed to the input's placements (a partial
    gradient reduce-scattered, a replicated one cut locally), as
    DTensor's own all-gather's backward does."""

    @staticmethod
    def forward(ctx, t, mid, steps):
        mesh = t.device_mesh
        ctx.mesh, ctx.placements = mesh, t.placements
        return DTensor.from_local(_gather_levels(t.to_local(), mesh, steps),
                                  mesh, mid, run_check=False, shape=t.shape,
                                  stride=t.stride())

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def redistribute(t: DTensor, placements) -> DTensor:
    """``t.redistribute(mesh, placements)``, its all-gathers run by hand
    (plain c10d ``all_gather``): DTensor's functional all-gather kills
    the rank over gloo on CUDA tensors (torch 2.11), where its
    all-reduce and reduce-scatter run. Every tensor dim whose shards
    change on some mesh dim is gathered whole first, then DTensor cuts
    and reduces what is left (local chunks, partial sums). As DTensor's
    own, the backward hands the gradient on at ``t``'s placements, also
    where nothing changes (``lsc`` pins a gradient so)."""
    placements = tuple(placements)
    mesh = t.device_mesh
    dims = {p.dim for p, q in zip(t.placements, placements)
            if isinstance(p, Shard) and q != p}
    if dims:
        steps = tuple((md, dim, size) for md, dim, size, _ in
                      reversed(_levels(t.shape, mesh, t.placements))
                      if dim in dims)
        mid = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims
                    else p for p in t.placements)
        t = _GatherShards.apply(t, mid, steps)
        if placements == mid:
            return t
    return t.redistribute(mesh, placements)


def keep_shards(t: DTensor, axes: Sequence[str]) -> DTensor:
    """``t`` with its shards on every mesh axis outside ``axes`` gathered
    (an all-gather whose backward is a reduce-scatter)."""
    names = t.device_mesh.mesh_dim_names
    want = tuple(p if names[md] in axes else Replicate()
                 for md, p in enumerate(t.placements))
    return t if want == tuple(t.placements) else redistribute(t, want)


def gather_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight as its product reads it: a ``DTensor``'s shards on every
    mesh axis but ``model`` gathered (the FSDP dims of the rules), its
    ``model`` shard kept. A plain tensor as it is."""
    return keep_shards(w, ("model",)) if isinstance(w, DTensor) else w


def gather_weights(group) -> dict:
    """{name: ``gather_weight``} of a parameter group (a
    ``ParameterDict``), or the group itself when it is not meshed."""
    if not any(isinstance(v, DTensor) for v in group.values()):
        return group
    return {k: gather_weight(v) for k, v in group.items()}


def split_heads(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n * d) -> (..., n, d). A ``DTensor`` sharded on its last dim
    keeps the shard on the heads where every mesh dim that splits it
    divides ``n``; elsewhere that mesh dim is gathered first (8 kv heads
    do not split over a model axis of 16: the reference's guard
    replicates them)."""
    lead = t.shape[:-1]
    if isinstance(t, DTensor):
        last = t.ndim - 1
        want = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                     and n % t.device_mesh.size(md) else p
                     for md, p in enumerate(t.placements))
        if want != tuple(t.placements):
            t = redistribute(t, want)
    return t.reshape(*lead, n, d)


def local_range(t: DTensor, dim: int) -> Tuple[int, int]:
    """(first, count) of the global indices of dim ``dim`` of a
    ``DTensor`` that this rank holds: the range that ``local_part`` cuts,
    uneven splits included."""
    start, size = 0, t.shape[dim]
    mesh = t.device_mesh
    for md, d, whole, c in _levels(t.shape, mesh, t.placements):
        if d == dim:
            sizes = _chunks(whole, mesh.size(md))
            start, size = start + sum(sizes[:c]), sizes[c]
    return start, size


def split_axes(t: DTensor, dim: int) -> Tuple[str, ...]:
    """The mesh axes (in mesh order) that split dim ``dim`` of a
    ``DTensor``."""
    names = t.device_mesh.mesh_dim_names
    return tuple(names[md] for md, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def kv_for_heads(k: torch.Tensor, k_first: int, q_first: int, q_count: int,
                 group: int, dim: int = -2) -> torch.Tensor:
    """The kv heads of the local tensor ``k`` (whose first head is global
    head ``k_first``) that the query heads [q_first, q_first + q_count)
    read, GQA group size ``group``; a rank's query heads must cover whole
    groups or lie within one."""
    lo, hi = q_first // group, (q_first + q_count - 1) // group + 1
    if q_count % group and (hi - lo) != 1:
        raise ValueError(f"{q_count} query heads from {q_first} straddle "
                         f"groups of {group}")
    return k.narrow(dim, lo - k_first, hi - lo)


def local_call(fn: Callable, args: Sequence, out_placements, mesh,
               grad_placements: Optional[Sequence] = None):
    """``fn`` on this rank's local tensors of ``args`` (``DTensor`` args
    give their ``to_local()``, whose gradient is taken at the
    corresponding ``grad_placements`` entry where one is given: a
    ``Partial`` where each rank reads a different part of a replicated
    tensor), its tensor outputs wrapped as ``DTensor`` values at
    ``out_placements`` (one placement tuple, or a sequence of them, one
    per output) on ``mesh``."""
    grad_placements = grad_placements or [None] * len(args)
    local = [a.to_local(grad_placements=g) if isinstance(a, DTensor) else a
             for a, g in zip(args, grad_placements)]
    out = fn(*local)
    if isinstance(out, torch.Tensor):
        return DTensor.from_local(out, mesh, out_placements,
                                  run_check=False)
    return type(out)(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o, pl in zip(out, out_placements))


# ---------------------------------------------------------------------------
# collectives over mesh axes under autograd (the MoE layer's dispatch)
# ---------------------------------------------------------------------------

# plain c10d collectives, not DTensor's functional ones (over gloo on CUDA
# tensors ``DTensor.full_tensor`` kills the rank, torch 2.11); the
# ``*_single`` names replace the ``*_tensor`` ones in newer torch
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _padded_front(t: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """``t`` with ``dim`` moved to the front and zero-padded to ``rows``,
    contiguous (what a c10d collective splits)."""
    t = t.movedim(dim, 0)
    if t.shape[0] < rows:
        t = torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])
    return t.contiguous()


def _axis(mesh, axis: str) -> Tuple[object, int, int]:
    """(process group, size, this rank's coordinate) of a mesh axis."""
    return (mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)),
            mesh.get_local_rank(axis))


def all_gather_dim(t: torch.Tensor, dim: int, mesh, axis: str, total: int
                   ) -> torch.Tensor:
    """The whole dim ``dim`` (``total`` long) from each rank's piece of it
    (``torch.chunk``'s pieces over the mesh ``axis``, in coordinate
    order), outside autograd."""
    group, n, _ = _axis(mesh, axis)
    if n == 1:
        return t
    step = _chunks(total, n)[0]
    src = _padded_front(t, dim, step)
    out = src.new_empty((n * step,) + src.shape[1:])
    _all_gather(out, src, group=group)
    return out[:total].movedim(0, dim).contiguous()


def reduce_scatter_dim(t: torch.Tensor, dim: int, mesh, axis: str
                       ) -> torch.Tensor:
    """This rank's ``torch.chunk`` piece of dim ``dim`` of the sum of
    every rank's ``t`` over the mesh ``axis``, outside autograd."""
    group, n, c = _axis(mesh, axis)
    if n == 1:
        return t
    sizes = _chunks(t.shape[dim], n)
    src = _padded_front(t, dim, n * sizes[0])
    out = src.new_empty((sizes[0],) + src.shape[1:])
    _reduce_scatter(out, src, group=group)
    return out[:sizes[c]].movedim(0, dim).contiguous()


def _piece(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """This rank's ``torch.chunk`` piece of dim ``dim`` of ``t`` over the
    mesh ``axis``."""
    _, n, c = _axis(mesh, axis)
    sizes = _chunks(t.shape[dim], n)
    return t.narrow(dim, sum(sizes[:c]), sizes[c])


def _all_reduce(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    t = t.clone()
    for a in axes:
        if mesh.size(mesh.mesh_dim_names.index(a)) > 1:
            dist.all_reduce(t, group=mesh.get_group(a))
    return t


class ScatterSum(torch.autograd.Function):
    """Forward: this rank's piece of dim ``dim`` of the ranks' sum over a
    mesh axis (a reduce-scatter). Backward: the pieces' gradients gathered
    (each rank's input reaches one rank's piece)."""

    @staticmethod
    def forward(ctx, t, dim, mesh, axis):
        ctx.args, ctx.total = (dim, mesh, axis), t.shape[dim]
        return reduce_scatter_dim(t, dim, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        dim, mesh, axis = ctx.args
        return (all_gather_dim(grad, dim, mesh, axis, ctx.total),
                None, None, None)


class Gather(torch.autograd.Function):
    """Forward: the whole dim ``dim`` from the pieces over a mesh axis (an
    all-gather). Backward: with ``summed`` the ranks' gradients of the
    whole summed into each piece (a reduce-scatter: each rank read other
    parts of it), else this rank's piece of its own gradient (every rank
    read the whole alike)."""

    @staticmethod
    def forward(ctx, t, dim, mesh, axis, total, summed):
        ctx.args, ctx.summed = (dim, mesh, axis), summed
        return all_gather_dim(t, dim, mesh, axis, total)

    @staticmethod
    def backward(ctx, grad):
        grad = (reduce_scatter_dim if ctx.summed else _piece)(grad, *ctx.args)
        return grad, None, None, None, None, None


class Piece(torch.autograd.Function):
    """Forward: this rank's piece of dim ``dim`` of a tensor that the
    ranks of a mesh axis hold alike. Backward: the pieces' gradients
    gathered, so each rank's input gets the whole gradient."""

    @staticmethod
    def forward(ctx, t, dim, mesh, axis):
        ctx.args, ctx.total = (dim, mesh, axis), t.shape[dim]
        return _piece(t, dim, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        dim, mesh, axis = ctx.args
        return (all_gather_dim(grad, dim, mesh, axis, ctx.total),
                None, None, None)


class SumGrad(torch.autograd.Function):
    """Forward: the identity on a tensor that the ranks of the mesh
    ``axes`` hold alike. Backward: the ranks' gradients summed, each rank
    having used its copy for another part of the work (Megatron's f)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.args = (mesh, axes)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, *ctx.args), None, None


class SumOver(torch.autograd.Function):
    """Forward: the sum over the ranks of the mesh ``axes`` (an
    all-reduce). Backward: with ``summed`` the ranks' gradients summed
    (each rank uses the sum for other work), else the gradient as it is
    (every rank uses the sum alike)."""

    @staticmethod
    def forward(ctx, t, mesh, axes, summed):
        ctx.args, ctx.summed = (mesh, axes), summed
        return _all_reduce(t, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed:
            grad = _all_reduce(grad, *ctx.args)
        return grad, None, None, None


def rows_before(counts: torch.Tensor, mesh, axes: Sequence[str]
                ) -> torch.Tensor:
    """Sum of ``counts`` over the ranks whose rows come before this rank's
    in a dim split over the mesh ``axes`` (in mesh order, the first
    outermost): the exclusive prefix that turns a rank-local position into
    a global one. Every rank of each axis joins."""
    before = torch.zeros_like(counts)
    block = counts
    for ax in reversed(tuple(axes)):
        _, n, c = _axis(mesh, ax)
        parts = all_gather_dim(block[None], 0, mesh, ax, n)
        before = before + parts[:c].sum(0)
        block = parts.sum(0)
    return before


# ---------------------------------------------------------------------------
# a block's branch on local tensors (the state families' mixers)
# ---------------------------------------------------------------------------

def model_piece(t: DTensor, dim: int) -> Tuple[int, int, bool]:
    """(first, count, split) of the piece of dim ``dim`` of a ``DTensor``
    that this rank holds over ``model``: its piece where ``model`` splits
    that dim (``split``), else the whole dim."""
    if "model" in split_axes(t, dim):
        first, count = local_range(t, dim)
        return first, count, True
    return 0, t.shape[dim], False


def model_share(t: DTensor, dim: int) -> Tuple[int, int, bool]:
    """``model_piece``, but where ``model`` leaves the dim whole, this
    rank's ``torch.chunk`` share of it by its ``model`` coordinate: the
    rows a rank contracts over in a row-parallel product whose weight the
    rules leave whole (each rank does its share of the work once)."""
    first, count, split = model_piece(t, dim)
    if split:
        return first, count, split
    _, n, c = _axis(t.device_mesh, "model")
    sizes = _chunks(count, n)
    return sum(sizes[:c]), sizes[c], False


def whole_over_model(t: torch.Tensor, dim: int, span: Tuple[int, int, bool],
                     total: int, mesh) -> torch.Tensor:
    """The whole dim ``dim`` (``total`` long) of a local tensor that holds
    its ``span`` (``model_piece``): gathered over ``model`` where the span
    is a piece (``Gather``, the ranks' gradients summed back into each
    piece), as it is where the span is the whole."""
    if not span[2] or span[1] == total:
        return t
    return Gather.apply(t, dim % t.ndim, mesh, "model", total, True)


def concat_whole(t: torch.Tensor, span: Tuple[int, int, bool],
                 parts: Sequence[int], mesh) -> torch.Tensor:
    """The whole last dim of a product whose output concatenates ``parts``
    (mamba2's z | x | B | C | dt, the RG-LRU's xa | xb and r | i) from
    this rank's ``span`` of its columns. The rules split such a product
    contiguously, so a rank's columns are not its slice of each part (at
    a ``model`` of 2 the first rank may hold all of the first part): the
    columns are gathered whole and each rank cuts what it needs of each
    part from the whole."""
    return whole_over_model(t, -1, span, sum(parts), mesh)


def own_piece(t: torch.Tensor, dim: int, span: Tuple[int, int, bool]
              ) -> torch.Tensor:
    """This rank's ``span`` (``model_piece`` or ``model_share``) of dim
    ``dim`` of a local tensor that holds either that piece or the whole
    dim."""
    first, count, split = span
    return t if split else t.narrow(dim, first, count)


def _branch_grad(w: DTensor, x: DTensor) -> tuple:
    """The placements of a weight's gradient from one rank's share of a
    branch (``block_call``): partial over ``model`` where the weight is
    whole there, its own piece where ``model`` splits it, and partial over
    every axis that splits the rows of ``x``."""
    names = w.device_mesh.mesh_dim_names
    return tuple(
        (p if isinstance(p, Shard) else Partial()) if names[md] == "model"
        else (Partial() if isinstance(x.placements[md], Shard) else p)
        for md, p in enumerate(w.placements))


def block_call(fn: Callable, x: DTensor, weights: dict) -> DTensor:
    """A block's branch ``fn(x, weights)`` on this rank's local tensors,
    Megatron's way: its output (x's shape) comes back at ``x``'s
    placements, whole over ``model``.

    ``x`` is the residual stream (rows over the batch axes, whole over
    ``model``); ``fn`` gets it through ``SumGrad`` over ``model``, so that
    inside ``fn`` a tensor that the ranks of ``model`` hold alike carries a
    partial gradient (the ranks' gradients add up to its gradient) and a
    piece that only this rank holds carries its whole gradient. ``fn``
    moves between the two with ``whole_over_model`` (an all-gather whose
    backward reduce-scatters) and ``own_piece`` (a local cut), and ends
    with ``SumOver(..., summed=False)`` over ``model`` of its share of the
    output. ``weights`` ({name: a ``DTensor`` parameter}) reach ``fn`` as
    their local tensors after ``gather_weight`` (their ``model`` piece, or
    the whole where ``model`` leaves them whole)."""
    mesh = x.device_mesh
    names = list(weights)
    ws = [gather_weight(weights[n]) for n in names]

    def body(xl, *wl):
        xl = SumGrad.apply(xl, mesh, ("model",))
        return fn(xl, dict(zip(names, wl)))

    return local_call(body, [x] + ws, x.placements, mesh,
                      grad_placements=[None] + [_branch_grad(w, x)
                                                for w in ws])


def write_prefix_meshed(kc: DTensor, vc: DTensor, k: DTensor, v: DTensor
                        ) -> None:
    """``kvcache.cache.write_prefix`` on a mesh: the fresh keys and values
    (B, S_new, KH, D) written at positions [0, S_new) of caches (B, S, KH,
    D) split by row and by position or by kv head; each rank writes the
    positions and heads it holds, in place."""
    names = kc.device_mesh.mesh_dim_names
    rows, heads = split_axes(kc, 0), split_axes(kc, 2)
    want = tuple(Shard(0) if n in rows else Shard(2) if n in heads
                 else Replicate() for n in names)
    k, v = (t if tuple(t.placements) == want else redistribute(t, want)
            for t in (k, v))
    first, n = local_range(kc, 1)
    S_new = k.shape[1]
    take = max(0, min(n, S_new - first))
    if take:
        kc.to_local()[:, :take] = k.to_local()[:, first:first + take]
        vc.to_local()[:, :take] = v.to_local()[:, first:first + take]


# ---------------------------------------------------------------------------
# placing inputs by their logical names, and fake tensors
# ---------------------------------------------------------------------------

def place(t: torch.Tensor, names: Sequence[Optional[str]], rules, mesh
          ) -> DTensor:
    """``t`` as a ``DTensor`` at the placements its logical names resolve
    to on ``mesh`` under ``rules`` (the guarded resolution: an axis that
    does not divide its dim is dropped). A fake ``t`` gives a fake
    ``DTensor``."""
    from torch.distributed.tensor import distribute_tensor
    names = tuple(names[:t.ndim]) + (None,) * (t.ndim - len(names))
    axes, sizes = sp._mesh_axes(mesh)
    spec = sp._resolve(rules, names, axes, tuple(t.shape), sizes)
    return distribute_tensor(t, mesh, sp.placements(spec, mesh))


def place_fields(tup, table, rules, mesh):
    """A NamedTuple or a dict of tensors (a cache, a store) placed field by
    field by ``table`` ({field: logical names}; a field it does not name is
    replicated, a None field stays None)."""
    def put(name, t):
        return None if t is None else place(t, table.get(name, ()), rules,
                                            mesh)
    if isinstance(tup, dict):
        return {name: put(name, t) for name, t in tup.items()}
    return type(tup)(*(put(name, t) for name, t in zip(tup._fields, tup)))


def fake_tensors():
    """A context in which new tensors are fake (shapes and dtypes, no
    memory): the active ``FakeTensorMode`` when there is one (a dry run's:
    fake tensors of two modes do not mix), else a new one."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    if any(isinstance(m, FakeTensorMode)
           for m in _get_current_dispatch_mode_stack()):
        return contextlib.nullcontext()
    return FakeTensorMode(allow_non_fake_inputs=True)
