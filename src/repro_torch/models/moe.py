"""Capacity-based (dropping) Mixture-of-Experts FFN.

Port of the reference ``models/moe.py``. Token dispatch uses the one-hot
cumsum position trick (GShard/Switch) with scatter/gather data movement
rather than the O(T·E·C·d) dispatch einsum, so only the active experts'
GEMMs run. Slots are token-major (token t's K choices are slots
t*K .. t*K+K-1), and a slot's position in its expert's batch is its rank
among the slots routed there, so earlier rows win capacity. The capacity
counts every row handed in (padding and free slots too), as the
reference's does: the same rows give the same drops.

In a data-parallel training step (``sharding.data_parallel``) each rank
holds its rows of the global batch, in row order, and the layer computes
what the reference computes over the global batch: the capacity of the
global token count, each slot's position after the slots of earlier
ranks, and the aux loss's batch means over every rank.

Expert parallelism
------------------
Under a mesh (``sharding/tensor_parallel.py``) x is a ``DTensor`` whose
rows are split over the row axes (``pod``, ``data``) and replicated over
``model``, and the layer computes what the reference computes over the
global token batch, with the experts placed by the rules:

  default          ``e_gate``/``e_up`` (E, d, f) and ``e_down`` (E, f, d)
                   split by expert over ``model`` (their d dim over
                   ``data`` for FSDP, gathered on use); the capacity rows
                   of the expert batch (E, C, d) split over the row axes
  expert_resident  experts over ``data``, their d dim over ``model``;
                   the capacity rows over ``pod``

Routing stays local: each rank scores its rows with the whole router in
fp32 (the router's product, T_local x d x E a rank, is the one piece of
work that every rank of ``model`` repeats), takes the stable top-k, and
places each slot at its global position: its rank among its expert's
slots of its own rows plus the slots of the ranks whose rows come
earlier (``tensor_parallel.rows_before``). The capacity is that of the
global token count.

Dispatch. Each rank writes its kept slots at their global positions into
a zeroed buffer: over an expert axis that splits the rows too
(``expert_resident``'s ``data``) every expert's, over one that does not
(the default's ``model``) its own experts' only; its d slice where
``model`` splits d. Then a reduce-scatter over each row axis hands every
rank its experts' share, the capacity rows or the experts (exact: each
position has one writer and zeros elsewhere), and a capacity axis that
does not split the rows is cut locally. Each rank runs its experts'
SwiGLU on its piece: the default's (E/m, C/D, d) with whole weights, or
``expert_resident``'s (E/D, C/P, d/m), whose gate and up products are
partial sums over ``model`` reduced by one all-reduce. The GEMMs'
FLOPs over all ranks are a world of one's.

Combine. An all-gather over the same axes, in the opposite order, gives
each rank every slot of its experts (the default: the rows of every
capacity piece; ``expert_resident``: every expert), it reads its own
slots, and sums the K choices gate-weighted in x's dtype. That sum is a
partial over ``model`` under the default rules (each rank holds its own
experts' terms; the residual's ``lsc`` reduces it like a row-parallel
product's) and a d slice under ``expert_resident``. x and the gates
enter that part through ``SumGrad``, whose backward sums their gradients
over ``model`` (each rank of it used them for its own experts or d).

Elements a rank moves per layer, forward (the default rules, D data
ranks, m model ranks): a reduce-scatter and an all-gather of (E/m, C,
d), and the all-reduce of the (T_local, d) output over ``model``. Why not an
all-to-all of the slots to their owners: a slot's global position
depends on every rank's routing, so the per-pair counts depend on the
data; a fixed-shape ``all_to_all_single`` must be sized for the worst
case, which is the same (E/m, C, d) bytes, and one sized to the data
needs the split sizes on the host (a sync every layer) and cannot be
traced on the dry run's fake tensors. Every shape here follows from T,
E, K, C and the mesh: no ``.item()``, no ``nonzero``, no data-dependent
split. The reduce-scatter's input holds C x E/m rows a rank, where the
rank's own slots fill T/D x K/m of them on average: capacity_factor x D
times fewer (``PERF.md``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import MoEConfig
from repro_torch.core.router import top_k
from repro_torch.sharding import data_parallel as dp
from repro_torch.sharding import tensor_parallel as tp


@torch.no_grad()
def moe_init(p, generator: torch.Generator, d_model: int, d_ff: int
             ) -> None:
    """Draw ``p``'s leaves (``router`` fp32 (d, E), ``e_gate``/``e_up``
    (E, d, f), ``e_down`` (E, f, d); a shared expert's ``sh_*``) with the
    reference's scales: normal times 1/sqrt(fan_in); a sigmoid router's
    ``expert_bias`` starts at 0."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    draws = [("router", s_in), ("e_gate", s_in), ("e_up", s_in),
             ("e_down", s_out)]
    if "sh_down" in p:                     # the shared expert, after
        draws += [("sh_gate", s_in), ("sh_up", s_in),
                  ("sh_down", 1.0 / math.sqrt(p["sh_down"].shape[0]))]
    for name, std in draws:
        t = p[name]
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * std)
    if "expert_bias" in p:
        p["expert_bias"].zero_()


def moe_capacity(num_tokens: int, cfg: MoEConfig) -> int:
    cap = int(math.ceil(num_tokens * cfg.top_k * cfg.capacity_factor
                        / cfg.num_experts))
    return max(8, int(math.ceil(cap / 8) * 8))


def moe_ffn(x: torch.Tensor, p, cfg: MoEConfig,
            capacity: Optional[int] = None,
            rec: Optional[obs.DeviceRecorder] = None, with_aux: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (T, d) flattened tokens -> (y: (T, d), aux_loss: fp32 scalar, or
    None with ``with_aux=False``: serving drops it, and eager PyTorch would
    launch its kernels all the same).

    The router scores ``x.float()`` in fp32 (a softmax, or the afmoe
    sigmoid with its selection bias: ``_sigmoid_route``, plus the shared
    expert's SwiGLU over every row at the end); a kept slot's token is
    written into its expert's batch (E, capacity, d), a dropped one into a
    trash row whose expert output reads as 0. The gate-weighted sum over
    the K choices runs in x's dtype. ``rec`` counts the kept slots on the
    device (``moe/dispatched_slots``) and the routed ones, T·K, on the host
    (``moe/routed_slots``): the dropped ones are their difference.
    """
    if tp.is_meshed(x):
        return _moe_ffn_meshed(x, p, cfg, capacity, rec, with_aux)
    T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    sharded = dp.data_group() is not None
    T_all = T * dp.world()                 # the ranks hold equal rows
    if capacity is None:
        capacity = moe_capacity(T_all, cfg)
    capacity = min(capacity, T_all * K)

    if cfg.score_func == "sigmoid":
        probs, gates, ids = _sigmoid_route(x, p, cfg)
    else:
        probs = torch.softmax(x.float() @ p["router"], dim=-1)    # (T, E)
        gates, ids = top_k(probs, K)                              # (T, K)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    aux = None
    if with_aux:
        # load-balancing aux loss (Switch): E * sum(frac_tokens * frac_probs)
        me = probs.mean(dim=0)
        ce = F.one_hot(ids[:, 0], E).float().mean(dim=0)
        if sharded:
            me, ce = dp.global_mean(me), dp.global_sum(ce) / dp.world()
        aux = E * (me * ce).sum() * cfg.aux_loss_weight

    flat = ids.reshape(-1)                                        # (T*K,)
    onehot = F.one_hot(flat, E)
    pos = (onehot.cumsum(dim=0) - 1).mul_(onehot).sum(dim=1)
    if sharded:
        # a slot's place among its expert's slots of the global batch
        keep = pos + dp.ranks_before(onehot.sum(dim=0))[flat] < capacity
    else:
        keep = pos < capacity
    rows = min(capacity, T * K)            # this rank's kept slots fit
    row = torch.where(keep, pos, rows)                            # trash row
    if rec is not None:
        rec.inc("moe/dispatched_slots", keep.sum(dtype=torch.float32))
        rec.inc("moe/routed_slots", T * K)

    xe = x.new_zeros((E, rows + 1, d))
    xe[flat, row] = x[:, None].expand(T, K, d).reshape(T * K, d)
    xe = xe[:, :rows]
    h = F.silu(torch.bmm(xe, p["e_gate"])) * torch.bmm(xe, p["e_up"])
    ye = F.pad(torch.bmm(h, p["e_down"]), (0, 0, 0, 1))          # trash: 0

    y_slots = ye[flat, row]                                       # (T*K, d)
    y = (y_slots.view(T, K, d) * gates[..., None].to(x.dtype)).sum(dim=1)
    if cfg.shared_expert_width:
        y = y + _shared_expert(x, p)
    return y.to(x.dtype), aux


def _sigmoid_route(x: torch.Tensor, p, cfg: MoEConfig):
    """The afmoe router: s = sigmoid(x W_r) in fp32; the top k experts by
    s + ``expert_bias`` (the bias picks, it does not weigh); the weights
    are the chosen s, divided by their sum (+1e-20) under ``route_norm``,
    times ``route_scale``. Returns (s (T, E), weights (T, K), ids (T, K))."""
    with obs.profiled_span("moe.route"):
        scores = torch.sigmoid(x.float() @ p["router"])           # (T, E)
        _, ids = top_k(scores + p["expert_bias"], cfg.top_k)
        gates = scores.gather(-1, ids)
        if cfg.route_norm:
            gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
        if cfg.route_scale != 1.0:
            gates = gates * cfg.route_scale
    return scores, gates, ids


def _shared_expert(x: torch.Tensor, p) -> torch.Tensor:
    """The shared expert's SwiGLU over every row, in x's dtype."""
    with obs.profiled_span("moe.shared_expert"):
        h = F.silu(x @ p["sh_gate"]) * (x @ p["sh_up"])
        return h @ p["sh_down"]


_ROW_AXES = ("pod", "data")


def _moe_ffn_meshed(x, p, cfg: MoEConfig, capacity: Optional[int],
                    rec: Optional[obs.DeviceRecorder], with_aux: bool):
    """``moe_ffn`` on a ``DTensor`` x (T, d) and ``DTensor`` weights: the
    expert-parallel layer of the module's docstring. Returns y (T, d) at
    x's row placement (a partial sum over the expert axis that does not
    split the rows, or split by d over ``model``) and the aux loss
    replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if dp.data_group() is not None:
        raise NotImplementedError("a meshed MoE layer under data_parallel")
    if cfg.score_func != "softmax" or cfg.shared_expert_width:
        raise NotImplementedError("a meshed MoE layer with a sigmoid router "
                                  "or a shared expert")
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    big = {a for a, n in zip(names, mesh.shape) if n > 1}
    row_pl = tuple(a for a in tp.split_axes(x, 0) if a in _ROW_AXES)
    x = tp.keep_shards(x, row_pl)
    rows = tuple(a for a in row_pl if a in big)    # those with collectives
    T_all, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    if capacity is None:
        capacity = moe_capacity(T_all, cfg)
    capacity = min(capacity, T_all * K)

    # the experts' own shards kept (and model's), the FSDP dims gathered
    w = {k: tp.keep_shards(p[k], tp.split_axes(p[k], 0) + ("model",))
         for k in ("e_gate", "e_up", "e_down")}
    e_axes = tp.split_axes(w["e_gate"], 0)
    d_axes = tp.split_axes(w["e_gate"], 1)
    if (len(e_axes) > 1 or set(d_axes) - {"model"}
            or w["e_up"].placements != w["e_gate"].placements
            or tp.split_axes(w["e_gate"], 2)
            or tp.split_axes(w["e_down"], 0) != e_axes
            or tp.split_axes(w["e_down"], 1)
            or tp.split_axes(w["e_down"], 2) != d_axes):
        raise NotImplementedError(
            f"expert weights at {w['e_gate'].placements} / "
            f"{w['e_down'].placements}: experts over one axis, d over "
            "model, f whole")
    e_axes = tuple(a for a in e_axes if a in big)
    d_axes = tuple(a for a in d_axes if a in big)
    cap_axes = tuple(a for a in names if a in big and a not in e_axes
                     and a not in d_axes)
    own = tuple(a for a in e_axes if a not in rows)  # own experts written
    R = Replicate()

    xl = x.to_local()
    router = tp.keep_shards(p["router"], ()).to_local(grad_placements=[
        Partial() if a in row_pl else R for a in names])
    wl = {k: v.to_local(grad_placements=[
        Partial() if a in cap_axes else pl
        for a, pl in zip(names, v.placements)]) for k, v in w.items()}
    T = xl.shape[0]

    # routing: every rank of the expert and d axes alike
    probs = torch.softmax(xl.float() @ router, dim=-1)            # (T, E)
    gates, ids = top_k(probs, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    aux = None
    if with_aux:
        me = tp.SumOver.apply(probs.sum(dim=0), mesh, rows, False) / T_all
        ce = tp.SumOver.apply(F.one_hot(ids[:, 0], E).float().sum(dim=0),
                              mesh, rows, False) / T_all
        aux = DTensor.from_local(E * (me * ce).sum() * cfg.aux_loss_weight,
                                 mesh, [R] * len(names), run_check=False)

    flat = ids.reshape(-1)                                        # (T*K,)
    onehot = F.one_hot(flat, E)
    pos = (onehot.cumsum(dim=0) - 1).mul_(onehot).sum(dim=1)
    pos = pos + tp.rows_before(onehot.sum(dim=0), mesh, rows)[flat]
    keep = pos < capacity
    if rec is not None:
        rec.inc("moe/dispatched_slots", keep.sum(dtype=torch.float32))
        rec.inc("moe/routed_slots", T * K)
    e0, n_e = tp.local_range(w["e_gate"], 0)
    lo, n_w = (e0, n_e) if own else (0, E)
    mine = keep & (flat >= lo) & (flat < lo + n_w) if own else keep
    e_idx = torch.where(mine, flat - lo, 0)
    row = torch.where(mine, pos, capacity)                        # trash row
    d0, n_d = tp.local_range(w["e_gate"], 1)

    # x and the gates serve other experts' (or d's) work on each rank of
    # these axes: their gradients are summed over them
    xd = tp.SumGrad.apply(xl, mesh, own + d_axes).narrow(1, d0, n_d)
    gates = tp.SumGrad.apply(gates, mesh, own + d_axes)
    xe = xl.new_zeros((n_w, capacity + 1, n_d))
    xe[e_idx, row] = xd[:, None].expand(T, K, n_d).reshape(T * K, n_d)
    xe = xe[:, :capacity]

    # dispatch: the experts and the capacity rows split in mesh order
    steps = []
    for a in names:
        if a in e_axes and a in rows:
            dim = 0
            xe_next = tp.ScatterSum.apply(xe, 0, mesh, a)
        elif a in cap_axes:
            dim = 1
            xe_next = (tp.ScatterSum.apply(xe, 1, mesh, a) if a in rows
                       else tp.Piece.apply(xe, 1, mesh, a))
        else:
            continue
        steps.append((a, dim, xe.shape[dim]))
        xe = xe_next

    g, u, dn = wl["e_gate"], wl["e_up"], wl["e_down"]
    if xe.shape[0] != g.shape[0] or xe.shape[2] != g.shape[1]:
        raise ValueError(f"expert batch {tuple(xe.shape)} against weights "
                         f"{tuple(g.shape)}")
    hg, hu = torch.bmm(xe, g), torch.bmm(xe, u)
    if d_axes:                            # partial sums over the d slices
        f = hg.shape[-1]
        hg, hu = tp.SumOver.apply(torch.cat([hg, hu], dim=-1), mesh,
                                  d_axes, True).split(f, dim=-1)
    ye = torch.bmm(F.silu(hg) * hu, dn)

    # combine: gathered back in the opposite order
    for a, dim, total in reversed(steps):
        ye = tp.Gather.apply(ye, dim, mesh, a, total, a in rows)
    ye = F.pad(ye, (0, 0, 0, 1))                                  # trash: 0
    y_slots = ye[e_idx, row]                                      # (T*K, n_d)
    y = (y_slots.view(T, K, n_d) * gates[..., None].to(x.dtype)).sum(dim=1)
    out = [Shard(0) if a in row_pl else Partial() if a in own else
           Shard(1) if a in d_axes else R for a in names]
    y = DTensor.from_local(y.to(x.dtype), mesh, out, run_check=False,
                           shape=x.shape, stride=x.stride())
    return y, aux
