"""Cost model of one rank's eager program: the port's counterpart of the
reference's ``launch/hlo_cost.py``.

The reference parses the optimized HLO of the compiled per-device program;
the port has no compiled program, so ``OpCounter`` (a
``TorchDispatchMode``) watches the aten ops one rank runs, on real or
fake tensors, and counts:

  flops       ``torch.utils.flop_counter``'s formulas of the products
              (mm, bmm, addmm, baddbmm, convolution, SDPA) at their local
              shapes, plus each hand-written kernel's count
              (``kernels/work.py``), which its wrapper reports
  traffic     operand and output bytes of the reference's anchors: the
              products' operands and outputs, the gathers' and
              reductions' outputs (index, gather, embedding, sum, amax,
              cat, pad), twice the update of an in-place write (copy_,
              index_put_, scatter), every collective's output, and each
              kernel's bytes; elementwise traffic rides along unseen
  collective  output bytes of every collective, by kind: the functional
              collectives (``_c10d_functional``) that DTensor runs and
              the c10d ops that the port calls itself
              (``core/disagg.py``'s all-reduces and all-gathers)
  peak        the high water of live storage bytes during the trace, the
              tensors handed to ``track`` (the arguments) included: the
              counterpart of the compiled program's ``memory_analysis``

An eager trace runs a loop's body as many times as the loop does, so the
reference's trip-count machinery (XLA counts a ``while`` body once) has
no counterpart here. Its trap has one instead: a ``DTensor`` op runs its
sharding propagation on fake tensors of the *global* shapes before the
local op, and a plain dispatch mode counts both (``FlopCounterMode`` over
a tensor-parallel product counts the global product). The counter lets
every ``DTensor`` op through to the subclass (the local ops, the
redistributions' collectives and the propagation's runs then reach it),
and skips what runs inside the propagator's own entry
(``ShardingPropagator._propagate_tensor_meta_non_cached``), which it wraps
while it is active.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

@dataclass
class Cost:
    flops: float = 0.0
    traffic: float = 0.0
    collective: float = 0.0
    per_collective: Dict[str, float] = field(default_factory=dict)

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.traffic += o.traffic
        self.collective += o.collective
        for k, v in o.per_collective.items():
            self.per_collective[k] = self.per_collective.get(k, 0.0) + v
        return self


aten = torch.ops.aten
_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution,
         aten._scaled_dot_product_efficient_attention,
         aten._scaled_dot_product_flash_attention,
         aten._scaled_dot_product_cudnn_attention}
_OUTPUT_ANCHORS = {aten.index, aten.gather, aten.embedding, aten.index_select,
                   aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
                   aten.min, aten.logsumexp, aten.var, aten.var_mean,
                   aten.cat, aten.constant_pad_nd, aten.cumsum, aten.sort,
                   aten.topk}
# in-place writes: (op, index of the update among the arguments)
_WRITES = {aten.copy_: 1, aten.index_put_: 2, aten.index_put: 2,
           aten.scatter_: 3, aten.scatter: 3, aten.scatter_add_: 3,
           aten.scatter_add: 3, aten.slice_scatter: 1,
           aten.select_scatter: 1}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}


def _tensors(x) -> Iterable[torch.Tensor]:
    """The tensors in a tree of lists, tuples (named ones too), dicts and
    modules (their parameters)."""
    from torch import nn
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, nn.Module):
        yield from x.parameters()
    elif isinstance(x, dict):
        yield from _tensors(list(x.values()))
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class OpCounter(TorchDispatchMode):
    """Counts one rank's flops, traffic, collectives and peak live bytes
    (see the module's docstring). ``with OpCounter() as c: ...`` then
    ``c.cost`` and ``c.peak``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, weakref.ref] = {}
        self._patch = None
        self._propagating = 0         # depth inside the propagator

    # -- live storage ---------------------------------------------------
    def track(self, *trees) -> None:
        """Count the storages of the tensors in ``trees`` (``DTensor``: its
        local shard) as live until they are freed."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(list(trees)):
            if isinstance(t, DTensor):
                t = t._local_tensor
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            size = st.nbytes()

            def gone(_, key=key, size=size):
                self._seen.pop(key, None)
                self.live -= size
            self._seen[key] = weakref.ref(st, gone)
            self.live += size
            self.peak = max(self.peak, self.live)

    # -- kernels ------------------------------------------------------------
    def _kernel(self, name: str, flops: float, byts: float) -> None:
        self.cost += Cost(flops=flops, traffic=byts)

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        cls = ShardingPropagator
        orig = cls._propagate_tensor_meta_non_cached

        def propagate(*args, **kwargs):
            self._propagating += 1
            try:
                return orig(*args, **kwargs)
            finally:
                self._propagating -= 1
        cls._propagate_tensor_meta_non_cached = propagate
        self._patch = (cls, orig)
        work._listeners.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._patch
        cls._propagate_tensor_meta_non_cached = orig
        work._listeners.remove(self._kernel)
        return super().__exit__(*exc)

    # -- ops --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        self._count(func, args, kwargs, out)
        self.track(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d"):
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is None:
                return
            # the output buffers: the functional ops return them; the c10d
            # ops write into their first argument (an all-reduce in place)
            b = float(_bytes(out if ns == "_c10d_functional" else args[0]))
            self.cost += Cost(traffic=b, collective=b,
                              per_collective={kind: b})
            return
        if packet in _DOTS:
            f = flop_registry.get(packet)
            flops = float(f(*args, **kwargs, out_val=out)) if f else 0.0
            self.cost += Cost(flops=flops,
                              traffic=float(_bytes(args) + _bytes(out)))
        elif packet in _OUTPUT_ANCHORS:
            self.cost += Cost(traffic=float(_bytes(out)))
        elif packet in _WRITES and len(args) > _WRITES[packet]:
            self.cost += Cost(traffic=2.0 * _bytes(args[_WRITES[packet]]))


def analyze_ops(fn: Callable, *args, **kwargs) -> Tuple[Cost, float]:
    """(``Cost``, peak live bytes) of one call ``fn(*args, **kwargs)``, the
    arguments' storages counted live from the start."""
    with OpCounter() as counter:
        counter.track(args, kwargs)
        fn(*args, **kwargs)
    return counter.cost, float(counter.peak)
