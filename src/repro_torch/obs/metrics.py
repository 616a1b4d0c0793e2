"""Process-global metrics: counters, gauges, histograms.

Plain Python code (scheduler, engine loop) records directly on the
registry. Values computed on the device during a step (dispatch density,
dispatched and dropped routes) are queued on a
:class:`DeviceRecorder` as device tensors and read back in one transfer
per wave, after the token readback, so recording never adds a device sync
inside the layer loop.

This module has no torch import at module level: the scheduler and
exporters stay importable in dependency-free contexts.
"""
from __future__ import annotations

import bisect
import collections
import threading
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

Number = Union[int, float]

# ---------------------------------------------------------------------------
# bucket-edge conventions (documented in README "Metrics & tracing")
# ---------------------------------------------------------------------------

#: wall-clock latencies in seconds: log-ish spaced 100us .. 10s
LATENCY_EDGES_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: ratios in [0, 1] (occupancy, capacity utilization, batch density)
FRACTION_EDGES: Tuple[float, ...] = tuple(i / 10.0 for i in range(1, 11))

#: small integer counts (wave sizes, chunks, drops): powers of two
COUNT_EDGES: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

#: transfer sizes in bytes (host-tier page offload / swap-in payloads):
#: powers of four from 1 KiB to 1 GiB
BYTES_EDGES: Tuple[float, ...] = tuple(float((4 ** i) * 1024)
                                       for i in range(11))

DEFAULT_EDGES = LATENCY_EDGES_S

#: finished spans a registry keeps, the newest: a traced benchmark run of
#: the cell with the most waves records about 5,100 of them (PERF.md §6),
#: so one run's spans are all kept while a long-lived server's memory
#: stays bounded
SPAN_CAPACITY = 1 << 16


class Counter:
    """Monotonic cumulative counter."""

    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: Number = 1) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        self.value += float(v)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (also tracks min/max seen)."""

    kind = "gauge"
    __slots__ = ("name", "value", "min", "max", "updates")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.updates = 0

    def set(self, v: Number) -> None:
        v = float(v)
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.updates += 1

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value, "min": self.min,
                "max": self.max, "updates": self.updates}


class Histogram:
    """Fixed-bucket histogram.

    ``edges`` are upper bounds: bucket ``i`` counts observations
    ``v <= edges[i]`` (and ``> edges[i-1]``); one implicit overflow bucket
    counts ``v > edges[-1]``. Non-cumulative counts; ``counts`` has
    ``len(edges) + 1`` entries.
    """

    kind = "histogram"
    __slots__ = ("name", "edges", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, edges: Sequence[Number] = DEFAULT_EDGES):
        if not edges or list(edges) != sorted(set(float(e) for e in edges)):
            raise ValueError(
                f"histogram {name}: edges must be strictly increasing "
                f"and non-empty, got {edges!r}")
        self.name = name
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: Number) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile: upper edge of the bucket holding rank q."""
        if not self.count:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c:
                return (self.edges[i] if i < len(self.edges)
                        else (self.max if self.max is not None else 0.0))
        return self.max if self.max is not None else 0.0

    def snapshot(self) -> dict:
        return {"kind": self.kind, "edges": list(self.edges),
                "counts": list(self.counts), "count": self.count,
                "sum": self.sum, "min": self.min, "max": self.max,
                "mean": self.mean}


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Named metrics + completed trace spans. Thread-safe get-or-create.
    ``spans`` keeps the newest ``SPAN_CAPACITY`` spans, dropping the
    oldest."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}
        # trace.Span, appended by trace.py
        self.spans: Deque[object] = collections.deque(maxlen=SPAN_CAPACITY)

    # -- get-or-create ---------------------------------------------------
    def _get(self, name: str, cls, *args) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a {m.kind}, "
                                f"not a {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Sequence[Number] = DEFAULT_EDGES) -> Histogram:
        return self._get(name, Histogram, edges)

    # -- convenience -----------------------------------------------------
    def inc(self, name: str, v: Number = 1) -> None:
        self.counter(name).inc(v)

    def set_gauge(self, name: str, v: Number) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: Number,
                edges: Sequence[Number] = DEFAULT_EDGES) -> None:
        self.histogram(name, edges).observe(v)

    # -- introspection ---------------------------------------------------
    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {n: m.snapshot() for n, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self.spans.clear()


# ---------------------------------------------------------------------------
# process-global registry
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _global_registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests / isolated benches).
    Returns the previous registry."""
    global _global_registry
    with _global_lock:
        prev, _global_registry = _global_registry, reg
        return prev


def reset_registry() -> None:
    _global_registry.reset()


# ---------------------------------------------------------------------------
# device-side recording, read back once per wave
# ---------------------------------------------------------------------------

class DeviceRecorder:
    """Queue of metric records whose values are 0-d device tensors.

    ``inc``/``observe`` only keep a reference to the tensor (no sync);
    ``flush`` stacks every pending tensor, copies them to the host in one
    transfer and applies every value to a registry in the order they were
    queued. A value that is a host number is applied as it is.
    """

    def __init__(self):
        self._pending: List[tuple] = []

    def __len__(self) -> int:
        return len(self._pending)

    def inc(self, name: str, value) -> None:
        self._pending.append(("inc", name, None, value))

    def observe(self, name: str, value,
                edges: Sequence[Number] = DEFAULT_EDGES) -> None:
        self._pending.append(("observe", name, tuple(edges), value))

    def flush(self, reg: Optional[MetricsRegistry] = None) -> None:
        if not self._pending:
            return
        import torch
        reg = reg if reg is not None else get_registry()
        pending, self._pending = self._pending, []
        dev = [v for _, _, _, v in pending if isinstance(v, torch.Tensor)]
        host = iter(torch.stack([v.float().reshape(()) for v in dev]).tolist()
                    if dev else ())
        vals = [next(host) if isinstance(v, torch.Tensor) else v
                for _, _, _, v in pending]
        for (kind, name, edges, _), v in zip(pending, vals):
            if kind == "inc":
                reg.inc(name, v)
            else:
                reg.observe(name, v, edges)
