"""Wall-clock trace spans with parent nesting, mirrored as profiler ranges.

``span("engine.wave")`` measures a wall-clock interval and records it —
with its parent span, nesting depth and attributes — into the active
:class:`~repro_torch.obs.metrics.MetricsRegistry`, and by default feeds
``span/<name>/duration_s``. Such spans are always on: the engine opens a
few of them a wave. While a torch profiler runs, a span also opens a
profiler range of the same name, so the profile holds it on the
profiler's own clock, above the operations launched inside it (a kernel
belongs to the range open at its launch, by the launch's correlation id).
The range is ``torch._C._profiler._RecordFunctionFast``: a host range
only, with no annotation on the device's timeline, at a small fraction of
``torch.profiler.record_function``'s host cost under the profiler.

``profiled_span("layer.route")`` is for the sites inside a model step,
which run many times a wave. While no profiler runs it returns one shared
null context: one cached check, and no clock read, allocation or record.
While one runs it is a span (range and registry record) without the
histogram.

Spans are host-side only (they time Python control flow, not device
execution): neither kind synchronizes or allocates on the device, so a
step stays capturable in a CUDA graph. Wrap the device sync point inside a
span to capture device time. Nesting is tracked per thread. torch is
imported on first use: the module imports without it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Union

from repro_torch.obs import metrics as M


@dataclass(slots=True)
class Span:
    name: str
    start_s: float                      # perf_counter timestamp
    end_s: float = 0.0
    parent: Optional[str] = None
    depth: int = 0
    attrs: Dict[str, Union[int, float, str]] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s

    def snapshot(self) -> dict:
        return {"name": self.name, "start_s": self.start_s,
                "end_s": self.end_s, "duration_s": self.duration_s,
                "parent": self.parent, "depth": self.depth,
                "attrs": dict(self.attrs)}


_tls = threading.local()
_NULL = contextlib.nullcontext()
#: torch's profiler check and range class, bound on first use (without
#: torch the check always answers False)
_enabled: Optional[Callable[[], bool]] = None
_range = None


def _bind() -> Callable[[], bool]:
    global _enabled, _range
    try:
        import torch
    except ImportError:
        _enabled = lambda: False    # noqa: E731
        return _enabled
    _range = torch._C._profiler._RecordFunctionFast
    _enabled = torch.autograd._profiler_enabled
    return _enabled


def profiling() -> bool:
    """Whether a torch profiler is running in this process."""
    return (_enabled or _bind())()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Optional[Span]:
    st = _stack()
    return st[-1] if st else None


class _Open:
    """One span's context: on entry it opens the profiler range (while a
    profiler runs) and pushes the span on the thread's stack; on exit,
    exception or not, it closes both and records the span."""

    __slots__ = ("span", "reg", "hist", "range")

    def __init__(self, name: str, reg: Optional[M.MetricsRegistry],
                 hist: bool, attrs: dict):
        self.span = Span(name, 0.0, attrs=attrs)
        self.reg, self.hist, self.range = reg, hist, None

    def __enter__(self) -> Span:
        sp, st = self.span, _stack()
        if self.reg is None:
            self.reg = M.get_registry()
        if profiling():
            self.range = _range(sp.name)
            self.range.__enter__()
        if st:
            sp.parent, sp.depth = st[-1].name, len(st)
        st.append(sp)
        sp.start_s = time.perf_counter()
        return sp

    def __exit__(self, *exc) -> None:
        sp = self.span
        sp.end_s = time.perf_counter()
        _stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.reg.spans.append(sp)
        if self.hist:
            self.reg.observe(f"span/{sp.name}/duration_s",
                             sp.duration_s, M.LATENCY_EDGES_S)


def span(name: str, registry: Optional[M.MetricsRegistry] = None,
         record_histogram: bool = True,
         **attrs: Union[int, float, str]) -> _Open:
    """Context manager: times the block, appends the finished Span to the
    registry, and (by default) also feeds ``span/<name>/duration_s`` into a
    latency histogram so spans aggregate without post-processing."""
    return _Open(name, registry, record_histogram, attrs)


def profiled_span(name: str):
    """A span (no histogram) while a profiler runs; otherwise the shared
    null context, so a site inside the model step costs one check."""
    if not (_enabled or _bind())():
        return _NULL
    return _Open(name, None, False, {})
