"""Wall-clock trace spans with parent nesting.

``span("engine.decode_step", wave=3)`` measures a wall-clock interval and
records it — with its parent span and nesting depth — into the active
:class:`~repro_torch.obs.metrics.MetricsRegistry`. Spans are host-side only (they
time Python control flow, not device execution); wrap the device sync point
(``.cpu()`` / ``torch.cuda.synchronize()``) inside the span to capture device
time. Nesting is tracked per thread.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Union

from repro_torch.obs import metrics as M


@dataclass
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


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Optional[Span]:
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def span(name: str, registry: Optional[M.MetricsRegistry] = None,
         record_histogram: bool = True,
         **attrs: Union[int, float, str]) -> Iterator[Span]:
    """Context manager: times the block, appends the finished Span to the
    registry, and (by default) also feeds ``span/<name>/duration_s`` into a
    latency histogram so spans aggregate without post-processing."""
    reg = registry if registry is not None else M.get_registry()
    st = _stack()
    parent = st[-1].name if st else None
    sp = Span(name, time.perf_counter(), parent=parent, depth=len(st),
              attrs=dict(attrs))
    st.append(sp)
    try:
        yield sp
    finally:
        sp.end_s = time.perf_counter()
        st.pop()
        reg.spans.append(sp)
        if record_histogram:
            reg.observe(f"span/{name}/duration_s", sp.duration_s,
                        M.LATENCY_EDGES_S)
