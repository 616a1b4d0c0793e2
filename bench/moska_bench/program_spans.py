"""The program's own spans, read from the registry of ``repro_torch.obs``
after a run.

The engine records an ``engine.*`` span for each phase of every wave
(always on); while a profiler runs, the model step records a span for
each of its layers' parts (``layer``, ``layer.route``, ... ``moe_ffn``,
``unembed``). A program without them leaves the readers nothing to read:
each returns None, and the metric is left out of the result.

"Profiled" readers take the waves the benchmark profiles, so they include
the profiler's own cost on the host.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional

WAVE = "engine.wave"
DECODE = "engine.decode"


def registry():
    from repro_torch import obs
    return obs.get_registry()


class Spans:
    """The registry's spans sorted by start, for containment queries."""

    def __init__(self, spans: Iterable):
        self.all = sorted(spans, key=lambda s: s.start_s)
        self._starts = [s.start_s for s in self.all]

    def named(self, *names: str) -> List:
        return [s for s in self.all if s.name in names]

    def inside(self, outer, *names: str) -> List:
        """Spans that start and end inside ``outer`` (itself excluded),
        of ``names`` if given."""
        lo = bisect.bisect_left(self._starts, outer.start_s)
        hi = bisect.bisect_right(self._starts, outer.end_s)
        return [s for s in self.all[lo:hi] if s is not outer
                and s.end_s <= outer.end_s and (not names or s.name in names)]

    def children(self, outer, *names: str) -> List:
        return [s for s in self.inside(outer, *names)
                if s.depth == outer.depth + 1]

    def self_s(self, sp) -> float:
        """``sp``'s time less its direct children's."""
        return sp.duration_s - sum(c.duration_s for c in self.children(sp))

    def profiled_steps(self) -> List:
        """The decode steps that ran under the profiler: those holding
        layer spans."""
        return [s for s in self.named(DECODE) if self.inside(s, "layer")]


def spans() -> Spans:
    return Spans(registry().spans)


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def in_window(window, sps: List) -> List:
    return [s for s in sps if window.holds(s.start_s)]


def profiled_self_ms(*names: str) -> Optional[float]:
    """Host time of the spans ``names`` inside each profiled decode step,
    each less its children, summed, as a mean per step in ms."""
    sp = spans()
    steps = sp.profiled_steps()
    if not steps:
        return None
    total = sum(sp.self_s(s) for step in steps
                for s in sp.inside(step, *names))
    return 1e3 * total / len(steps)
