"""The traced run's instruments: a profiler window over a few waves, the
benchmark's own spans around the calls into each layer, and counts of the
data-dependent work of two kernels.

``Profiled`` runs ``torch.profiler`` (host and device activity) over the
waves it is opened around and reads the raw trace once it closes:

- busy: the union of every device operation's interval (kernels, copies,
  sets) inside the window, so overlapping operations count once;
- per device operation, its summed time;
- idle gaps: the stretches of the window with no device operation, each
  named by the innermost benchmark span (``bench.*``) the host was in at
  its middle.

``spans`` wraps the engine's model and scheduler calls in
``record_function`` ranges (traced runs only). ``KernelCounts`` wraps each
kernel of ``ops`` that a file of ``bench/counted/`` names (the model
reaches them as module attributes) and, while on, keeps each call's
shape-determined work from the frozen ``work.py`` and its data-dependent
counts on the device.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from moska_bench import peaks
from moska_bench.record import load_module

SPAN = "bench."
WINDOW = "bench.profiled_window"
#: ranges the program itself opens while a profiler runs: on the device's
#: timeline they are annotations, not work
PROGRAM_RANGES = ("moe_ffn",)
TOP = 10
#: the counted kernels, a file each
COUNTED = Path(__file__).resolve().parent.parent / "counted"


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_and_gaps(window: Tuple[int, int], iv: List[Tuple[int, int]]
                  ) -> Tuple[int, List[Tuple[int, int]]]:
    """Busy time of the union of ``iv`` clipped to ``window``, and the idle
    gaps between (all in the same integer unit)."""
    w0, w1 = window
    merged = _merge([(max(s, w0), min(e, w1)) for s, e in iv
                     if e > w0 and s < w1])
    busy = sum(e - s for s, e in merged)
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return busy, gaps


def innermost(spans: List[Tuple[int, int, str]], t: float) -> str:
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "bench.outside_spans"


@dataclass
class TraceResult:
    busy_s: float
    window_s: float
    op_s: Dict[str, float]
    idle_gaps: List[Tuple[str, float]]

    def kernel_s(self, *names: str) -> float:
        return sum(t for op, t in self.op_s.items()
                   if any(n in op for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:200], t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in self.idle_gaps[:TOP]]}


def read_trace(events) -> TraceResult:
    """Reduce the profiler's raw events to busy time, per-operation time
    and named idle gaps."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    spans: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for ev in events:
        name = ev.name()
        s, e = ev.start_ns(), ev.end_ns()
        note = ev.is_user_annotation() if hasattr(
            ev, "is_user_annotation") else False
        if ev.device_type() == cuda:
            if note or name.startswith(SPAN) or name in PROGRAM_RANGES:
                continue
            dev.append((s, e, name))
        elif name == WINDOW:
            window = (s, e)
        elif name.startswith(SPAN):
            spans.append((s, e, name))
    if window is None:
        raise RuntimeError("the profiled window's range is not in the trace")
    busy, gaps = busy_and_gaps(window, [(s, e) for s, e, _ in dev])
    op_s: Dict[str, float] = {}
    for s, e, name in dev:
        if e > window[0] and s < window[1]:
            op_s[name] = op_s.get(name, 0.0) + (e - s) / 1e9
    named = sorted(((innermost(spans, (a + b) / 2), (b - a) / 1e9)
                    for a, b in gaps), key=lambda g: -g[1])
    return TraceResult(busy / 1e9, (window[1] - window[0]) / 1e9, op_s,
                       named)


class Profiled:
    """``with Profiled() as p:`` profiles the block; ``p.result`` after."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._range = torch.profiler.record_function(WINDOW)
        self.result: Optional[TraceResult] = None

    def __enter__(self) -> "Profiled":
        self._prof.__enter__()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.result = read_trace(self._prof.profiler.kineto_results
                                     .events())


def _ranged(fn, name: str):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def spans(engine):
    """The engine's calls into the model and the scheduler, each in a
    ``bench.*`` range, for the length of the block."""
    model, sched = engine.model, engine.scheduler
    model.prefill = _ranged(model.prefill, "bench.prefill")
    model.decode_step = _ranged(model.decode_step, "bench.decode_step")
    sched.schedule = _ranged(sched.schedule, "bench.schedule")
    try:
        yield
    finally:
        for obj, name in ((model, "prefill"), (model, "decode_step"),
                          (sched, "schedule")):
            delattr(obj, name)


@dataclass
class _Calls:
    fixed: List[Tuple[float, float]] = field(default_factory=list)
    per: List[Tuple[Tuple[float, float], ...]] = field(default_factory=list)
    counts: List[torch.Tensor] = field(default_factory=list)


class KernelCounts:
    """While ``on``, each call's work: ``fixed`` (operations, bytes) plus
    the work per unit of each data-dependent count, with the counts kept
    on the device until ``bound_s`` reads them.

    One wrapper for each file ``<op>.py`` of ``counted`` (default
    ``bench/counted``), which declares ``OP``, the attribute of ``ops`` it
    wraps; ``work(*args, **kwargs)``, a call's fixed (operations, bytes)
    and the (operations, bytes) of one unit of each count, from the frozen
    ``work.py``; and ``counts(*args, **kwargs)``, the counts as one tensor
    on the call's device. ``calls`` and ``bound_s`` go by the file's name.
    """

    def __init__(self, ops, counted: Path = COUNTED):
        self.ops = ops
        self.on = False
        self.kernels = {p.stem: load_module(p, "bench_counted_")
                        for p in sorted(Path(counted).glob("*.py"))}
        self.calls: Dict[str, _Calls] = {n: _Calls() for n in self.kernels}
        self._orig: List[Tuple[str, object]] = []

    def install(self) -> None:
        """Put the counting wrappers in ``ops``' namespace. The kernels'
        wrappers count their own launches on the function the module name
        points to, so each stand-in carries the count and hands it back."""
        for name, k in self.kernels.items():
            orig = getattr(self.ops, k.OP)
            self._orig.append((k.OP, orig))

            def stand_in(*args, _f=orig, _k=k, _c=self.calls[name],
                         **kwargs):
                out = _f(*args, **kwargs)
                if self.on:
                    fixed, per = _k.work(*args, **kwargs)
                    _c.fixed.append(fixed)
                    _c.per.append(per)
                    _c.counts.append(_k.counts(*args, **kwargs))
                return out
            stand_in.launches = orig.launches
            setattr(self.ops, k.OP, stand_in)

    def uninstall(self) -> None:
        for op, fn in reversed(self._orig):
            fn.launches = getattr(self.ops, op).launches
            setattr(self.ops, op, fn)
        self._orig.clear()

    def bound_s(self, name: str) -> Optional[float]:
        """Sum over the recorded calls of each call's least time on the
        card; None if there were none."""
        c = self.calls[name]
        if not c.fixed:
            return None
        counts = torch.stack(c.counts).cpu().tolist()
        total = 0.0
        for (fl, by), per, n in zip(c.fixed, c.per, counts):
            for (dfl, dby), x in zip(per, n):
                fl, by = fl + dfl * x, by + dby * x
            total += peaks.bound_s(fl, by)
        return total
