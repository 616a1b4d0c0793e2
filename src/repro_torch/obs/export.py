"""Exporters for the metrics registry: JSON and influx-style line protocol.

JSON is the round-trippable format (``to_dict`` / ``from_dict`` /
``dump`` / ``load``); line protocol is a one-way flat text dump for
grep/ingest pipelines. ``--metrics-out foo.json`` on the serving launcher
goes through :func:`dump`.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               get_registry)

SCHEMA_VERSION = 1


def to_dict(reg: Optional[MetricsRegistry] = None) -> dict:
    reg = reg if reg is not None else get_registry()
    return {
        "schema_version": SCHEMA_VERSION,
        "metrics": reg.snapshot(),
        "spans": [s.snapshot() for s in reg.spans],
    }


def to_json(reg: Optional[MetricsRegistry] = None, indent: int = 1) -> str:
    return json.dumps(to_dict(reg), indent=indent, sort_keys=True)


def from_dict(d: dict) -> MetricsRegistry:
    """Rebuild a registry from :func:`to_dict` output (exporter round-trip).
    Spans come back as plain Span objects with their recorded times."""
    from repro_torch.obs.trace import Span

    if d.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(f"unsupported metrics schema: "
                         f"{d.get('schema_version')!r}")
    reg = MetricsRegistry()
    for name, snap in d.get("metrics", {}).items():
        kind = snap.get("kind")
        if kind == "counter":
            reg.counter(name).value = float(snap["value"])
        elif kind == "gauge":
            g = reg.gauge(name)
            g.value = float(snap["value"])
            g.min, g.max = snap.get("min"), snap.get("max")
            g.updates = int(snap.get("updates", 0))
        elif kind == "histogram":
            h = reg.histogram(name, snap["edges"])
            h.counts = [int(c) for c in snap["counts"]]
            h.count = int(snap["count"])
            h.sum = float(snap["sum"])
            h.min, h.max = snap.get("min"), snap.get("max")
        else:
            raise ValueError(f"unknown metric kind {kind!r} for {name!r}")
    for s in d.get("spans", []):
        reg.spans.append(Span(s["name"], s["start_s"], s["end_s"],
                              s.get("parent"), s.get("depth", 0),
                              dict(s.get("attrs", {}))))
    return reg


def to_lines(reg: Optional[MetricsRegistry] = None) -> List[str]:
    """Flat line-protocol dump: ``name[,tag=v] field=value ...`` per line.
    Histograms expand to one ``le=<edge>`` line per bucket plus a summary
    line; spans emit ``span,name=<n>,parent=<p> duration_s=<d>``."""
    reg = reg if reg is not None else get_registry()
    lines: List[str] = []
    for name in reg.names():
        m = reg.get(name)
        key = name.replace(" ", "_")
        if isinstance(m, Counter):
            lines.append(f"{key} value={m.value}")
        elif isinstance(m, Gauge):
            lines.append(f"{key} value={m.value} min={m.min} max={m.max}")
        elif isinstance(m, Histogram):
            for edge, c in zip(m.edges, m.counts):
                lines.append(f"{key},le={edge} count={c}")
            lines.append(f"{key},le=+inf count={m.counts[-1]}")
            lines.append(f"{key} count={m.count} sum={m.sum} mean={m.mean}")
    for s in reg.spans:
        lines.append(f"span,name={s.name},parent={s.parent},depth={s.depth} "
                     f"duration_s={s.duration_s}")
    return lines


def dump(path: str, reg: Optional[MetricsRegistry] = None,
         atomic: bool = False) -> None:
    """Write the registry to ``path``: JSON unless the extension is
    ``.lp``/``.txt`` (line protocol). With ``atomic`` the body lands via
    a same-directory temp file + ``os.replace``, so a concurrent reader
    never sees a torn dump — the streaming exporter's mode."""
    if path.endswith((".lp", ".txt")):
        body = "\n".join(to_lines(reg)) + "\n"
    else:
        body = to_json(reg) + "\n"
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    target = f"{path}.tmp" if atomic else path
    with open(target, "w") as f:
        f.write(body)
    if atomic:
        os.replace(target, path)


class StreamingExporter:
    """Periodic registry flusher for long-running serves.

    ``tick()`` once per decode wave; every ``every``-th tick rewrites
    ``path`` with the current registry state (atomically, so a tailing
    reader never sees a torn file). The final ``flush()`` at exit is the
    caller's job — the launcher's ``--metrics-out`` dump doubles as it.

    Wired by ``launch/serve --metrics-flush-every N`` through the
    engine's ``wave_hooks`` (host-side callbacks at the end of each
    wave), so a stuck or hours-long serve is observable mid-flight
    instead of only post-mortem.
    """

    def __init__(self, path: str, every: int = 1,
                 reg: Optional[MetricsRegistry] = None):
        if every < 1:
            raise ValueError(f"flush interval must be >= 1, got {every}")
        self.path = path
        self.every = int(every)
        self._reg = reg
        self.ticks = 0
        self.flushes = 0

    def tick(self) -> bool:
        """Count one wave; flush when the interval elapses. Returns
        whether this tick flushed."""
        self.ticks += 1
        if self.ticks % self.every:
            return False
        self.flush()
        return True

    def flush(self) -> None:
        dump(self.path, self._reg, atomic=True)
        self.flushes += 1


def load(path: str) -> MetricsRegistry:
    with open(path) as f:
        return from_dict(json.load(f))
