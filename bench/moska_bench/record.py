"""What a run leaves for the metric readers, and the readers themselves.

Every metric, end-to-end or per-layer, is a file ``bench/metrics/<name>.py``
with one function ``read(rec) -> float | None``. The harness finds it by
the metric's name in ``BENCHMARK.json``; a reader that finds nothing to
read returns None and the metric is left out of the result.
"""
from __future__ import annotations

import importlib.util
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

from moska_bench.stats import RequestLog, Window


@dataclass
class RunRecord:
    cell: str
    model: dict
    max_slots: int
    window: Window
    logs: List[RequestLog]
    setup_s: float
    peak_bytes: int
    model_flops: float
    #: engine histogram (sum, count) gained in the window, by name
    hist: Dict[str, Tuple[float, int]]
    #: the engine's decode-step wall times in the window
    decode_step_s: List[float]
    corpus_register_s: Optional[float] = None
    trace: object = None            # trace.TraceResult of a traced run
    counts: object = None           # trace.KernelCounts of a traced run

    def hist_mean(self, name: str) -> Optional[float]:
        s, n = self.hist.get(name, (0.0, 0))
        return s / n if n else None


def load_module(path: Path, prefix: str) -> ModuleType:
    """The Python file ``path``, loaded by its path under a name of its
    own (in ``sys.modules``, as ``dataclasses`` needs): the harness finds
    metric readers, architectures and counted kernels by file."""
    name = prefix + "".join(c if c.isalnum() else "_" for c in str(
        Path(path).resolve().with_suffix("")))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metrics_dir: Path, name: str) -> Callable[[RunRecord], object]:
    path = Path(metrics_dir) / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    return load_module(path, "bench_metric_").read
