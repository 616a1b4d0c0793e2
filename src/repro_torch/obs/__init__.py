"""Serving-path observability: metrics registry, trace spans, exporters.

  metrics   process-global MetricsRegistry (counters/gauges/histograms)
            + DeviceRecorder for values computed on the device
  trace     span() context manager with per-thread parent nesting, a
            profiler range while a profiler runs; profiled_span() for the
            model step's sites, a no-op without a profiler
  export    JSON (round-trippable) and line-protocol dumps
"""
from repro_torch.obs.export import (  # noqa: F401
    StreamingExporter, dump, from_dict, load, to_dict, to_json, to_lines,
)
from repro_torch.obs.metrics import (  # noqa: F401
    BYTES_EDGES, COUNT_EDGES, FRACTION_EDGES, LATENCY_EDGES_S,
    SPAN_CAPACITY, Counter, DeviceRecorder, Gauge, Histogram,
    MetricsRegistry, get_registry, reset_registry, set_registry,
)
from repro_torch.obs.trace import (  # noqa: F401
    Span, current_span, profiled_span, span,
)
