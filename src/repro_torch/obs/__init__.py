"""Serving-path observability: metrics registry, trace spans, exporters.

  metrics   process-global MetricsRegistry (counters/gauges/histograms)
            + DeviceRecorder for values computed on the device
  trace     span() context manager with per-thread parent nesting
  export    JSON (round-trippable) and line-protocol dumps
"""
from repro_torch.obs.export import (  # noqa: F401
    StreamingExporter, dump, from_dict, load, to_dict, to_json, to_lines,
)
from repro_torch.obs.metrics import (  # noqa: F401
    BYTES_EDGES, COUNT_EDGES, FRACTION_EDGES, LATENCY_EDGES_S,
    Counter, DeviceRecorder, Gauge, Histogram, MetricsRegistry,
    get_registry, reset_registry, set_registry,
)
from repro_torch.obs.trace import Span, current_span, span  # noqa: F401
