"""Host time of MoSKA's shared path per profiled decode step, in ms: the
self time of the ``layer.route``, ``layer.dispatch``,
``layer.shared_attention`` and ``layer.merge`` spans inside each decode
step the benchmark profiles (profiler cost included)."""
from moska_bench import program_spans as ps


def read(rec):
    return ps.profiled_self_ms("layer.route", "layer.dispatch",
                               "layer.shared_attention", "layer.merge")
