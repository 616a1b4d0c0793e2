"""Host time of the afmoe layers' own work per profiled decode step, in ms:
the self time of the ``layer.shared_tail`` (a sliding layer's tail call
and its merge), ``moe.route`` (sigmoid scores, biased top-k, normalise,
scale), ``moe.shared_expert`` and ``moe_ffn`` spans inside each decode
step the benchmark profiles (profiler cost included)."""
from moska_bench import program_spans as ps


def read(rec):
    return ps.profiled_self_ms("layer.shared_tail", "moe.route",
                               "moe.shared_expert", "moe_ffn")
