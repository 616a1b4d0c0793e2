"""Host time of the MoE FFN per profiled decode step, in ms: the self
time of the ``moe_ffn`` spans inside each decode step the benchmark
profiles (profiler cost included)."""
from moska_bench import program_spans as ps


def read(rec):
    return ps.profiled_self_ms("moe_ffn")
