"""Share of the admissions' prefill attention calls that the
``flash_prefill_attention`` kernel took, in %: 100 x the ``attn_kernel_calls``
over the ``attn_calls`` of every ``engine.prefill`` span that starts in the
window (the engine's deltas of the registry counters
``attn/prefill_kernel_calls`` and ``attn/prefill_plain_calls``). A program
whose spans lack them leaves nothing to read."""
from moska_bench import program_spans as ps


def read(rec):
    sps = [s for s in ps.in_window(rec.window,
                                   ps.spans().named("engine.prefill"))
           if "attn_calls" in s.attrs]
    calls = sum(s.attrs["attn_calls"] for s in sps)
    if not calls:
        return None
    return 100.0 * sum(s.attrs["attn_kernel_calls"] for s in sps) / calls
