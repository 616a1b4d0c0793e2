"""Mean host time of a wave's own bookkeeping, in ms: over the waves that
start in the window, the ``engine.wave`` span less its ``engine.prefill``,
``engine.decode``, ``engine.readback`` and ``engine.hooks`` children. What
is left is the schedule, the token and metric records, and the glue
between the phases."""
from moska_bench import program_spans as ps

OUT = ("engine.prefill", ps.DECODE, "engine.readback", "engine.hooks")


def read(rec):
    sp = ps.spans()
    v = ps.mean([w.duration_s - sum(c.duration_s
                                    for c in sp.children(w, *OUT))
                 for w in ps.in_window(rec.window, sp.named(ps.WAVE))])
    return None if v is None else v * 1e3
