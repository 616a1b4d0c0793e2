"""Mean host time to enqueue a decode step, in ms: the ``engine.decode``
span (the step's token upload and the call into the model, which
launches its kernels without waiting for them) of every wave that starts
in the window."""
from moska_bench import program_spans as ps


def read(rec):
    v = ps.mean([s.duration_s for s in ps.in_window(
        rec.window, ps.spans().named(ps.DECODE))])
    return None if v is None else v * 1e3
