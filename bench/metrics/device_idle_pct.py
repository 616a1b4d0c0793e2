"""Share of the profiled window in which no device operation ran, in %:
one minus the union of every kernel, copy and set interval from
``torch.profiler`` over the window's length."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
