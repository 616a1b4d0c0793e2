"""Mean time a request waited before its prefill began, in ms: the
``queued_s`` (the ``engine.prefill`` span's start minus the request's
submit time) of every ``engine.prefill`` span that starts in the window."""
from moska_bench import program_spans as ps


def read(rec):
    got = [s.attrs["queued_s"] for s in ps.in_window(
        rec.window, ps.spans().named("engine.prefill"))
        if "queued_s" in s.attrs]
    v = ps.mean(got)
    return None if v is None else v * 1e3
