"""``shared_tail_attention``'s roofline share in the profiled waves, in %:
the summed least time of its calls over the device time of its kernel.

A call's work: the tail's K and V read once, each row's q, out, lse and
first moved once, and 4 x head_dim operations for each visible (row,
head, tail key) triple. The program counts them once a model call,
summed over its sliding layers' calls (``moska/tail_calls``,
``tail_kv_rows``, ``tail_query_rows`` on the host, ``tail_keys`` on the
device), and the serving engine keeps each call's totals on the span open
when it reads them: an admission's ``engine.prefill``, a wave's
``engine.record``. Within one model call every layer's call has the same
rows and the same first keys, so a call's least time is the totals'
operations at the bf16 peak or bytes at the HBM peak, whichever is
longer. A program without the kernel or the counts leaves nothing to
read: None."""
from moska_bench import peaks
from moska_bench import program_spans as ps

KERNELS = ("shared_tail_mma_kernel",)


def _bound_s(attrs: dict, m: dict) -> float:
    H, KH, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    ops = 4.0 * D * H * attrs["moska/tail_keys"]
    nbytes = (2 * attrs["moska/tail_kv_rows"] * KH * D * 2
              + attrs["moska/tail_query_rows"] * (2 * H * D * 2 + H * 4 + 4))
    return peaks.bound_s(ops, nbytes)


def read(rec):
    if rec.trace is None:
        return None
    sp = ps.spans()
    steps = sp.profiled_steps()
    waves = [w for w in sp.named(ps.WAVE)
             if any(w.start_s <= s.start_s and s.end_s <= w.end_s
                    for s in steps)]
    calls = [s for w in waves
             for s in sp.inside(w, "engine.prefill", "engine.record")
             if s.attrs.get("moska/tail_calls")]
    spent = rec.trace.kernel_s(*KERNELS)
    if not calls or spent <= 0:
        return None
    return 100.0 * sum(_bound_s(s.attrs, rec.model) for s in calls) / spent
