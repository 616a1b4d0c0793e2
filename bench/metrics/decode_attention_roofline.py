"""``decode_attention``'s roofline share in the profiled waves, in %: the
summed least time of its calls (from the frozen ``work.py`` and each
call's cached tokens attended) over the device time of its kernel."""
KERNELS = ("decode_slab_kernel",)


def read(rec):
    if rec.trace is None or rec.counts is None:
        return None
    bound = rec.counts.bound_s("decode_attention")
    spent = rec.trace.kernel_s(*KERNELS)
    if bound is None or spent <= 0:
        return None
    return 100.0 * bound / spent
