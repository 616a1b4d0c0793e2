"""``shared_chunk_attention``'s roofline share in the profiled waves, in %:
the summed least time of its calls (operations at the bf16 peak or bytes
at the HBM peak, from the frozen ``work.py`` and each call's dispatched
pairs and active chunks) over the device time of its kernels."""
KERNELS = ("shared_chunk_mma_kernel", "shared_chunk_attn_kernel")


def read(rec):
    if rec.trace is None or rec.counts is None:
        return None
    bound = rec.counts.bound_s("shared_chunk_attention")
    spent = rec.trace.kernel_s(*KERNELS)
    if bound is None or spent <= 0:
        return None
    return 100.0 * bound / spent
