"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full 700 W power limit): the denominators of every roofline and MFU
share the benchmark reports."""

BF16_FLOPS = 989e12          # dense bf16 / fp16 tensor-core FLOP/s
FP32_FLOPS = 67e12           # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12        # HBM3 bandwidth


def bound_s(flops: float, nbytes: float, fp32: bool = False) -> float:
    """The least time the card could take: operations at the peak rate or
    bytes at the peak bandwidth, whichever is longer."""
    return max(flops / (FP32_FLOPS if fp32 else BF16_FLOPS),
               nbytes / HBM_BYTES_S)
