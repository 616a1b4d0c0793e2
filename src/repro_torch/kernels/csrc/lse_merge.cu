// Exact LSE merge of P partial attentions for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lse_merge.py, function
// lse_merge (_kernel): lse is clamped at -1e30, m = max_p lse,
// w_p = exp(lse_p - m), out = sum_p w_p o_p / sum_p w_p and
// lse = m + log sum_p w_p (-1e30 where the sum is 0).
//
// What bounds it on the H100: HBM bytes (a few flops per element read).
// Its design: one thread per output element (n, h, d), consecutive threads
// on consecutive d, so every partial is read once with coalesced loads;
// the P weights of a row are recomputed by each of its D threads from the
// (small, cached) lse rows instead of being staged, and the thread of
// d = 0 writes the merged lse. Nothing is kept between partials in HBM.
#include "common.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

constexpr int kMergeThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    lse_merge_kernel(const T* __restrict__ outs, const float* __restrict__ lses,
                     T* __restrict__ out, float* __restrict__ lse, int P,
                     long NH, int D) {
  const long i = (long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= NH * D) return;
  const long nh = i / D;
  float m = kNegInf;
  for (int p = 0; p < P; ++p) m = fmaxf(m, fmaxf(lses[p * NH + nh], kNegInf));
  float den = 0.f, acc = 0.f;
  for (int p = 0; p < P; ++p) {
    const float w = expf(fmaxf(lses[p * NH + nh], kNegInf) - m);
    den += w;
    acc = fmaf(w, to_f(outs[p * NH * D + i]), acc);
  }
  out[i] = from_f<T>(acc / fmaxf(den, 1e-37f));
  if (i % D == 0) lse[nh] = den > 0.f ? m + logf(fmaxf(den, 1e-37f)) : kNegInf;
}

template <typename T>
cudaError_t launch(const void* outs, const void* lses, void* out, void* lse,
                   int P, long NH, int D, cudaStream_t stream) {
  const long n = NH * D;
  const long blocks = (n + kMergeThreads - 1) / kMergeThreads;
  if (blocks == 0) return cudaSuccess;
  lse_merge_kernel<T><<<(unsigned)blocks, kMergeThreads, 0, stream>>>(
      static_cast<const T*>(outs), static_cast<const float*>(lses),
      static_cast<T*>(out), static_cast<float*>(lse), P, NH, D);
  return cudaGetLastError();
}

}  // namespace
}  // namespace moska

// outs (P, N, H, D); lses (P, N, H) fp32 -> out (N, H, D) in the outs
// dtype, lse (N, H) fp32. NH = N * H.
extern "C" int moska_lse_merge(const void* outs, const void* lses, void* out,
                               void* lse, int P, long NH, int D, int dtype,
                               void* stream) {
  using namespace moska;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(outs, lses, out, lse, P, NH, D, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(outs, lses, out, lse, P, NH, D, st);
  return cudaErrorInvalidValue;
}
