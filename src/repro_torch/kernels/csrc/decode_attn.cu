// Unique-KV decode attention (flash-decoding GEMV) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py, function
// decode_attention (_kernel): one new query per request attends to that
// request's own cache, positions [0, kv_len[b]); no sliding window.
//
// What bounds it on the H100: HBM bytes. Each cached K/V element is used
// by only the G query heads of its kv head (G = 8 for tinyllama), about
// 2 * G flops per byte, far under the card's ~295 flops/byte balance. Its
// design: one block per (kv head, request), so the G heads that share a
// kv head read each K/V element once; the loop stops at kv_len[b], so the
// bytes read follow each request's length and not max_seq. Loads are
// scalar and K/V pass through shared memory one 64-key tile at a time;
// vectorised loads, several tiles in flight and a split over S for short
// batches come in later versions.
#include "attn_tile.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ kv_len,
                       T* __restrict__ out, float* __restrict__ lse, int H,
                       int KH, int S, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH;  // rows of this block; the wrapper checks G <= kRows
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = max(0, min(kv_len[b], S));

  const TileSmem sm = carve_smem<D>(smem);
  const long q0 = ((long)b * H + (long)kh * G) * D;  // G heads x D, contiguous
  for (int i = tid; i < G * D; i += kThreads) sm.q[i] = to_f(q[q0 + i]);
  // attend_rows synchronises before it reads sm.q
  float acc[acc_per_thread<D>()];
  const long kv0 = (long)b * S * KH * D + (long)kh * D;
  const StridedKV<T> kv{k + kv0, v + kv0, (long)KH * D};
  attend_rows<D>(sm, G, kv, n, scale, acc);
  store_group_rows<T, D>(sm, G, acc, out + q0, lse + (long)b * H + kh * G);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* lse, int B, int H,
                   int KH, int S, cudaStream_t stream) {
  const int smem = attn_smem_floats<D>() * (int)sizeof(float);
  auto kern = decode_attn_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse), H, KH, S,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* kv_len, void* out, void* lse, int B, int H,
                       int KH, int S, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, kv_len, out, lse, B, H, KH, S, stream);
    case 32: return launch<T, 32>(q, k, v, kv_len, out, lse, B, H, KH, S, stream);
    case 64: return launch<T, 64>(q, k, v, kv_len, out, lse, B, H, KH, S, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, out, lse, B, H, KH, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace moska

// q (B, H, D); k, v (B, S, KH, D); kv_len (B,) int32;
// out (B, H, D) in the input dtype; lse (B, H) fp32.
extern "C" int moska_decode_attn(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* out, void* lse,
                                 int B, int H, int KH, int D, int S, int dtype,
                                 void* stream) {
  using namespace moska;
  if (H % KH || H / KH > kRows) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(D, q, k, v, kv_len, out, lse, B, H, KH, S, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, kv_len, out, lse, B, H, KH, S, st);
  return cudaErrorInvalidValue;
}
