// Unique-KV decode attention (split-KV GQA decode) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py, function
// decode_attention (_kernel): one new query per request attends to that
// request's own cache, positions [lo, kv_len[b]), in a slab (B, S, KH, D),
// where lo = max(0, kv_len[b] - window) with a sliding window and 0
// without one (window 0), the reference's mask.
//
// What bounds it on the H100: HBM bytes. Each cached K/V element is used
// by only the G query heads of its kv head (G = 8 for tinyllama), about
// 2 * G flops per byte, far under the card's ~295 flops/byte balance; at
// the decode step's shape the 17.8 MB of K/V take 5.3 us at 3.35 TB/s.
// The loop runs over the live 32-key tiles of [lo, kv_len[b]) only, so the
// bytes follow each request's length (or window) and not S.
//
// Its design (decode_tile.cuh): one block per (kv head, request, group of
// at most 8 heads), so the G heads that share a kv head read each K/V
// element once. The block's 4 warps split [lo, n) into 32-key tiles
// aligned to 0 (tiles wholly below lo skipped, keys below lo in the first
// one masked), tile t to warp t % 4; each warp streams its tiles through
// its own ring of 16-byte cp.async copies (2 stages at D 64 bf16, so two
// 75 KB blocks fit an SM), keeps K and V in bf16 in shared memory, and
// keeps its own online softmax. bf16 runs the products on tensor cores
// (mma.sync m16n8k16, keys on M, the 8 heads on N), fp32 on the CUDA
// cores. The 4 partials are merged in shared memory, warp 0 first, before
// the block writes out and lse: one launch, no scratch. The partition depends only on (lo, n),
// which is what keeps paged_decode_attn.cu, the same body with a page
// loader, equal to this kernel bit for bit on the same logical cache.
#include "decode_tile.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

// the 2-block minimum keeps ptxas from spilling (it spilled 4-8 bytes in
// some variants at 64-96 registers without it)
template <typename T, int D, int R>
__global__ void __launch_bounds__(dec_warps<T, D>() * 32, 2)
    decode_slab_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ kv_len,
                       T* __restrict__ out, float* __restrict__ lse, int H,
                       int KH, int S, int window, float scale) {
  const int G = H / KH;
  const int groups = (G + R - 1) / R;  // blocks per kv head
  const int kh = blockIdx.x / groups;
  const int g0 = blockIdx.x % groups * R;
  const int b = blockIdx.y;
  const int n = max(0, min(kv_len[b], S));
  const long q0 = ((long)b * H + (long)kh * G + g0) * D;
  const long kv0 = (long)b * S * KH * D + (long)kh * D;
  decode_rows<T, D, R>(q + q0, min(R, G - g0),
                       SlabKV<T, D>{k + kv0, v + kv0, (long)KH * D}, n,
                       window, scale, out + q0,
                       lse + (long)b * H + kh * G + g0);
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* lse, int B, int H,
                   int KH, int S, int window, cudaStream_t stream) {
  constexpr int smem = dec_smem_bytes<T, D, R>();
  constexpr int threads = dec_warps<T, D>() * 32;
  auto kern = decode_slab_kernel<T, D, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int G = H / KH;
  dim3 grid(KH * ((G + R - 1) / R), B);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse), H, KH, S, window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_r(int G, const void* q, const void* k, const void* v,
                       const void* kv_len, void* out, void* lse, int B, int H,
                       int KH, int S, int window, cudaStream_t stream) {
  // bf16 runs on tensor cores, whose N = 8 takes 8 heads a block
  if constexpr (!std::is_same<T, float>::value)
    return launch<T, D, kDecRows>(q, k, v, kv_len, out, lse, B, H, KH, S, window, stream);
  else {
    if (G > 4) return launch<T, D, 8>(q, k, v, kv_len, out, lse, B, H, KH, S, window, stream);
    if (G > 2) return launch<T, D, 4>(q, k, v, kv_len, out, lse, B, H, KH, S, window, stream);
    if (G > 1) return launch<T, D, 2>(q, k, v, kv_len, out, lse, B, H, KH, S, window, stream);
    return launch<T, D, 1>(q, k, v, kv_len, out, lse, B, H, KH, S, window, stream);
  }
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* kv_len, void* out, void* lse, int B, int H,
                       int KH, int S, int window, cudaStream_t stream) {
  const int G = H / KH;
  switch (D) {
    case 16: return dispatch_r<T, 16>(G, q, k, v, kv_len, out, lse, B, H, KH, S, window, stream);
    case 32: return dispatch_r<T, 32>(G, q, k, v, kv_len, out, lse, B, H, KH, S, window, stream);
    case 64: return dispatch_r<T, 64>(G, q, k, v, kv_len, out, lse, B, H, KH, S, window, stream);
    case 128: return dispatch_r<T, 128>(G, q, k, v, kv_len, out, lse, B, H, KH, S, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace moska

// q (B, H, D); k, v (B, S, KH, D), 16-byte aligned; kv_len (B,) int32;
// window >= 0 (0: none); out (B, H, D) in the input dtype; lse (B, H) fp32.
extern "C" int moska_decode_attn(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* out, void* lse,
                                 int B, int H, int KH, int D, int S,
                                 int window, int dtype, void* stream) {
  using namespace moska;
  if (H % KH || H / KH > kDecMaxGroup || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(D, q, k, v, kv_len, out, lse, B, H, KH, S, window, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, kv_len, out, lse, B, H, KH, S, window,
                                          st);
  return cudaErrorInvalidValue;
}
