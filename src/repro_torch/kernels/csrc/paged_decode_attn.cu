// Paged unique-KV decode attention (split-KV GQA decode over a page pool)
// for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attn.py, function
// paged_decode_attention (_kernel): one new query per request attends to
// that request's own cache, positions [0, kv_len[b]), whose K/V live in a
// shared pool of pages (N, bs, KH, D) named by the request's row of the
// block table (B, M): position p is row p % bs of page table[b, p / bs].
// No sliding window. The kernel reads the pages through the table and
// never builds the gathered (B, M * bs, KH, D) copy.
//
// What bounds it on the H100: HBM bytes, as for decode_attn.cu: each K/V
// element is used by the G query heads of its kv head only, about 2 * G
// flops per byte. The key loop stops at min(kv_len[b], M * bs), so the
// bytes follow each request's length.
//
// Its design is decode_attn.cu's body (decode_tile.cuh) with a page loader
// (PagesKV): one block per (kv head, request, group of at most 8 heads);
// its 4 warps split [0, n) into 32-key tiles, tile t to warp t % 4, each
// streaming its tiles through a ring of 16-byte cp.async copies and
// keeping its own online softmax (bf16 on tensor cores, fp32 on the CUDA
// cores), merged in shared memory, warp 0 first. A 32-key tile spans
// 32 / bs pages (2 at bs = 16): each page's table entry is read once, by
// one lane; each lane turns its key's page and row into an offset, which
// the copies take by a shuffle; a page's rows of one kv head are 16-byte
// copies at stride KH * D. Keys past kv_len are
// zero-filled and score -1e30, so the null page's and the pool's garbage
// never reach the result. The split of [0, n) into tiles and warps
// depends only on n, not on bs, M or the page order, so on the same
// logical cache this kernel and decode_attn.cu do the same arithmetic in
// the same order and give the same bits.
#include "decode_tile.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

// the 2-block minimum keeps ptxas from spilling, as in decode_attn.cu
template <typename T, int D, int R>
__global__ void __launch_bounds__(dec_warps<T, D>() * 32, 2)
    decode_pages_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int32_t* __restrict__ table,
                        const int32_t* __restrict__ kv_len,
                        T* __restrict__ out, float* __restrict__ lse, int H,
                        int KH, int bs, int M, float scale) {
  const int G = H / KH;
  const int groups = (G + R - 1) / R;  // blocks per kv head
  const int kh = blockIdx.x / groups;
  const int g0 = blockIdx.x % groups * R;
  const int b = blockIdx.y;
  const int n = max(0, min(kv_len[b], M * bs));
  const long q0 = ((long)b * H + (long)kh * G + g0) * D;
  const PagesKV<T, D> kv{k_pool + (long)kh * D, v_pool + (long)kh * D,
                         table + (long)b * M, bs, (long)bs * KH * D,
                         (long)KH * D};
  decode_rows<T, D, R>(q + q0, min(R, G - g0), kv, n, scale, out + q0,
                       lse + (long)b * H + kh * G + g0);
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* table, const void* kv_len, void* out,
                   void* lse, int B, int H, int KH, int bs, int M,
                   cudaStream_t stream) {
  constexpr int smem = dec_smem_bytes<T, D, R>();
  constexpr int threads = dec_warps<T, D>() * 32;
  auto kern = decode_pages_kernel<T, D, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int G = H / KH;
  dim3 grid(KH * ((G + R - 1) / R), B);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(kv_len), static_cast<T*>(out),
      static_cast<float*>(lse), H, KH, bs, M, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_r(int G, const void* q, const void* k, const void* v,
                       const void* table, const void* kv_len, void* out,
                       void* lse, int B, int H, int KH, int bs, int M,
                       cudaStream_t stream) {
  // bf16 runs on tensor cores, whose N = 8 takes 8 heads a block
  if constexpr (!std::is_same<T, float>::value)
    return launch<T, D, kDecRows>(q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
  else {
    if (G > 4) return launch<T, D, 8>(q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    if (G > 2) return launch<T, D, 4>(q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    if (G > 1) return launch<T, D, 2>(q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    return launch<T, D, 1>(q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
  }
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* table, const void* kv_len, void* out,
                       void* lse, int B, int H, int KH, int bs, int M,
                       cudaStream_t stream) {
  const int G = H / KH;
  switch (D) {
    case 16: return dispatch_r<T, 16>(G, q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    case 32: return dispatch_r<T, 32>(G, q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    case 64: return dispatch_r<T, 64>(G, q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    case 128: return dispatch_r<T, 128>(G, q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace moska

// q (B, H, D); k_pool, v_pool (N, bs, KH, D), 16-byte aligned; table (B, M)
// int32 with entries in [0, N); kv_len (B,) int32; out (B, H, D) in the
// input dtype; lse (B, H) fp32.
extern "C" int moska_paged_decode_attn(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* kv_len, void* out,
                                       void* lse, int B, int H, int KH, int D,
                                       int bs, int M, int dtype,
                                       void* stream) {
  using namespace moska;
  if (H % KH || H / KH > kDecMaxGroup || bs < 1 || M < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(D, q, k_pool, v_pool, table, kv_len, out, lse, B,
                             H, KH, bs, M, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k_pool, v_pool, table, kv_len, out,
                                     lse, B, H, KH, bs, M, st);
  return cudaErrorInvalidValue;
}
