// Paged unique-KV decode attention (flash-decoding GEMV over a page pool)
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
// flops per byte. Its design is decode_attn.cu's with another loader
// (attn_tile.cuh::PagedKV): one block per (kv head, request), so the G
// heads that share a kv head read each K/V element once; the key loop
// stops at min(kv_len[b], M * bs), so the bytes follow each request's
// length. Keys past kv_len get score -1e30 and a zero V row, so the null
// page's and the pool's garbage never reach the result. The key loop runs
// the same 64-key tiles in the same order as decode_attn.cu, so on the
// same logical cache the two kernels give the same bits. Loads are scalar
// and the table entry is re-read per element (from L1); page-granular
// vector loads and a split over pages for short batches come later.
#include "attn_tile.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_attn_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int32_t* __restrict__ table,
                             const int32_t* __restrict__ kv_len,
                             T* __restrict__ out, float* __restrict__ lse,
                             int H, int KH, int bs, int M, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH;  // rows of this block; the wrapper checks G <= kRows
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = max(0, min(kv_len[b], M * bs));

  const TileSmem sm = carve_smem<D>(smem);
  const long q0 = ((long)b * H + (long)kh * G) * D;  // G heads x D, contiguous
  for (int i = tid; i < G * D; i += kThreads) sm.q[i] = to_f(q[q0 + i]);
  // attend_rows synchronises before it reads sm.q
  float acc[acc_per_thread<D>()];
  const PagedKV<T> kv{k_pool + (long)kh * D, v_pool + (long)kh * D,
                      table + (long)b * M, bs, (long)bs * KH * D,
                      (long)KH * D};
  attend_rows<D>(sm, G, kv, n, scale, acc);
  store_group_rows<T, D>(sm, G, acc, out + q0, lse + (long)b * H + kh * G);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* table, const void* kv_len, void* out,
                   void* lse, int B, int H, int KH, int bs, int M,
                   cudaStream_t stream) {
  const int smem = attn_smem_floats<D>() * (int)sizeof(float);
  auto kern = paged_decode_attn_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(kv_len), static_cast<T*>(out),
      static_cast<float*>(lse), H, KH, bs, M, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* table, const void* kv_len, void* out,
                       void* lse, int B, int H, int KH, int bs, int M,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    case 32: return launch<T, 32>(q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    case 64: return launch<T, 64>(q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    case 128: return launch<T, 128>(q, k, v, table, kv_len, out, lse, B, H, KH, bs, M, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace moska

// q (B, H, D); k_pool, v_pool (N, bs, KH, D); table (B, M) int32 with
// entries in [0, N); kv_len (B,) int32; out (B, H, D) in the input dtype;
// lse (B, H) fp32.
extern "C" int moska_paged_decode_attn(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* kv_len, void* out,
                                       void* lse, int B, int H, int KH, int D,
                                       int bs, int M, int dtype,
                                       void* stream) {
  using namespace moska;
  if (H % KH || H / KH > kRows || bs < 1 || M < 1)
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
