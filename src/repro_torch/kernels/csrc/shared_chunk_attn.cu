// Shared KV Attention: the paper's GEMM (Fig. 2a) for Hopper, over a bf16
// or fp32 store and over an int8 store.
//
// Replaces two TPU kernels of src/repro/kernels/shared_chunk_attn.py:
// shared_chunk_attention (_kernel) and shared_chunk_attention_q8
// (_kernel_q8). Every query dispatched to shared chunk e (cap slots, each
// with the G query heads of one kv head) attends to that chunk's C keys,
// non-causally; rows whose qmask is false get out 0 and lse -1e30. The
// int8 entry reads int8 K/V and one f32 scale per (token, kv head) and
// dequantizes k_int8 * k_scale in fp32 as each tile is staged; it is the
// same kernel with another loader (attn_tile.cuh::Q8KV).
//
// Output dtype: qd's, for both entries. For bf16 queries (how the serving
// path runs) that is the TPU q8 kernel's contract, which always writes
// bf16; for fp32 queries the int8 entry writes fp32, so an fp32 model over
// an int8 store computes what the reference's fp32 model path computes
// (dequantize in fp32, then the fp kernel).
//
// What bounds it on the H100: the (chunk, kv head) K/V tile is read once
// per block and reused by up to 64 query rows, so at the serving shapes
// (cap * G = 256 rows per chunk and kv head, C = 2048, D = 64) the work is
// compute-heavy (about 64 flops per K/V byte per block), and this simple
// version is limited by fp32 FMA issue and shared-memory reads, not by
// HBM. The int8 store halves the K/V bytes read from HBM against bf16,
// which moves the byte bound and not this version's time. Its design: one
// block per (row tile of <= 64 rows, kv head, chunk); K/V staged through
// shared memory 64 keys at a time; online softmax per row. Dispatch fills
// each chunk's slots from position 0, so the valid rows are a prefix and
// tiles with no valid row exit after writing the masked result: only the
// routed work is computed. wgmma, TMA and a split over C come in later
// versions.
#include "attn_tile.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

// the store's chunks, (E, C, KH, D) of T; seq() is one (chunk, kv head)
template <typename T>
struct ChunksFp {
  const T* k;
  const T* v;
  __device__ __forceinline__ StridedKV<T> seq(int e, int kh, int C, int KH,
                                               int D) const {
    const long o = ((long)e * C * KH + kh) * D;
    return StridedKV<T>{k + o, v + o, (long)KH * D};
  }
};

// the int8 store's chunks (E, C, KH, D) and scales (E, C, KH)
struct ChunksQ8 {
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  __device__ __forceinline__ Q8KV seq(int e, int kh, int C, int KH,
                                      int D) const {
    const long s = (long)e * C * KH + kh;
    return Q8KV{k + s * D, v + s * D, k_scale + s, v_scale + s,
                (long)KH * D, (long)KH};
  }
};

template <typename T, int D, typename Chunks>
__global__ void __launch_bounds__(kThreads)
    shared_chunk_attn_kernel(const T* __restrict__ qd, const Chunks chunks,
                             const uint8_t* __restrict__ qmask,
                             T* __restrict__ out, float* __restrict__ lse,
                             int cap, int H, int KH, int C, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH;
  const int kh = blockIdx.y;
  const int e = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, cap * G - row0);
  const int tid = threadIdx.x;

  // row r of the tile is (slot c, group head g) = divmod(row0 + r, G)
  int mine = 0;
  for (int r = tid; r < rows; r += kThreads)
    mine |= qmask[(long)e * cap + (row0 + r) / G];
  if (!__syncthreads_or(mine)) {
    for (int i = tid; i < rows * D; i += kThreads) {
      const int row = row0 + i / D;
      const long o = ((long)e * cap + row / G) * H + kh * G + row % G;
      out[o * D + i % D] = from_f<T>(0.f);
    }
    for (int r = tid; r < rows; r += kThreads) {
      const int row = row0 + r;
      lse[((long)e * cap + row / G) * H + kh * G + row % G] = kNegInf;
    }
    return;
  }

  const TileSmem sm = carve_smem<D>(smem);
  for (int i = tid; i < rows * D; i += kThreads) {
    const int row = row0 + i / D;
    const long o = ((long)e * cap + row / G) * H + kh * G + row % G;
    sm.q[i] = to_f(qd[o * D + i % D]);
  }
  // attend_rows synchronises before it reads sm.q
  float acc[acc_per_thread<D>()];
  attend_rows<D>(sm, rows, chunks.seq(e, kh, C, KH, D), C, scale, acc);

#pragma unroll
  for (int a = 0; a < acc_per_thread<D>(); ++a) {
    const int i = tid + a * kThreads;
    const int r = i / D, d = i % D;
    if (r < rows) {
      const int row = row0 + r;
      const int c = row / G;
      const long o = ((long)e * cap + c) * H + kh * G + row % G;
      const float val = qmask[(long)e * cap + c]
                            ? acc[a] / fmaxf(sm.l[r], 1e-37f) : 0.f;
      out[o * D + d] = from_f<T>(val);
    }
  }
  for (int r = tid; r < rows; r += kThreads) {
    const int row = row0 + r;
    const int c = row / G;
    const long o = ((long)e * cap + c) * H + kh * G + row % G;
    lse[o] = qmask[(long)e * cap + c]
                 ? sm.m[r] + logf(fmaxf(sm.l[r], 1e-37f)) : kNegInf;
  }
}

template <typename T, int D, typename Chunks>
cudaError_t launch(const void* qd, const Chunks& chunks, const void* qmask,
                   void* out, void* lse, int E, int cap, int H, int KH, int C,
                   cudaStream_t stream) {
  const int smem = attn_smem_floats<D>() * (int)sizeof(float);
  auto kern = shared_chunk_attn_kernel<T, D, Chunks>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int G = H / KH;
  dim3 grid((cap * G + kRows - 1) / kRows, KH, E);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qd), chunks, static_cast<const uint8_t*>(qmask),
      static_cast<T*>(out), static_cast<float*>(lse), cap, H, KH, C,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, typename Chunks>
cudaError_t dispatch_d(int D, const void* qd, const Chunks& chunks,
                       const void* qmask, void* out, void* lse, int E,
                       int cap, int H, int KH, int C, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(qd, chunks, qmask, out, lse, E, cap, H, KH, C, stream);
    case 32: return launch<T, 32>(qd, chunks, qmask, out, lse, E, cap, H, KH, C, stream);
    case 64: return launch<T, 64>(qd, chunks, qmask, out, lse, E, cap, H, KH, C, stream);
    case 128: return launch<T, 128>(qd, chunks, qmask, out, lse, E, cap, H, KH, C, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace moska

// qd (E, cap, H, D); k, v (E, C, KH, D); qmask (E, cap) bytes;
// out (E, cap, H, D) in the input dtype; lse (E, cap, H) fp32.
extern "C" int moska_shared_chunk_attn(const void* qd, const void* k,
                                       const void* v, const void* qmask,
                                       void* out, void* lse, int E, int cap,
                                       int H, int KH, int D, int C, int dtype,
                                       void* stream) {
  using namespace moska;
  if (H % KH) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const ChunksFp<float> ch{static_cast<const float*>(k),
                             static_cast<const float*>(v)};
    return dispatch_d<float>(D, qd, ch, qmask, out, lse, E, cap, H, KH, C, st);
  }
  if (dtype == kBF16) {
    const ChunksFp<__nv_bfloat16> ch{static_cast<const __nv_bfloat16*>(k),
                                     static_cast<const __nv_bfloat16*>(v)};
    return dispatch_d<__nv_bfloat16>(D, qd, ch, qmask, out, lse, E, cap, H,
                                     KH, C, st);
  }
  return cudaErrorInvalidValue;
}

// qd (E, cap, H, D) fp32 or bf16; k, v (E, C, KH, D) int8;
// k_scale, v_scale (E, C, KH) fp32; qmask (E, cap) bytes;
// out (E, cap, H, D) in qd's dtype; lse (E, cap, H) fp32.
extern "C" int moska_shared_chunk_attn_q8(const void* qd, const void* k,
                                          const void* v, const void* k_scale,
                                          const void* v_scale,
                                          const void* qmask, void* out,
                                          void* lse, int E, int cap, int H,
                                          int KH, int D, int C, int dtype,
                                          void* stream) {
  using namespace moska;
  if (H % KH) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ChunksQ8 ch{static_cast<const int8_t*>(k),
                    static_cast<const int8_t*>(v),
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale)};
  if (dtype == kF32)
    return dispatch_d<float>(D, qd, ch, qmask, out, lse, E, cap, H, KH, C, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, qd, ch, qmask, out, lse, E, cap, H,
                                     KH, C, st);
  return cudaErrorInvalidValue;
}
