// Shared KV Attention: the paper's GEMM (Fig. 2a) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/shared_chunk_attn.py,
// function shared_chunk_attention (_kernel). Every query dispatched to
// shared chunk e (cap slots, each with the G query heads of one kv head)
// attends to that chunk's C keys, non-causally; rows whose qmask is false
// get out 0 and lse -1e30.
//
// What bounds it on the H100: the (chunk, kv head) K/V tile is read once
// per block and reused by up to 64 query rows, so at the serving shapes
// (cap * G = 256 rows per chunk and kv head, C = 2048, D = 64) the work is
// compute-heavy (about 64 flops per K/V byte per block), and this simple
// version is limited by fp32 FMA issue and shared-memory reads, not by
// HBM. Its design: one block per (row tile of <= 64 rows, kv head, chunk);
// K/V staged through shared memory 64 keys at a time; online softmax per
// row. Dispatch fills each chunk's slots from position 0, so the valid
// rows are a prefix and tiles with no valid row exit after writing the
// masked result: only the routed work is computed. wgmma, TMA and a
// split over C come in later versions.
#include "attn_tile.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    shared_chunk_attn_kernel(const T* __restrict__ qd, const T* __restrict__ k,
                             const T* __restrict__ v,
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
  const long kv0 = (long)e * C * KH * D + (long)kh * D;
  attend_rows<T, D>(sm, rows, k + kv0, v + kv0, (long)KH * D, C, scale, acc);

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

template <typename T, int D>
cudaError_t launch(const void* qd, const void* k, const void* v,
                   const void* qmask, void* out, void* lse, int E, int cap,
                   int H, int KH, int C, cudaStream_t stream) {
  const int smem = attn_smem_floats<D>() * (int)sizeof(float);
  auto kern = shared_chunk_attn_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int G = H / KH;
  dim3 grid((cap * G + kRows - 1) / kRows, KH, E);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qd), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(qmask),
      static_cast<T*>(out), static_cast<float*>(lse), cap, H, KH, C,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* qd, const void* k, const void* v,
                       const void* qmask, void* out, void* lse, int E,
                       int cap, int H, int KH, int C, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(qd, k, v, qmask, out, lse, E, cap, H, KH, C, stream);
    case 32: return launch<T, 32>(qd, k, v, qmask, out, lse, E, cap, H, KH, C, stream);
    case 64: return launch<T, 64>(qd, k, v, qmask, out, lse, E, cap, H, KH, C, stream);
    case 128: return launch<T, 128>(qd, k, v, qmask, out, lse, E, cap, H, KH, C, stream);
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
  if (dtype == kF32)
    return dispatch_d<float>(D, qd, k, v, qmask, out, lse, E, cap, H, KH, C, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, qd, k, v, qmask, out, lse, E, cap, H, KH, C, st);
  return cudaErrorInvalidValue;
}
