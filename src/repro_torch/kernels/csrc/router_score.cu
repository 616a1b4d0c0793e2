// MoSKA router chunk scoring for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/router_score.py, function
// router_scores (_kernel): scores[g, e] = sum over heads h and dims d of
// q[g, h, d] * emb[e, h / (H / KH), d], over sqrt(D), in fp32.
//
// What bounds it on the H100: at the serving shapes (G = 64 query groups,
// E = 32 chunks, H * D = 2048) it reads ~0.3 MB and does ~8 MFLOP, so HBM
// bytes and launch latency bound it, not arithmetic. Its design: one warp
// per (group, chunk) score and one block per (group, tile of 8 chunks), so
// the serving shapes launch 256 blocks; each lane strides over the H * D
// features with coalesced loads and accumulates in fp32, and the warp sums
// the lanes with shuffles. The embedding is indexed by kv head, so the
// (E, H * D) matrix with each kv-head embedding repeated for its query
// heads (router_score.py:45) is never built; the q row and the embedding
// are re-read from L1/L2 by the warps that share them.
#include "common.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

constexpr int kRouterThreads = 256;
constexpr int kChunksPerBlock = kRouterThreads / 32;  // one warp per chunk

template <typename T>
__global__ void __launch_bounds__(kRouterThreads)
    router_scores_kernel(const T* __restrict__ q, const T* __restrict__ emb,
                         float* __restrict__ out, int H, int KH, int D, int E,
                         float scale) {
  const int g = blockIdx.y;
  const int e = blockIdx.x * kChunksPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= E) return;  // the whole warp leaves; the kernel has no barrier
  const int F = H * D;
  const int gq = H / KH;
  const T* qg = q + (long)g * F;
  const T* eg = emb + (long)e * KH * D;
  float acc = 0.f;
  for (int f = lane; f < F; f += 32) {
    const int h = f / D, d = f - h * D;
    acc = fmaf(to_f(qg[f]), to_f(eg[(h / gq) * D + d]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[(long)g * E + e] = acc * scale;
}

template <typename T>
cudaError_t launch(const void* q, const void* emb, void* out, int G, int H,
                   int KH, int D, int E, cudaStream_t stream) {
  dim3 grid((E + kChunksPerBlock - 1) / kChunksPerBlock, G);
  router_scores_kernel<T><<<grid, kRouterThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(emb),
      static_cast<float*>(out), H, KH, D, E, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace
}  // namespace moska

// q (G, H, D); emb (E, KH, D) -> out (G, E) fp32.
extern "C" int moska_router_scores(const void* q, const void* emb, void* out,
                                   int G, int H, int KH, int D, int E,
                                   int dtype, void* stream) {
  using namespace moska;
  if (H % KH || G > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(q, emb, out, G, H, KH, D, E, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, emb, out, G, H, KH, D, E, st);
  return cudaErrorInvalidValue;
}
