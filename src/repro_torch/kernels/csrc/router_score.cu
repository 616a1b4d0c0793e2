// MoSKA router chunk scoring for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/router_score.py, function
// router_scores (_kernel): scores[g, e] = sum over heads h and dims d of
// q[g, h, d] * emb[e, h / (H / KH), d], over sqrt(D), in fp32.
//
// What bounds it on the H100: at the serving shapes (G = 64 decode groups or
// 2 prefill groups, E = 32 chunks, H * D = 2048, KH * D = 256) it reads
// 0.02-0.27 MB and does at most 0.5 M FMAs once folded (below), so launch
// latency and one round trip to HBM bound it, not bytes or arithmetic. At
// corpus scale (E = 8,192 chunks, the router's hot loop in the TPU
// kernel's note) the 4 MB of embeddings make it bound by bytes.
//
// Its design:
//   - Fold first. sum_h q[g, h] . emb[e, h / gq] equals
//     sum_kh (sum_{h in kh} q[g, h]) . emb[e, kh], so each block sums the
//     gq = H / KH query heads of every kv head in fp32 registers (16-byte
//     loads, all gq of a batch issued together) into qbar (4 groups,
//     KH * D) in fp32 shared memory: 8x fewer products for tinyllama. The
//     (E, H * D) repeated-embedding matrix of the TPU kernel is never built.
//   - Each block stages tiles of 8 chunk embeddings (8, KH * D) in shared
//     memory with 16-byte cp.async copies, two tiles in flight, and loops
//     over E tiles: the grid is (G tiles of 4) x (at most enough E tiles
//     for ~1,024 blocks), so corpus-scale E keeps every SM busy and each
//     block folds its q rows once.
//   - Lane (g, e) = (lane / 8, lane % 8) of each of the 4 warps scores one
//     (group, chunk) pair over every 4th 4-feature granule, in four
//     independent fp32 FMA chains read from shared memory (rows padded 16
//     bytes, so the 8 chunks' rows fall in distinct banks); the 4 warps'
//     partial sums are added in a fixed order through shared memory.
//   - No tensor cores. After the fold the decode shape is about 0.5 M FMAs,
//     well under a microsecond on the CUDA cores, and the contract is fp32
//     products of values cast to fp32 (2e-5, router_score.py:22-26): a bf16
//     or TF32 mma of the folded fp32 qbar would round it and cannot meet it.
// Rows whose bytes are not a multiple of 16, or whose pointers are not
// 16-byte aligned, take the scalar load path of the same kernel.
#include "common.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

constexpr int kRouterWarps = 4;
constexpr int kRouterThreads = kRouterWarps * 32;
constexpr int kTileG = 4;   // query groups per block: lane / 8
constexpr int kTileE = 8;   // chunks per tile: lane % 8
constexpr int kFoldBatch = 8;      // q heads whose loads a thread issues together
constexpr int kBlocksTarget = 1024;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// qbar row stride (floats) and embedding row stride (elements): features
// rounded to a 4-feature granule (and to 16 bytes) plus 16 bytes of pad
__host__ __device__ inline int qbar_stride(int F) { return round_up(F, 4) + 4; }
template <typename T>
__host__ __device__ inline int emb_stride(int F) {
  constexpr int per16 = 16 / sizeof(T);
  return round_up(round_up(F, 4), per16) + per16;
}
template <typename T>
__host__ __device__ inline int router_smem_bytes(int F) {
  return kTileG * qbar_stride(F) * 4 + 2 * kTileE * emb_stride<T>(F) * sizeof(T) +
         kRouterWarps * 32 * 4;
}

__device__ __forceinline__ void smem4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void smem4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}

// embedding tile et (rows et * 8 ...) into buffer dst, rows past E zero
template <typename T, int V>
__device__ void stage_tile(T* dst, const T* __restrict__ emb, int et, int E,
                           int F) {
  const int ES = emb_stride<T>(F);
  const int e0 = et * kTileE;
  if constexpr (V > 1) {  // F % V == 0 here, so rows are whole 16-byte pieces
    const int per_row = F / V;
    for (int i = threadIdx.x; i < kTileE * per_row; i += kRouterThreads) {
      const int e = i / per_row, c = i - e * per_row;
      const bool in = e0 + e < E;
      cp_async16(dst + e * ES + c * V,
                 emb + (long)(in ? e0 + e : 0) * F + c * V, in ? 16 : 0);
    }
    cp_async_commit();
  } else {
    const int F4 = round_up(F, 4);
    for (int i = threadIdx.x; i < kTileE * F4; i += kRouterThreads) {
      const int e = i / F4, f = i - e * F4;
      dst[e * ES + f] = e0 + e < E && f < F ? emb[(long)(e0 + e) * F + f]
                                            : from_f<T>(0.f);
    }
  }
}

// V elements per global access (16 bytes, or 1 on the scalar path)
template <typename T, int V>
__global__ void __launch_bounds__(kRouterThreads)
    router_scores_kernel(const T* __restrict__ q, const T* __restrict__ emb,
                         float* __restrict__ out, int G, int H, int KH, int D,
                         int E, float scale) {
  extern __shared__ __align__(16) unsigned char router_smem[];
  const int F = KH * D, F4 = round_up(F, 4);
  const int QS = qbar_stride(F), ES = emb_stride<T>(F);
  float* qbar = reinterpret_cast<float*>(router_smem);  // [kTileG][QS]
  T* tiles = reinterpret_cast<T*>(qbar + kTileG * QS);  // [2][kTileE][ES]
  float* red = reinterpret_cast<float*>(tiles + 2 * kTileE * ES);  // [warps][32]
  const int n_et = (E + kTileE - 1) / kTileE;
  const int g0 = blockIdx.x * kTileG;

  stage_tile<T, V>(tiles, emb, blockIdx.y, E, F);  // in flight during the fold

  // qbar[g][kh * D + d] = sum_j q[g0 + g, kh * gq + j, d], j in order
  const int gq = H / KH, per_head = D / V;
  for (int it = threadIdx.x; it < kTileG * KH * per_head; it += kRouterThreads) {
    const int g = it / (KH * per_head);
    const int kh = it / per_head - g * KH;
    const int c = it - (g * KH + kh) * per_head;
    float s[V] = {};
    if (g0 + g < G) {
      const T* src = q + ((long)(g0 + g) * H + (long)kh * gq) * D + c * V;
      for (int j0 = 0; j0 < gq; j0 += kFoldBatch) {
        vec_t<T, V> raw[kFoldBatch];
#pragma unroll
        for (int i = 0; i < kFoldBatch; ++i)
          if (j0 + i < gq) raw[i] = load_vec<T, V>(src + (long)(j0 + i) * D);
#pragma unroll
        for (int i = 0; i < kFoldBatch; ++i) {
          if (j0 + i >= gq) break;
          float x[V];
          widen<T, V>(raw[i], x);
#pragma unroll
          for (int v = 0; v < V; ++v) s[v] += x[v];
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) qbar[g * QS + kh * D + c * V + v] = s[v];
  }
  for (int i = threadIdx.x; i < kTileG * (F4 - F); i += kRouterThreads)
    qbar[i / (F4 - F) * QS + F + i % (F4 - F)] = 0.f;  // the granule's tail

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qrow = qbar + (lane >> 3) * QS;
  int buf = 0;
  for (int et = blockIdx.y; et < n_et; et += gridDim.y, buf ^= 1) {
    const int next = et + gridDim.y;
    if (next < n_et) stage_tile<T, V>(tiles + (buf ^ 1) * kTileE * ES, emb, next, E, F);
    if constexpr (V > 1) {
      if (next < n_et) cp_async_wait<1>();
      else cp_async_wait<0>();
    }
    __syncthreads();  // tile et (and, the first time, qbar) complete
    const T* erow = tiles + buf * kTileE * ES + (lane & 7) * ES;
    float acc[4] = {};
    for (int f = warp * 4; f < F4; f += kRouterWarps * 4) {
      float a[4], b[4];
      smem4(qrow + f, a);
      smem4(erow + f, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(a[i], b[i], acc[i]);
    }
    red[warp * 32 + lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    __syncthreads();  // every warp's partials, and every read of tile et, done
    if (warp == 0) {
      float s = red[lane];
#pragma unroll
      for (int w = 1; w < kRouterWarps; ++w) s += red[w * 32 + lane];
      const int g = g0 + (lane >> 3), e = et * kTileE + (lane & 7);
      if (g < G && e < E) out[(long)g * E + e] = s * scale;
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* q, const void* emb, void* out, int G, int H,
                   int KH, int D, int E, cudaStream_t stream) {
  const int smem = router_smem_bytes<T>(KH * D);
  auto kern = router_scores_kernel<T, V>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int g_tiles = (G + kTileG - 1) / kTileG;
  const int e_tiles = (E + kTileE - 1) / kTileE;
  const int per_g = (kBlocksTarget + g_tiles - 1) / g_tiles;
  dim3 grid(g_tiles, e_tiles < per_g ? e_tiles : per_g);
  kern<<<grid, kRouterThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(emb),
      static_cast<float*>(out), G, H, KH, D, E, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* emb, void* out, int G, int H,
                     int KH, int D, int E, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (D % V == 0 && aligned16(q) && aligned16(emb))
    return launch<T, V>(q, emb, out, G, H, KH, D, E, stream);
  return launch<T, 1>(q, emb, out, G, H, KH, D, E, stream);
}

}  // namespace
}  // namespace moska

// q (G, H, D); emb (E, KH, D) -> out (G, E) fp32.
extern "C" int moska_router_scores(const void* q, const void* emb, void* out,
                                   int G, int H, int KH, int D, int E,
                                   int dtype, void* stream) {
  using namespace moska;
  if (G <= 0 || E <= 0 || KH <= 0 || D <= 0 || H % KH)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch<float>(q, emb, out, G, H, KH, D, E, st);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(q, emb, out, G, H, KH, D, E, st);
  return cudaErrorInvalidValue;
}
