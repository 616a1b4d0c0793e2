// Online-softmax attention of a tile of query rows against one
// (sequence, kv head) of K/V, staged through shared memory in key tiles,
// all in fp32 on the CUDA cores. Used by shared_chunk_attn.cu for fp32
// queries (rows = dispatched queries x group heads, keys = one shared
// chunk, fp32 or int8 with scales); bf16 queries take the tensor-core
// loop of mma_tile.cuh, and the decode kernels their own split-KV body,
// decode_tile.cuh.
//
// Where a K/V element comes from is a loader policy (StridedKV, Q8KV
// below): load(pos, d, k, v) returns key and value element (pos, d) as
// fp32.
//
// All arithmetic is fp32: Q, K and V are widened on their way into shared
// memory, scores and probabilities stay fp32 through the PV product (the
// TPU kernels keep p in fp32 as well).
#pragma once

#include "common.cuh"

namespace moska {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                  // query rows per block, at most
constexpr int kKeys = 64;                  // keys per shared-memory tile (2 per lane)

// dynamic shared memory of one block, in floats: q, k (padded by one
// column so the score loop reads distinct banks), v, scores, m/l/corr
template <int D>
__host__ __device__ constexpr int attn_smem_floats() {
  return kRows * D + kKeys * (D + 1) + kKeys * D + kRows * kKeys + 3 * kRows;
}

// accumulator entries each thread owns: entry a is element
// tid + a * kThreads of the (kRows, D) output tile
template <int D>
__host__ __device__ constexpr int acc_per_thread() {
  return kRows * D / kThreads;
}

struct TileSmem {
  float* q;     // (kRows, D)
  float* k;     // (kKeys, D + 1)
  float* v;     // (kKeys, D)
  float* s;     // (kRows, kKeys)
  float* m;     // (kRows,) running max
  float* l;     // (kRows,) running denominator
  float* corr;  // (kRows,) rescale of this tile
};

template <int D>
__device__ __forceinline__ TileSmem carve_smem(float* base) {
  TileSmem t;
  t.q = base;
  t.k = t.q + kRows * D;
  t.v = t.k + kKeys * (D + 1);
  t.s = t.v + kKeys * D;
  t.m = t.s + kRows * kKeys;
  t.l = t.m + kRows;
  t.corr = t.l + kRows;
  return t;
}

// K/V of one sequence whose position p, dim d element sits at
// k[p * stride + d] (a slotted cache row or a shared chunk, kv head
// applied to the base pointers).
template <typename T>
struct StridedKV {
  const T* __restrict__ k;
  const T* __restrict__ v;
  long stride;
  __device__ __forceinline__ void load(int pos, int d, float& kx,
                                       float& vx) const {
    kx = to_f(k[pos * stride + d]);
    vx = to_f(v[pos * stride + d]);
  }
};

// int8 K/V of one sequence with one f32 scale per (position, kv head):
// element (p, d) is k[p * stride + d] * k_scale[p * scale_stride],
// dequantized in fp32 on its way into shared memory.
struct Q8KV {
  const int8_t* __restrict__ k;
  const int8_t* __restrict__ v;
  const float* __restrict__ k_scale;
  const float* __restrict__ v_scale;
  long stride;                        // KH * D
  long scale_stride;                  // KH
  __device__ __forceinline__ void load(int pos, int d, float& kx,
                                       float& vx) const {
    kx = (float)k[pos * stride + d] * k_scale[pos * scale_stride];
    vx = (float)v[pos * stride + d] * v_scale[pos * scale_stride];
  }
};

// Attend `rows` query rows (already in sm.q, fp32, unscaled) to keys
// [0, n) of the K/V sequence `kv` reads. Positions past n in the last
// tile get score kNegInf and a zero V row, so they carry exactly zero
// weight. On return acc holds the unnormalised output and sm.m / sm.l the
// row max and denominator. Every thread of the block must call it.
template <int D, typename KV>
__device__ __forceinline__ void attend_rows(
    const TileSmem& sm, int rows, const KV& kv, int n, float scale,
    float (&acc)[acc_per_thread<D>()]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kAcc = acc_per_thread<D>();

  for (int r = tid; r < kRows; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += kKeys) {
    // stage the K/V tile, widened to fp32; rows past n are zero
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int pos = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < n) kv.load(pos, d, kx, vx);
      sm.k[j * (D + 1) + d] = kx;
      sm.v[j * D + d] = vx;
    }
    __syncthreads();

    // scores: consecutive lanes take consecutive keys of one row
    for (int i = tid; i < rows * kKeys; i += kThreads) {
      const int r = i / kKeys, j = i % kKeys;
      const float* qr = sm.q + r * D;
      const float* kj = sm.k + j * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kj[d], s);
      sm.s[r * kKeys + j] = (t0 + j < n) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    for (int r = warp; r < rows; r += kWarps) {
      float* sr = sm.s + r * kKeys;
      const float a = sr[lane], b = sr[lane + 32];
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, b)));
      const float pa = expf(a - m_new), pb = expf(b - m_new);
      sr[lane] = pa;
      sr[lane + 32] = pb;
      const float psum = warp_sum(pa + pb);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        sm.corr[r] = c;
        sm.l[r] = sm.l[r] * c + psum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: consecutive lanes take consecutive dims
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = tid + a * kThreads;
      const int r = i / D, d = i % D;
      if (r < rows) {
        const float* pr = sm.s + r * kKeys;
        float o = acc[a] * sm.corr[r];
#pragma unroll 8
        for (int j = 0; j < kKeys; ++j) o = fmaf(pr[j], sm.v[j * D + d], o);
        acc[a] = o;
      }
    }
    __syncthreads();
  }
}

}  // namespace moska
