// Tensor-core attention tiles for Hopper: a FlashAttention-2-style loop of
// bf16 mma.sync m16n8k16 products with fp32 sums, fragments read from
// shared memory by ldmatrix, and K/V tiles copied in by cp.async into a
// ring of stages, so the copy of tile t + 1 overlaps the products of tile
// t. Used by shared_chunk_attn.cu for bf16 queries (rows = dispatched
// queries x group heads, keys = one shared chunk, bf16 or int8 with
// scales; or rows = every query x group heads, keys = the shared tail a
// sliding-window layer sees) and by flash_prefill_attn.cu (rows = positions x group heads,
// keys = the causal band of one sequence).
//
// A block is 4 warps over 64 M query rows, M atoms of 16 rows a warp (the
// shared kernel's M is 1). The warp keeps
// its Q fragments, its 16 x D output sum and its softmax state in
// registers; S = Q K^T goes from the accumulator fragments straight into
// the A fragments of P V, with no trip through shared memory. Every shared
// row is padded by 16 bytes, so the 8 row addresses of one ldmatrix fall
// in 8 distinct bank groups.
//
// Where a K/V tile comes from is a source policy (StridedBf16KV,
// StridedQ8KV below): issue(stage, t0, n) starts the copies of keys
// [t0, t0 + 64), zero-filling rows past n; prepare(stage, scratch) is
// called once the stage has landed and returns the bf16 tiles to read.
// Which scores count is a mask policy (KeysBelow and KeysFrom below; the
// prefill's causal band in flash_prefill_attn.cu).
//
// Numerics: products of bf16 values are exact in the fp32 sums; scores,
// the running max and the denominator stay fp32. The one extra rounding
// against attn_tile.cuh is P to bf16 before P V, as in FlashAttention-2;
// a probability below 2^-126 is 0 (exp2_ftz).
#pragma once

#include "common.cuh"

namespace moska {

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaRows = 64;      // query rows of one atom a warp
constexpr int kMmaKeys = 64;      // keys per K/V stage

// shared row of D bf16 values, padded by 8 values (16 bytes)
template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }

// K/V stages in the ring: fewer at D = 128, where one stage is 34 KB
template <int D>
__host__ __device__ constexpr int mma_stages() { return D >= 128 ? 2 : 3; }

// one padded (64, D) bf16 tile, in bytes
template <int D>
__host__ __device__ constexpr int mma_tile_bytes() {
  return kMmaKeys * mma_ld<D>() * 2;
}

// the tiles one K/V stage offers the products: padded (64, D) bf16 K and
// V, and for the int8 store the 64 keys' scales (nullptr for bf16)
struct MmaKV {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* k_scale;
  const float* v_scale;
};

// bf16 K/V of one sequence, element (p, d) at k[p * stride + d]: copied
// straight into the stage
template <int D>
struct StridedBf16KV {
  static constexpr int kStageBytes = 2 * mma_tile_bytes<D>();
  static constexpr int kScratchBytes = 0;
  const __nv_bfloat16* __restrict__ k;
  const __nv_bfloat16* __restrict__ v;
  long stride;

  __device__ __forceinline__ void issue(char* stage, int t0, int n) const {
    constexpr int kChunks = D / 8;  // 16-byte chunks of a row
    static_assert(kMmaKeys * kChunks % kMmaThreads == 0, "whole rounds");
    auto* ks = reinterpret_cast<__nv_bfloat16*>(stage);
    auto* vs = ks + kMmaKeys * mma_ld<D>();
#pragma unroll
    for (int r = 0; r < kMmaKeys * kChunks / kMmaThreads; ++r) {
      const int i = threadIdx.x + r * kMmaThreads;
      const int j = i / kChunks, c = i % kChunks;
      const bool in = t0 + j < n;
      const long o = (in ? (long)(t0 + j) * stride : 0) + c * 8;
      const int dst = j * mma_ld<D>() + c * 8;
      cp_async16(ks + dst, k + o, in ? 16 : 0);
      cp_async16(vs + dst, v + o, in ? 16 : 0);
    }
  }

  __device__ __forceinline__ MmaKV prepare(char* stage, char*) const {
    auto* ks = reinterpret_cast<const __nv_bfloat16*>(stage);
    return MmaKV{ks, ks + kMmaKeys * mma_ld<D>(), nullptr, nullptr};
  }
};

// int8 K/V of one sequence with one f32 scale per (position, kv head):
// the stage holds the int8 rows and the scales; prepare widens the int8
// rows into bf16 tiles in the scratch (exact: every int8 value is a bf16
// value), and the scales are applied to the scores and to P in fp32
template <int D>
struct StridedQ8KV {
  static constexpr int kStageBytes = 2 * kMmaKeys * D + 2 * kMmaKeys * 4;
  static constexpr int kScratchBytes = 2 * mma_tile_bytes<D>();
  const int8_t* __restrict__ k;
  const int8_t* __restrict__ v;
  const float* __restrict__ k_scale;
  const float* __restrict__ v_scale;
  long stride;        // KH * D
  long scale_stride;  // KH

  __device__ __forceinline__ void issue(char* stage, int t0, int n) const {
    constexpr int kChunks = D / 16;  // 16-byte chunks of an int8 row
    int8_t* k8 = reinterpret_cast<int8_t*>(stage);
    int8_t* v8 = k8 + kMmaKeys * D;
    float* ksc = reinterpret_cast<float*>(v8 + kMmaKeys * D);
    float* vsc = ksc + kMmaKeys;
    for (int i = threadIdx.x; i < kMmaKeys * kChunks; i += kMmaThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const bool in = t0 + j < n;
      const long o = (in ? (long)(t0 + j) * stride : 0) + c * 16;
      cp_async16(k8 + j * D + c * 16, k + o, in ? 16 : 0);
      cp_async16(v8 + j * D + c * 16, v + o, in ? 16 : 0);
    }
    for (int j = threadIdx.x; j < kMmaKeys; j += kMmaThreads) {
      const bool in = t0 + j < n;
      const long o = in ? (long)(t0 + j) * scale_stride : 0;
      cp_async4(ksc + j, k_scale + o, in ? 4 : 0);
      cp_async4(vsc + j, v_scale + o, in ? 4 : 0);
    }
  }

  // every thread of the block calls it; it synchronises before returning
  __device__ __forceinline__ MmaKV prepare(char* stage, char* scratch) const {
    constexpr int kUnits = D / 8;  // 8 int8 values -> one 16-byte bf16 store
    const int8_t* k8 = reinterpret_cast<const int8_t*>(stage);
    const int8_t* v8 = k8 + kMmaKeys * D;
    const float* ksc = reinterpret_cast<const float*>(v8 + kMmaKeys * D);
    auto* kt = reinterpret_cast<__nv_bfloat16*>(scratch);
    auto* vt = kt + kMmaKeys * mma_ld<D>();
    for (int i = threadIdx.x; i < 2 * kMmaKeys * kUnits; i += kMmaThreads) {
      const int which = i / (kMmaKeys * kUnits);  // 0: K, 1: V
      const int u = i % (kMmaKeys * kUnits);
      const int j = u / kUnits, c = u % kUnits;
      const int2 raw = *reinterpret_cast<const int2*>(
          (which ? v8 : k8) + j * D + c * 8);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      uint4 w;
      w.x = pack_bf16((float)b[0], (float)b[1]);
      w.y = pack_bf16((float)b[2], (float)b[3]);
      w.z = pack_bf16((float)b[4], (float)b[5]);
      w.w = pack_bf16((float)b[6], (float)b[7]);
      *reinterpret_cast<uint4*>((which ? vt : kt) + j * mma_ld<D>() + c * 8) =
          w;
    }
    __syncthreads();
    return MmaKV{kt, vt, ksc, ksc + kMmaKeys};
  }
};

// Shared memory of one block of R query rows: the Q tile, the ring of K/V
// stages, and the source's scratch, in bytes.
template <int D, typename Src, int R = kMmaRows>
__host__ __device__ constexpr int mma_smem_bytes() {
  return R / kMmaRows * mma_tile_bytes<D>() +
         mma_stages<D>() * Src::kStageBytes + Src::kScratchBytes;
}

// The mask of keys [0, n): every score of a key below n counts, for every
// row. A mask policy answers full(t0): whether every score of keys
// [t0, t0 + 64) counts for every row of the block (then none is looked
// at), and (h, key, x): the score x of this lane's row h (2 a: row g of
// the warp's 16-row atom a, 2 a + 1: row g + 8) against key `key`, or what
// replaces it.
struct KeysBelow {
  int n;
  __device__ __forceinline__ bool full(int t0) const {
    return t0 + kMmaKeys <= n;
  }
  __device__ __forceinline__ float operator()(int, int key, float x) const {
    return key < n ? x : kNegInf;
  }
};

// The mask of keys [lo, n) of each row (the shared tail's, where row h of
// the lane sees keys from its own first key on): a key of the row's range
// counts; any other never counts (-inf), so a row that sees no key keeps
// m = -1e30 and l = 0. Keys [full_lo, n) count for every row of the block.
struct KeysFrom {
  int lo[2];
  int full_lo, n;
  __device__ __forceinline__ bool full(int t0) const {
    return t0 >= full_lo && t0 + kMmaKeys <= n;
  }
  __device__ __forceinline__ float operator()(int h, int key, float x) const {
    return key >= lo[h] && key < n ? x : __int_as_float((int)0xff800000);
  }
};

// One warp's share of a block: M atoms of 16 query rows (atom a holds tile
// rows 16 (M w + a) .. + 15) against the keys the block visits. Lane l
// holds rows g = l / 4 and g + 8 of each atom and, of each 8-column block,
// columns 2 (l % 4) + 0,1. On return o[a] holds the unnormalised output
// of those entries of atom a (o[a][b] is column block b), m the row max of
// the scaled scores in log2 units and l the row denominator, both per row
// (m[a][0]: row g, m[a][1]: row g + 8) and complete in every lane.
template <int D, int M = 1>
struct MmaRows {
  float o[M][D / 8][4];
  float m[M][2];
  float l[M][2];
};

// Attend the block's 64 M query rows, already copied into sq (padded,
// bf16, unscaled; the caller has committed those copies as one cp.async
// group), to keys [k0, n) that `src` reads, in tiles of 64 from k0 (the
// last one's keys past n read as zeros), under `mask`. scale_log2 =
// log2(e) / sqrt(D). Every thread of the block must call it. A score the
// mask replaces by -1e30 still counts in a row that has no other (p = 1,
// as in the plain versions); one replaced by -inf never counts. With one
// atom a warp (M = 1) the Q fragments stay in registers; with two, each
// K and V fragment feeds both atoms' products, which halves the shared
// memory read a product, and the Q fragments are read again from sq for
// every tile (registers hold the two atoms' outputs instead).
template <int D, int M = 1, typename Src, typename Mask>
__device__ __forceinline__ void attend_rows_mma(const __nv_bfloat16* sq,
                                                char* ring, char* scratch,
                                                const Src& src, int k0, int n,
                                                const Mask& mask,
                                                float scale_log2,
                                                MmaRows<D, M>& acc) {
  constexpr int S = mma_stages<D>();
  constexpr int LD = mma_ld<D>();
  constexpr bool kQInRegs = M == 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;  // column pair of the C fragments
  const int nt = n > k0 ? (n - k0 + kMmaKeys - 1) / kMmaKeys : 0;

  // prologue: tiles 0 .. S-2, one group each (empty groups past the end
  // keep the count uniform)
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nt)
      src.issue(ring + s * Src::kStageBytes, k0 + s * kMmaKeys, n);
    cp_async_commit();
  }
  // the Q group is the oldest; S - 1 tile groups may stay in flight
  cp_async_wait<S - 1>();
  __syncthreads();
  // lane's ldmatrix row of each atom's Q
  const __nv_bfloat16* qr[M];
#pragma unroll
  for (int a = 0; a < M; ++a)
    qr[a] = sq + ((warp * M + a) * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qa[kQInRegs ? D / 16 : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qa[kk], qr[0] + kk * 16);
  }

#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int b = 0; b < D / 8; ++b)
      acc.o[a][b][0] = acc.o[a][b][1] = acc.o[a][b][2] = acc.o[a][b][3] = 0.f;
    acc.m[a][0] = acc.m[a][1] = kNegInf;
    acc.l[a][0] = acc.l[a][1] = 0.f;  // this lane's partial sums until the end
  }

  for (int it = 0; it < nt; ++it) {
    // tile it has landed (for every thread, after the barrier), and every
    // warp is done with tile it - 1, whose stage the next copy refills
    cp_async_wait<S - 2>();
    __syncthreads();
    if (it + S - 1 < nt)
      src.issue(ring + ((it + S - 1) % S) * Src::kStageBytes,
                k0 + (it + S - 1) * kMmaKeys, n);
    cp_async_commit();
    const MmaKV kv = src.prepare(ring + (it % S) * Src::kStageBytes, scratch);
    const int t0 = k0 + it * kMmaKeys;

    // S = Q K^T: 8 column blocks of 8 keys; one ldmatrix.x4 gives the B
    // fragments of two blocks at one 16-wide step of D
    float s[M][8][4];
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[a][j][0] = s[a][j][1] = s[a][j][2] = s[a][j][3] = 0.f;
    {
      const __nv_bfloat16* kr =
          kv.k + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qk[M][4];
#pragma unroll
        for (int a = 0; a < M; ++a) {
          if constexpr (kQInRegs) {
#pragma unroll
            for (int r = 0; r < 4; ++r) qk[a][r] = qa[kk][r];
          } else {
            ldsm_x4(qk[a], qr[a] + kk * 16);
          }
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];
          ldsm_x4(b, kr + jp * 16 * LD + kk * 16);
#pragma unroll
          for (int a = 0; a < M; ++a) {
            mma_bf16(s[a][2 * jp], qk[a], b[0], b[1]);
            mma_bf16(s[a][2 * jp + 1], qk[a], b[2], b[3]);
          }
        }
      }
    }

    // the online softmax in log2 units; entry e of block j of atom a is
    // row g + 8 (e / 2), key t0 + 8 j + 2 t + e % 2. A tile whose every
    // score counts (and no int8 scale) takes the max of the raw scores and
    // folds the scale into the exponent's FFMA; any other scales each
    // score in fp32 (times the int8 store's k_scale), masks it where the
    // tile needs it, and takes the max of those
    const bool whole = mask.full(t0);
    const bool fold = whole && !kv.k_scale;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      if (!fold) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * j + 2 * t + (e & 1);
            float x = s[a][j][e] * scale_log2;
            if (kv.k_scale) x *= kv.k_scale[key];
            s[a][j][e] = x;
          }
        }
        if (!whole) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[a][j][e] = mask(2 * a + (e >> 1), t0 + 8 * j + 2 * t + (e & 1),
                                s[a][j][e]);
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[a][j][e]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        if (fold) mx[r] *= scale_log2;
        const float m_new = fmaxf(acc.m[a][r], mx[r]);
        corr[r] = exp2_ftz(acc.m[a][r] - m_new);
        acc.m[a][r] = m_new;
        acc.l[a][r] *= corr[r];
      }
      // a row whose max held keeps corr = 1: skip the multiply when no
      // row of the warp's atom moved (the result is the same)
      const bool moved =
          __any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f);
      if (fold) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_ftz(
                fmaf(s[a][j][e], scale_log2, -acc.m[a][e >> 1]));
            acc.l[a][e >> 1] += p;
            s[a][j][e] = p;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_ftz(s[a][j][e] - acc.m[a][e >> 1]);
            acc.l[a][e >> 1] += p;
            s[a][j][e] = p;
          }
        }
      }
      if (moved) {
#pragma unroll
        for (int b = 0; b < D / 8; ++b) {
          acc.o[a][b][0] *= corr[0];
          acc.o[a][b][1] *= corr[0];
          acc.o[a][b][2] *= corr[1];
          acc.o[a][b][3] *= corr[1];
        }
      }
    }

    // O += P V, 16 keys a step: P's A fragments are the score blocks
    // 2 ks and 2 ks + 1, rounded to bf16 (after the int8 store's v_scale);
    // one ldmatrix.x4.trans gives the B fragments of two column blocks
    {
      const __nv_bfloat16* vr =
          kv.v + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        float vs[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
        if (kv.v_scale) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            vs[h][0] = kv.v_scale[16 * ks + 8 * h + 2 * t];
            vs[h][1] = kv.v_scale[16 * ks + 8 * h + 2 * t + 1];
          }
        }
        uint32_t pa[M][4];
#pragma unroll
        for (int a = 0; a < M; ++a) {
          const float(&p0)[4] = s[a][2 * ks];
          const float(&p1)[4] = s[a][2 * ks + 1];
          pa[a][0] = pack_bf16(p0[0] * vs[0][0], p0[1] * vs[0][1]);
          pa[a][1] = pack_bf16(p0[2] * vs[0][0], p0[3] * vs[0][1]);
          pa[a][2] = pack_bf16(p1[0] * vs[1][0], p1[1] * vs[1][1]);
          pa[a][3] = pack_bf16(p1[2] * vs[1][0], p1[3] * vs[1][1]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(b, vr + ks * 16 * LD + dp * 16);
#pragma unroll
          for (int a = 0; a < M; ++a) {
            mma_bf16(acc.o[a][2 * dp], pa[a], b[0], b[1]);
            mma_bf16(acc.o[a][2 * dp + 1], pa[a], b[2], b[3]);
          }
        }
      }
    }
  }
  // no copy may be in flight when the block exits or reuses the ring
  cp_async_wait<0>();
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc.l[a][r] += __shfl_xor_sync(0xffffffffu, acc.l[a][r], 1);
      acc.l[a][r] += __shfl_xor_sync(0xffffffffu, acc.l[a][r], 2);
    }
  }
}

}  // namespace moska
