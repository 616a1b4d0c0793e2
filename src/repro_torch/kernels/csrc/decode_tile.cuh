// Split-KV GQA decode attention for Hopper: the device body of
// decode_attn.cu (K/V in a slotted slab) and paged_decode_attn.cu (K/V in
// pool pages named by a block table). The two differ only in their loader
// (SlabKV, PagesKV below).
//
// A block attends up to 8 query heads of one (request, kv head), heads that
// share its K/V: the whole GQA group when G <= 8, else 8 heads a block.
// Its W warps split the key range [0, n) among themselves: the range is cut
// into 32-key tiles, tile t belongs to warp t % W, and each warp runs its
// own online softmax over its tiles. At the end the W partials are merged
// in shared memory, warp 0 first, inside the same launch: no second
// kernel, no atomics, no scratch tensor. The tiles and their owners depend
// only on n (and on W, fixed by dtype and D), never on the slab length,
// the page size or the page order, so on the same logical cache the two
// kernels do the same arithmetic in the same order and give the same bits.
// A warp with no tile contributes m = -1e30, l = 0, o = 0: exactly nothing.
//
// Loads: each warp keeps a ring of 2-3 stages of K/V tiles in shared
// memory, filled by 16-byte cp.async.cg copies (keys past n zero-filled),
// so tile t + 1 is in flight while tile t is computed. K and V stay in
// their own dtype in shared memory. Rows are padded by 16 bytes, so the 8
// row addresses of one ldmatrix, or the 8 lanes of one 16-byte load, fall
// in 8 distinct bank groups.
//
// Arithmetic, by dtype:
// - bf16 (the serving path): mma.sync m16n8k16 with fp32 sums, keys on
//   the M side. S^T = K Q^T puts a tile's 32 keys on M and the 8 heads on
//   N, which they fill exactly; O^T = V^T P^T puts D on M. A lane's score
//   columns and output columns are the same two heads, so the softmax state
//   stays in registers, two heads a lane. P goes to bf16 for P V (through
//   a 512-byte (key, head) tile in shared memory, read back by
//   ldmatrix.trans), as in FlashAttention-2; l sums the fp32 p. A group of
//   G < 8 heads leaves N columns unused, masked and never stored.
// - fp32: FMAs on the CUDA cores, within 2e-5 of the plain version. Lane j
//   dots key j of the tile with the R query rows (R = G rounded up to a
//   power of two, at most 8), read from shared memory as fp32 broadcasts;
//   for P V lane l owns 2 or 4 output dims of its rows.
// At the decode step's shape (G 8, D 64, ~272 keys, 64 requests x 4 kv
// heads) the launch moves 17.8 MB of K/V (5.3 us at 3.35 TB/s) and does
// ~140 MFLOP; the tensor cores take the arithmetic off the loads' way.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace moska {

constexpr int kDecKeys = 32;        // keys per warp tile
constexpr int kDecRows = 8;         // query heads a block attends, at most
constexpr int kDecMaxGroup = 64;    // query heads per kv head the kernels take

// bytes of one padded K or V row in a stage, and of one stage (32 K rows,
// then 32 V rows)
template <typename T, int D>
__host__ __device__ constexpr int dec_ld() {
  return D * (int)sizeof(T) + 16;
}
template <typename T, int D>
__host__ __device__ constexpr int dec_stage_bytes() {
  return 2 * kDecKeys * dec_ld<T, D>();
}

// warps of a block and stages of each warp's ring: 3 stages where a stage
// is at most 6 KB, else 2; 2 warps where a stage exceeds 17 KB (fp32
// D 128). The decode step's bf16 D 64 block holds 75 KB: two blocks an SM.
template <typename T, int D>
__host__ __device__ constexpr int dec_warps() {
  return dec_stage_bytes<T, D>() > 17 * 1024 ? 2 : 4;
}
template <typename T, int D>
__host__ __device__ constexpr int dec_stages() {
  return dec_stage_bytes<T, D>() > 6 * 1024 ? 2 : 3;
}

// Shared memory of a block: Q; per warp P; per warp its ring, whose head
// also takes the warp's partial for the merge. bf16: Q (8, D + 8) and P
// (32 keys, 8 heads) in bf16. fp32: Q (R, D) and P (R, 32) fp32, plus 8
// rescale factors a warp.
template <typename T, int D, int R>
__host__ __device__ constexpr int dec_smem_bytes() {
  return (std::is_same<T, float>::value
              ? R * D * 4 + dec_warps<T, D>() * (R * kDecKeys + 8) * 4
              : kDecRows * (D + 8) * 2 +
                    dec_warps<T, D>() * kDecKeys * kDecRows * 2) +
         dec_warps<T, D>() * dec_stages<T, D>() * dec_stage_bytes<T, D>();
}

// K/V of one (request, kv head) in a slab: key p, dim d at k[p * stride + d]
// (kv head applied to the base pointers). issue(stage, t0, n) starts this
// lane's share of the copies of keys [t0, t0 + 32) into the stage.
template <typename T, int D>
struct SlabKV {
  const T* __restrict__ k;
  const T* __restrict__ v;
  long stride;  // KH * D

  __device__ __forceinline__ void issue(char* stage, int t0, int n) const {
    constexpr int kE = 16 / (int)sizeof(T);  // elements of a 16-byte copy
    constexpr int kChunks = D / kE;          // copies of a row
    constexpr int LD = dec_ld<T, D>();
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = lane; i < kDecKeys * kChunks; i += 32) {
      const int j = i / kChunks, c = i % kChunks;
      const bool in = t0 + j < n;
      const long o = (in ? (long)(t0 + j) * stride : 0) + c * kE;
      cp_async16(stage + j * LD + c * 16, k + o, in ? 16 : 0);
      cp_async16(stage + (kDecKeys + j) * LD + c * 16, v + o, in ? 16 : 0);
    }
  }
};

// K/V of one (request, kv head) in a page pool (N, bs, KH, D): key p is
// row p % bs of page table[p / bs] (kv head applied to the base pointers).
// A tile's 32 keys span at most 32 pages: lane i reads the table entry of
// the tile's i-th page once; lane j turns it into the offset of key j (one
// divide a lane), and each copy takes its key's offset by a shuffle.
template <typename T, int D>
struct PagesKV {
  const T* __restrict__ k;
  const T* __restrict__ v;
  const int32_t* __restrict__ table;  // this request's row of the table
  int bs;
  long page_stride;                   // bs * KH * D
  long row_stride;                    // KH * D

  __device__ __forceinline__ void issue(char* stage, int t0, int n) const {
    constexpr int kE = 16 / (int)sizeof(T);
    constexpr int kChunks = D / kE;
    constexpr int LD = dec_ld<T, D>();
    const int lane = threadIdx.x & 31;
    const int p0 = t0 / bs;
    const int page = p0 + lane <= (n - 1) / bs ? table[p0 + lane] : 0;
    // lane j: the offset of key t0 + j (0 past n)
    const int pos = t0 + lane;
    const int id = __shfl_sync(0xffffffffu, page, pos < n ? pos / bs - p0 : 0);
    const long key = pos < n ? (long)id * page_stride + (long)(pos % bs) *
                                   row_stride : 0;
#pragma unroll
    for (int i = lane; i < kDecKeys * kChunks; i += 32) {
      const int j = i / kChunks, c = i % kChunks;
      const bool in = t0 + j < n;
      const long o = __shfl_sync(0xffffffffu, key, j) + c * kE;
      cp_async16(stage + j * LD + c * 16, k + o, in ? 16 : 0);
      cp_async16(stage + (kDecKeys + j) * LD + c * 16, v + o, in ? 16 : 0);
    }
  }
};

// Merge the W warps' partials, warp 0 first, and write the block's `rows`
// heads: out[r * D + d] (normalised, in T) and lse[r]. Warp w's partial
// sits at rings + w * stride: m (R), l (R), o (R, D), with m in log2 units
// when kLog2. The caller has synchronised the block.
template <typename T, int D, int R, int W, bool kLog2>
__device__ __forceinline__ void merge_parts(const char* rings, int stride,
                                            int rows, T* __restrict__ out,
                                            float* __restrict__ lse) {
  auto part = [&](int w) {
    return reinterpret_cast<const float*>(rings + w * stride);
  };
  auto weight = [](float x) { return kLog2 ? exp2f(x) : expf(x); };
  for (int i = threadIdx.x; i < rows * D + rows; i += W * 32) {
    const int g = i < rows * D ? i / D : i - rows * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, part(w)[g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* pw = part(w);
      const float f = weight(pw[g] - mx);
      den = fmaf(pw[R + g], f, den);
      if (i < rows * D) num = fmaf(pw[2 * R + i], f, num);
    }
    if (i < rows * D)
      out[i] = from_f<T>(num / fmaxf(den, 1e-37f));
    else
      lse[g] = (kLog2 ? mx * kLn2 : mx) + logf(fmaxf(den, 1e-37f));
  }
}

// The bf16 body, on tensor cores (see the head of this file).
template <int D, typename KV>
__device__ __forceinline__ void decode_rows_mma(
    const __nv_bfloat16* __restrict__ q, int rows, const KV& kv, int n,
    float scale, __nv_bfloat16* __restrict__ out, float* __restrict__ lse) {
  using T = __nv_bfloat16;
  constexpr int W = dec_warps<T, D>();
  constexpr int S = dec_stages<T, D>();
  constexpr int SB = dec_stage_bytes<T, D>();
  constexpr int LD = dec_ld<T, D>() / 2;  // stage row, in elements
  constexpr int QLD = D + 8;              // Q row, in elements

  extern __shared__ __align__(16) char dec_smem[];
  T* qs = reinterpret_cast<T*>(dec_smem);
  T* ps_all = qs + kDecRows * QLD;
  char* rings = reinterpret_cast<char*>(ps_all + W * kDecKeys * kDecRows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  T* ps = ps_all + warp * kDecKeys * kDecRows;  // P (32 keys, 8 heads)
  char* ring = rings + warp * S * SB;

  // Q, with zero rows past `rows`; loaded before n is used, so the two
  // loads overlap
  for (int i = tid; i < kDecRows * D; i += W * 32) {
    const int r = i / D;
    qs[r * QLD + i % D] = r < rows ? q[i] : __float2bfloat16(0.f);
  }
  // the partition: tiles of [0, n), tile t to warp t % W
  const int nt = (n + kDecKeys - 1) / kDecKeys;
  const int mine = warp < nt ? (nt - 1 - warp) / W + 1 : 0;
  auto tile0 = [&](int it) { return (warp + it * W) * kDecKeys; };
  // prologue: this warp's first S - 1 tiles, one group each (empty
  // groups keep the count uniform)
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < mine) kv.issue(ring + s * SB, tile0(s), n);
    cp_async_commit();
  }
  __syncthreads();

  // Q^T as the B operand of S^T = K Q^T: b0 = Q[g][16 kk + 2t, +1],
  // b1 = Q[g][16 kk + 2t + 8, +9]
  uint32_t qb[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const T* qr = qs + g * QLD + 16 * kk + 2 * t;
    qb[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
    qb[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
  }
  const float scale_log2 = scale * kLog2e;
  // heads 2t and 2t + 1: running max (log2 units, complete in every lane)
  // and this lane's share of the denominator
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 16][4];  // O^T: dims 16 dm + g (+8), heads 2t, 2t + 1
#pragma unroll
  for (int dm = 0; dm < D / 16; ++dm)
    o[dm][0] = o[dm][1] = o[dm][2] = o[dm][3] = 0.f;

  for (int it = 0; it < mine; ++it) {
    // tile it has landed for every lane, and every lane is done with tile
    // it - 1, whose stage the next copy refills, and with P
    cp_async_wait<S - 2>();
    __syncwarp();
    if (it + S - 1 < mine)
      kv.issue(ring + ((it + S - 1) % S) * SB, tile0(it + S - 1), n);
    cp_async_commit();
    const T* ks = reinterpret_cast<const T*>(ring + (it % S) * SB);
    const T* vs = ks + kDecKeys * LD;
    const int t0 = tile0(it);

    // S^T (32 keys x 8 heads) in two 16-key blocks: entry e of block mt
    // is key 16 mt + g + 8 (e / 2), head 2t + e % 2
    float s[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      s[mt][0] = s[mt][1] = s[mt][2] = s[mt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, ks + (16 * mt + (lane & 15)) * LD + 16 * kk +
                       (lane >> 4) * 8);
        mma_bf16(s[mt], a, qb[kk][0], qb[kk][1]);
      }
    }

    // online softmax of heads 2t, 2t + 1 over the tile's keys (the 8
    // lanes of one t hold all 32); keys past n score -1e30
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 16 * mt + g + 8 * (e >> 1);
        const float x = key < n ? s[mt][e] * scale_log2 : kNegInf;
        s[mt][e] = x;
        mx[e & 1] = fmaxf(mx[e & 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[mt][e] - m[e & 1]);
        l[e & 1] += p;
        s[mt][e] = p;
      }
      // P in bf16, (key, head) rows of 16 bytes
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<uint32_t*>(ps + (16 * mt + g + 8 * hi) * kDecRows +
                                     2 * t) =
            pack_bf16(s[mt][2 * hi], s[mt][2 * hi + 1]);
    }
    __syncwarp();
    // P^T as the B operand of O^T += V^T P^T: pb[2 ks], pb[2 ks + 1] for
    // keys 16 ks .. 16 ks + 15
    uint32_t pb[4];
    ldsm_x4_t(pb, ps + lane * kDecRows);

#pragma unroll
    for (int dm = 0; dm < D / 16; ++dm) {
      o[dm][0] *= corr[0];
      o[dm][1] *= corr[1];
      o[dm][2] *= corr[0];
      o[dm][3] *= corr[1];
#pragma unroll
      for (int kst = 0; kst < 2; ++kst) {
        uint32_t a[4];  // V^T: dims 16 dm .., keys 16 kst ..
        ldsm_x4_t(a, vs + (16 * kst + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         16 * dm + ((lane >> 3) & 1) * 8);
        mma_bf16(o[dm], a, pb[2 * kst], pb[2 * kst + 1]);
      }
    }
  }
  // no copy may be in flight, and no lane may still read the ring, when
  // the ring's head takes this warp's partial
  cp_async_wait<0>();
  __syncwarp();
  float* part = reinterpret_cast<float*>(ring);  // m (8), l (8), o (8, D)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
    if (g == 0) {
      part[2 * t + h] = m[h];
      part[kDecRows + 2 * t + h] = l[h];
    }
  }
#pragma unroll
  for (int dm = 0; dm < D / 16; ++dm)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[2 * kDecRows + (2 * t + (e & 1)) * D + 16 * dm + g + 8 * (e >> 1)] =
          o[dm][e];
  __syncthreads();
  merge_parts<T, D, kDecRows, W, true>(rings, S * SB, rows, out, lse);
}

// N consecutive floats (8 or 16 bytes)
template <int N>
__device__ __forceinline__ void load_f(const float* p, float (&f)[N]) {
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x;
    f[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      f[i] = x.x;
      f[i + 1] = x.y;
      f[i + 2] = x.z;
      f[i + 3] = x.w;
    }
  }
}

// The fp32 body, on the CUDA cores (see the head of this file); R rows.
template <int D, int R, typename KV>
__device__ __forceinline__ void decode_rows_fma(const float* __restrict__ q,
                                                int rows, const KV& kv, int n,
                                                float scale,
                                                float* __restrict__ out,
                                                float* __restrict__ lse) {
  using T = float;
  constexpr int W = dec_warps<T, D>();
  constexpr int S = dec_stages<T, D>();
  constexpr int SB = dec_stage_bytes<T, D>();
  constexpr int LD = dec_ld<T, D>() / 4;  // stage row, in elements
  // P V ownership: lane l holds dims [d0, d0 + kDL) of rows set + kSets i
  constexpr int kLanesD = D / 2 < 32 ? D / 2 : 32;  // lanes across D
  constexpr int kDL = D / kLanesD;                  // dims a lane holds
  constexpr int kSets = 32 / kLanesD;               // row sets of a warp
  constexpr int kRPL = (R + kSets - 1) / kSets;     // rows a lane holds

  extern __shared__ __align__(16) char dec_smem[];
  float* qs = reinterpret_cast<float*>(dec_smem);
  float* ps_all = qs + R * D;
  char* rings = reinterpret_cast<char*>(ps_all + W * (R * kDecKeys + 8));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ps = ps_all + warp * (R * kDecKeys + 8);  // P (R, 32)
  float* corr_s = ps + R * kDecKeys;               // rescale of each row
  char* ring = rings + warp * S * SB;

  for (int i = tid; i < R * D; i += W * 32) qs[i] = i < rows * D ? q[i] : 0.f;
  const int nt = (n + kDecKeys - 1) / kDecKeys;
  const int mine = warp < nt ? (nt - 1 - warp) / W + 1 : 0;
  auto tile0 = [&](int it) { return (warp + it * W) * kDecKeys; };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < mine) kv.issue(ring + s * SB, tile0(s), n);
    cp_async_commit();
  }
  __syncthreads();

  float m[R], l[R];  // row max (warp-uniform) and this lane's partial sum
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  const int d0 = (lane % kLanesD) * kDL;
  const int set = lane / kLanesD;
  float acc[kRPL][kDL];
#pragma unroll
  for (int i = 0; i < kRPL; ++i)
#pragma unroll
    for (int e = 0; e < kDL; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < mine; ++it) {
    cp_async_wait<S - 2>();
    __syncwarp();
    if (it + S - 1 < mine)
      kv.issue(ring + ((it + S - 1) % S) * SB, tile0(it + S - 1), n);
    cp_async_commit();
    const float* ks = reinterpret_cast<const float*>(ring + (it % S) * SB);
    const float* vs = ks + kDecKeys * LD;

    // scores of key `lane` against the R rows
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      float kf[4];
      load_f<4>(ks + lane * LD + 4 * c, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(qs + r * D + 4 * c);
        s[r] = fmaf(x.x, kf[0], s[r]);
        s[r] = fmaf(x.y, kf[1], s[r]);
        s[r] = fmaf(x.z, kf[2], s[r]);
        s[r] = fmaf(x.w, kf[3], s[r]);
      }
    }

    // online softmax: the tile's max over the warp, P into shared memory
    const bool live = tile0(it) + lane < n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = live ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float c = expf(m[r] - m_new);
      const float p = expf(x - m_new);
      l[r] = l[r] * c + p;
      m[r] = m_new;
      ps[r * kDecKeys + lane] = p;
      if (lane == 0) corr_s[r] = c;
    }
    __syncwarp();

    // acc = acc * corr + P V, four keys a step
#pragma unroll
    for (int i = 0; i < kRPL; ++i) {
      const int r = set + kSets * i;
      const float c = r < R ? corr_s[r] : 0.f;
#pragma unroll
      for (int e = 0; e < kDL; ++e) acc[i][e] *= c;
    }
#pragma unroll 2
    for (int j = 0; j < kDecKeys; j += 4) {
      float vv[4][kDL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) load_f<kDL>(vs + (j + jj) * LD + d0, vv[jj]);
#pragma unroll
      for (int i = 0; i < kRPL; ++i) {
        const int r = set + kSets * i;
        if (r < R) {
          const float4 p = *reinterpret_cast<const float4*>(
              ps + r * kDecKeys + j);
#pragma unroll
          for (int e = 0; e < kDL; ++e) {
            float a = acc[i][e];
            a = fmaf(p.x, vv[0][e], a);
            a = fmaf(p.y, vv[1][e], a);
            a = fmaf(p.z, vv[2][e], a);
            a = fmaf(p.w, vv[3][e], a);
            acc[i][e] = a;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();
  float* part = reinterpret_cast<float*>(ring);  // m (R), l (R), o (R, D)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lr = warp_sum(l[r]);
    if (lane == 0) {
      part[r] = m[r];
      part[R + r] = lr;
    }
  }
#pragma unroll
  for (int i = 0; i < kRPL; ++i) {
    const int r = set + kSets * i;
    if (r < R)
#pragma unroll
      for (int e = 0; e < kDL; ++e) part[2 * R + r * D + d0 + e] = acc[i][e];
  }
  __syncthreads();
  merge_parts<T, D, R, W, false>(rings, S * SB, rows, out, lse);
}

// Attend `rows` (1..R) query heads, q[r * D + d], to keys [0, n) that `kv`
// reads; write out[r * D + d] (normalised, in T) and lse[r]. Every thread
// of the block (dec_warps * 32) must call it, with dec_smem_bytes<T, D, R>()
// of dynamic shared memory; bf16 takes R = 8.
template <typename T, int D, int R, typename KV>
__device__ __forceinline__ void decode_rows(const T* __restrict__ q, int rows,
                                            const KV& kv, int n, float scale,
                                            T* __restrict__ out,
                                            float* __restrict__ lse) {
  if constexpr (std::is_same<T, float>::value)
    decode_rows_fma<D, R>(q, rows, kv, n, scale, out, lse);
  else
    decode_rows_mma<D>(q, rows, kv, n, scale, out, lse);
}

}  // namespace moska
