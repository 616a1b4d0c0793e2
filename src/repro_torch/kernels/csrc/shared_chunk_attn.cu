// Shared KV Attention: the paper's GEMM (Fig. 2a) for Hopper, over a bf16
// or fp32 store and over an int8 store.
//
// Replaces two TPU kernels of src/repro/kernels/shared_chunk_attn.py:
// shared_chunk_attention (_kernel) and shared_chunk_attention_q8
// (_kernel_q8). Every query dispatched to shared chunk e (cap slots, each
// with the G query heads of one kv head) attends to that chunk's C keys,
// non-causally; rows whose qmask is false get out 0 and lse -1e30. The
// int8 entry reads int8 K/V and one f32 scale per (token, kv head).
//
// Output dtype: qd's, for both entries. For bf16 queries (how the serving
// path runs) that is the TPU q8 kernel's contract, which always writes
// bf16; for fp32 queries the int8 entry writes fp32, so an fp32 model over
// an int8 store computes what the reference's fp32 model path computes
// (dequantize in fp32, then the fp kernel).
//
// What bounds it on the H100: the (chunk, kv head) K/V tile is read once
// per block and reused by up to 64 query rows, so at the serving shapes
// (cap * G = 256 rows per chunk and kv head, C = 2048, D = 64) the work
// does about 64 flops per K/V byte a block, under the card's ~295 bf16
// flops/byte balance: HBM bytes bound it, and the tensor cores must keep
// the products off the critical path. At the routed prefill shape
// (cap = 1024, 0-2 valid slots of 128 queries per chunk) most row tiles
// are empty, and writing their masked output (0, -1e30) is most of the
// bytes.
//
// Two kernels, chosen by the queries' dtype (not a fallback: each dtype
// has exactly one kernel, and a failed launch raises):
//  - bf16 queries (the serving path), both entries: shared_chunk_mma_kernel,
//    bf16 tensor cores (mma.sync m16n8k16, fp32 sums) over K/V tiles
//    copied by cp.async into a ring of stages (mma_tile.cuh). An int8
//    tile is widened to bf16 in shared memory (exact); k_scale multiplies
//    the score columns and v_scale the probabilities, in fp32, before P
//    is rounded to bf16 for P V. One block per (64-row tile, kv head,
//    chunk), 4 warps of 16 rows.
//  - fp32 queries: shared_chunk_attn_kernel, fp32 CUDA-core loops
//    (attn_tile.cuh). The tensor cores have no fp32 mode that keeps the
//    fp32 path within 2e-5 of the plain version (TF32 keeps about three
//    digits), so fp32 stays exact there; the int8 entry dequantizes
//    k_int8 * k_scale in fp32 as each tile is staged (attn_tile.cuh::Q8KV).
//
// shared_tail_attention (a third entry; it replaces no TPU kernel: the
// reference has no sliding-window layer over a store, and the port's
// plain version is kernels/ref.py::shared_tail_attention_ref): a
// sliding-window layer of a model served over a shared document sees only
// the document's last W - 1 keys, the tail, and every query of a decode
// step or of a prefill sees some suffix of it: row n keys first[n] ..
// T - 1. So all rows share one tail, read once per (row tile, kv head),
// in one tensor-core call (shared_tail_mma_kernel, the same loop under
// the KeysFrom mask of mma_tile.cuh). A block visits the keys from the
// smallest first of its rows; a block none of whose rows sees a key
// writes out 0 and lse -inf and exits. What bounds it at the served
// shapes (256 or up to 512 rows, H 32 over KH 4, D 128, T 2,047, every
// row seeing 1,024 keys or more): operations, as for the prefill kernel:
// a 64-row tile does 64 x 4 x D operations for each 4 D bytes of K/V.
//
// Dispatch fills each chunk's slots from position 0, so the valid rows
// are a prefix; a tile with no valid row writes the masked result (16
// bytes a store in the bf16 kernel) and exits, so only routed work is
// computed. wgmma, TMA and warp specialisation come in later versions.
#include "attn_tile.cuh"
#include "mma_tile.cuh"

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
  // the tensor-core kernel's view of one (chunk, kv head)
  template <int D>
  using MmaSeq = StridedQ8KV<D>;
  template <int D>
  __device__ __forceinline__ StridedQ8KV<D> mma_seq(int e, int kh, int C,
                                                    int KH) const {
    const long s = (long)e * C * KH + kh;
    return StridedQ8KV<D>{k + s * D, v + s * D, k_scale + s, v_scale + s,
                          (long)KH * D, (long)KH};
  }
};

// the bf16 store's chunks (E, C, KH, D), as the tensor-core kernel reads
// them
struct ChunksBf16 {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  template <int D>
  using MmaSeq = StridedBf16KV<D>;
  template <int D>
  __device__ __forceinline__ StridedBf16KV<D> mma_seq(int e, int kh, int C,
                                                      int KH) const {
    const long o = ((long)e * C * KH + kh) * D;
    return StridedBf16KV<D>{k + o, v + o, (long)KH * D};
  }
};

// out/lse offset of tile row `row` of (chunk e, kv head kh): row is
// (slot c, group head g) = divmod(row, G)
__device__ __forceinline__ long row_offset(int e, int kh, int row, int cap,
                                           int H, int G) {
  return ((long)e * cap + row / G) * H + kh * G + row % G;
}

// bf16 queries, both entries: see the note at the top and mma_tile.cuh.
// At least 2 blocks an SM (what shared memory allows at D = 128): without
// that hint ptxas held the D = 32 variant to 96 registers and spilled.
template <int D, typename Chunks>
__global__ void __launch_bounds__(kMmaThreads, 2)
    shared_chunk_mma_kernel(const __nv_bfloat16* __restrict__ qd,
                            const Chunks chunks,
                            const uint8_t* __restrict__ qmask,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int cap, int H, int KH,
                            int C, float scale_log2) {
  using Src = typename Chunks::template MmaSeq<D>;
  constexpr int LD = mma_ld<D>();
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) char mma_smem[];
  const int G = H / KH;
  const int kh = blockIdx.y;
  const int e = blockIdx.z;
  const int row0 = blockIdx.x * kMmaRows;
  const int rows = min(kMmaRows, cap * G - row0);
  const int tid = threadIdx.x;
  const uint8_t* mask = qmask + (long)e * cap;

  int mine = 0;
  for (int r = tid; r < rows; r += kMmaThreads) mine |= mask[(row0 + r) / G];
  if (!__syncthreads_or(mine)) {
    // no valid slot: the masked result, 16 bytes a store
    for (int i = tid; i < rows * kChunks; i += kMmaThreads) {
      const long o = row_offset(e, kh, row0 + i / kChunks, cap, H, G);
      *reinterpret_cast<uint4*>(out + o * D + (i % kChunks) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    for (int r = tid; r < rows; r += kMmaThreads)
      lse[row_offset(e, kh, row0 + r, cap, H, G)] = kNegInf;
    return;
  }

  // Q tile: rows past `rows` are zero (their scores are computed and
  // never stored)
  auto* sq = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  for (int i = tid; i < kMmaRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < rows;
    const long o = row_offset(e, kh, row0 + (in ? r : 0), cap, H, G);
    cp_async16(sq + r * LD + c * 8, qd + o * D + c * 8, in ? 16 : 0);
  }
  cp_async_commit();
  char* ring = mma_smem + mma_tile_bytes<D>();
  char* scratch = ring + mma_stages<D>() * Src::kStageBytes;
  MmaRows<D> acc;
  attend_rows_mma<D>(sq, ring, scratch,
                     chunks.template mma_seq<D>(e, kh, C, KH), 0, C,
                     KeysBelow{C}, scale_log2, acc);

  // epilogue: lane holds rows g and g + 8 of its warp's 16, columns
  // 8 b + 2 t + 0,1 of each column block b
  const int lane = tid & 31;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (tid >> 5) * 16 + (lane >> 2) + 8 * h;
    if (r >= rows) continue;
    const int row = row0 + r;
    const long o = row_offset(e, kh, row, cap, H, G);
    const bool valid = mask[row / G];
    const float l = fmaxf(acc.l[0][h], 1e-37f);
    const float inv = valid ? 1.f / l : 0.f;
    __nv_bfloat16* orow = out + o * D + 2 * t;
#pragma unroll
    for (int b = 0; b < D / 8; ++b)
      *reinterpret_cast<uint32_t*>(orow + 8 * b) =
          pack_bf16(acc.o[0][b][2 * h] * inv, acc.o[0][b][2 * h + 1] * inv);
    if (t == 0) lse[o] = valid ? acc.m[0][h] * kLn2 + logf(l) : kNegInf;
  }
}

// The shared tail: q (N, H, D) against one tail k, v (T, KH, D), row n
// seeing keys first[n] .. T - 1 (see the note at the top). One block per
// (64-row tile of (row, group head), kv head), 4 warps of 16 rows.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
    shared_tail_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ first,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int N, int H, int KH,
                           int T, float scale_log2) {
  constexpr int LD = mma_ld<D>();
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) char mma_smem[];
  __shared__ int s_lo, s_hi;
  const float kInf = __int_as_float((int)0x7f800000);
  const int G = H / KH;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.x * kMmaRows;
  const int rows = min(kMmaRows, N * G - row0);
  const int tid = threadIdx.x;
  const int p_first = row0 / G;
  const int p_last = (row0 + rows - 1) / G;
  auto lo_of = [&](int p) { return min(max(first[p], 0), T); };

  // the keys the block visits: from the smallest first of its rows; keys
  // from the largest on count for every row
  if (tid == 0) {
    s_lo = T;
    s_hi = 0;
  }
  __syncthreads();
  for (int p = p_first + tid; p <= p_last; p += kMmaThreads) {
    const int lo = lo_of(p);
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, lo);
  }
  __syncthreads();
  const int k0 = s_lo;
  if (k0 >= T) {
    // no row sees a key: out 0, lse -inf, 16 bytes a store
    for (int i = tid; i < rows * kChunks; i += kMmaThreads) {
      const long o = row_offset(0, kh, row0 + i / kChunks, N, H, G);
      *reinterpret_cast<uint4*>(out + o * D + (i % kChunks) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    for (int r = tid; r < rows; r += kMmaThreads)
      lse[row_offset(0, kh, row0 + r, N, H, G)] = -kInf;
    return;
  }

  // Q tile: rows past `rows` are zero (their scores are computed and
  // never stored)
  auto* sq = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  for (int i = tid; i < kMmaRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < rows;
    const long o = row_offset(0, kh, row0 + (in ? r : 0), N, H, G);
    cp_async16(sq + r * LD + c * 8, q + o * D + c * 8, in ? 16 : 0);
  }
  cp_async_commit();

  const int lane = tid & 31;
  KeysFrom mask;
  mask.full_lo = s_hi;
  mask.n = T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (tid >> 5) * 16 + (lane >> 2) + 8 * h;
    mask.lo[h] = lo_of(min((row0 + r) / G, p_last));
  }
  char* ring = mma_smem + mma_tile_bytes<D>();
  const StridedBf16KV<D> src{k + (long)kh * D, v + (long)kh * D,
                             (long)KH * D};
  MmaRows<D> acc;
  attend_rows_mma<D>(sq, ring, nullptr, src, k0, T, mask, scale_log2, acc);

  // epilogue: lane holds rows g and g + 8 of its warp's 16, columns
  // 8 b + 2 t + 0,1 of each column block b
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (tid >> 5) * 16 + (lane >> 2) + 8 * h;
    if (r >= rows) continue;
    const int row = row0 + r;
    const long o = row_offset(0, kh, row, N, H, G);
    const bool seen = lo_of(row / G) < T;
    const float l = fmaxf(acc.l[0][h], 1e-37f);
    const float inv = seen ? 1.f / l : 0.f;
    __nv_bfloat16* orow = out + o * D + 2 * t;
#pragma unroll
    for (int b = 0; b < D / 8; ++b)
      *reinterpret_cast<uint32_t*>(orow + 8 * b) =
          pack_bf16(acc.o[0][b][2 * h] * inv, acc.o[0][b][2 * h + 1] * inv);
    if (t == 0) lse[o] = seen ? acc.m[0][h] * kLn2 + logf(l) : -kInf;
  }
}

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

template <int D, typename Chunks>
cudaError_t launch_mma(const void* qd, const Chunks& chunks,
                       const void* qmask, void* out, void* lse, int E,
                       int cap, int H, int KH, int C, cudaStream_t stream) {
  constexpr int smem =
      mma_smem_bytes<D, typename Chunks::template MmaSeq<D>>();
  auto kern = shared_chunk_mma_kernel<D, Chunks>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int G = H / KH;
  dim3 grid((cap * G + kMmaRows - 1) / kMmaRows, KH, E);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qd), chunks,
      static_cast<const uint8_t*>(qmask), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), cap, H, KH, C, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

// the tensor-core kernel copies and stores 16 bytes at a time (the int8
// store's scales 4)
bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename Chunks>
cudaError_t dispatch_mma(int D, const void* qd, const Chunks& chunks,
                         const void* qmask, void* out, void* lse, int E,
                         int cap, int H, int KH, int C, cudaStream_t stream) {
  if (!aligned(qd, 16) || !aligned(out, 16) || !aligned(chunks.k, 16) ||
      !aligned(chunks.v, 16))
    return cudaErrorMisalignedAddress;
  switch (D) {
    case 16: return launch_mma<16>(qd, chunks, qmask, out, lse, E, cap, H, KH, C, stream);
    case 32: return launch_mma<32>(qd, chunks, qmask, out, lse, E, cap, H, KH, C, stream);
    case 64: return launch_mma<64>(qd, chunks, qmask, out, lse, E, cap, H, KH, C, stream);
    case 128: return launch_mma<128>(qd, chunks, qmask, out, lse, E, cap, H, KH, C, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_tail(const void* q, const void* k, const void* v,
                        const void* first, void* out, void* lse, int N,
                        int H, int KH, int T, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D, StridedBf16KV<D>>();
  auto kern = shared_tail_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long rows = (long)N * (H / KH);
  dim3 grid((unsigned)((rows + kMmaRows - 1) / kMmaRows), KH);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(first),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), N, H, KH,
      T, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace
}  // namespace moska

// q (N, H, D) bf16; k, v (T, KH, D) bf16; first (N,) int32; out (N, H, D)
// bf16; lse (N, H) fp32 (-inf for a row that sees no key).
extern "C" int moska_shared_tail_attn(const void* q, const void* k,
                                      const void* v, const void* first,
                                      void* out, void* lse, int N, int H,
                                      int KH, int D, int T, void* stream) {
  using namespace moska;
  if (H % KH || N < 1 || T < 1) return cudaErrorInvalidValue;
  if (!aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16) ||
      !aligned(out, 16))
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_tail<64>(q, k, v, first, out, lse, N, H, KH, T, st);
    case 128: return launch_tail<128>(q, k, v, first, out, lse, N, H, KH, T, st);
    default: return cudaErrorInvalidValue;
  }
}

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
    const ChunksBf16 ch{static_cast<const __nv_bfloat16*>(k),
                        static_cast<const __nv_bfloat16*>(v)};
    return dispatch_mma(D, qd, ch, qmask, out, lse, E, cap, H, KH, C, st);
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
  if (dtype == kBF16) {
    if (!aligned(k_scale, 4) || !aligned(v_scale, 4))
      return cudaErrorMisalignedAddress;
    return dispatch_mma(D, qd, ch, qmask, out, lse, E, cap, H, KH, C, st);
  }
  return cudaErrorInvalidValue;
}
