// Causal prefill attention for Hopper: the unique attention of every
// admission prefill, prefill chunk and corpus registration, in bf16 on
// tensor cores.
//
// Replaces no TPU kernel: the reference computes this attention in jnp
// (src/repro/models/layers.py::flash_attention, a key-blocked online
// softmax that XLA compiles), and the port's plain version is that loop
// (kernels/ref.py::flash_prefill_attention_ref), blocked over queries too.
// It was added because that loop is the last attention of the port off
// the tensor cores: each (query block, key block) pair became an fp32
// score tensor of B x H x 1,024 x 1,024 and about ten full-size ops on it,
// with both products as fp32 FFMA GEMMs.
//
// It computes what flash_prefill_attention_ref computes: q (B, Sq, H, D)
// against k, v (B, Sk, KH, D), bf16; query i at position q_offset + i,
// key j at kv_offset + j; key j counts for query i where it is causal
// (kv_offset + j <= q_offset + i), inside the window (window > 0:
// kv_offset + j > q_offset + i - window) and below kv_len. Scores are bf16
// products summed in fp32 times 1/sqrt(D), p is rounded to bf16 before
// P V, P V sums in fp32, l is clamped at 1e-37 and lse = m + ln l. A
// masked score is the finite -1e30, so a row with no valid key averages V
// over the keys the plain version visits for it (every key not causally
// skipped for its block_q block of queries, in whole block_k blocks), with
// lse -1e30: the kernel takes block_q and block_k and reproduces that.
//
// What bounds it on the H100: operations, at every served shape. A row
// tile reads each K/V tile once for all G heads of its kv head (rows are
// (position, group head), as shared_chunk_attn.cu packs them), so a block
// of R rows does R x 4 x D operations for each 4 D bytes of K/V: R
// operations a byte out of L2, and the causal band halves the work of a
// square. The design keeps the products on the tensor cores and the
// softmax in registers: the FlashAttention-2 loop of mma_tile.cuh
// (mma.sync m16n8k16, fp32 sums, a cp.async ring of K/V stages). At
// D = 128 a warp holds two 16-row atoms (R = 128), so each K and V
// fragment read from shared memory feeds two products; at D = 64 one
// (R = 64), which measured faster there. Each row tile starts at its first
// row's window and stops at the key tile that holds its last row's
// position; only tiles that cut the band of some row of the tile are
// masked element by element, and the others fold the 1/sqrt(D) scale into
// the exponent's FFMA. Blocks with the most keys start first. wgmma and
// TMA come in later versions.
#include "mma_tile.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

// atoms of 16 query rows a warp: two at D = 128 (each K/V fragment feeds
// both), one at D = 64 (measured faster)
template <int D>
constexpr int prefill_atoms() { return D >= 128 ? 2 : 1; }

// The keys each query position attends, and the plain version's visit.
struct Band {
  int Sq, Sk, causal, q_offset, kv_offset, kv_len, window, block_q, block_k;

  // valid keys of position i: [lo(i), hi(i)), empty when lo >= hi
  __device__ __forceinline__ int lo(int i) const {
    return window > 0 ? max(0, q_offset + i - window + 1 - kv_offset) : 0;
  }
  __device__ __forceinline__ int hi(int i) const {
    const int h = min(Sk, kv_len);
    return causal ? min(h, q_offset + i - kv_offset + 1) : h;
  }
  // keys [0, ext(i)) the plain version visits for position i's block of
  // queries: those a row with no valid key averages
  __device__ __forceinline__ int ext(int i) const {
    if (!causal) return Sk;
    const int q0 = i / block_q * block_q;
    const int last = q_offset + min(q0 + block_q, Sq) - 1 - kv_offset;
    return last < 0 ? 0 : min(Sk, (last / block_k + 1) * block_k);
  }
};

// The mask of this lane's 2 M rows (attend_rows_mma's mask policy): a key
// in [lo, hi) counts; any other is -1e30 below ext (a row with no valid
// key) and -inf past it. Keys [full_lo, full_hi) count for every row of
// the block.
template <int M>
struct BandRows {
  int lo[2 * M], hi[2 * M], ext[2 * M];
  int full_lo, full_hi;
  __device__ __forceinline__ bool full(int t0) const {
    return t0 >= full_lo && t0 + kMmaKeys <= full_hi;
  }
  __device__ __forceinline__ float operator()(int h, int key, float x) const {
    if (key >= lo[h] && key < hi[h]) return x;
    return key < ext[h] ? kNegInf : __int_as_float((int)0xff800000);  // -inf
  }
};

// One block: row tile (position, group head) of one (batch, kv head).
// Blocks are numbered tile-major with the last tiles, which have the most
// keys, first: the card starts the longest work first.
template <int D, int M>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, const Band band, int H,
                             int KH, float scale_log2) {
  constexpr int kRows = kMmaRows * M;
  constexpr int LD = mma_ld<D>();
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) char mma_smem[];
  __shared__ int s_ext;
  const int G = H / KH;
  const int kh = blockIdx.x % KH;
  const int b = blockIdx.y;
  const int row0 = (gridDim.x / KH - 1 - blockIdx.x / KH) * kRows;
  const int rows = min(kRows, band.Sq * G - row0);
  const int tid = threadIdx.x;
  const int p_first = row0 / G;
  const int p_last = (row0 + rows - 1) / G;

  // Q tile: rows past `rows` are zero (their scores are computed and
  // never stored)
  auto* sq = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  for (int i = tid; i < kRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < rows;
    const int row = row0 + (in ? r : 0);
    const long o = ((long)b * band.Sq + row / G) * H + kh * G + row % G;
    cp_async16(sq + r * LD + c * 8, q + o * D + c * 8, in ? 16 : 0);
  }
  cp_async_commit();

  // the keys the block visits: the band of its rows, and from key 0 up to
  // the largest ext of its rows with no valid key, if any
  if (tid == 0) s_ext = 0;
  __syncthreads();
  int none = 0;
  for (int p = p_first + tid; p <= p_last; p += kMmaThreads) {
    if (band.lo(p) >= band.hi(p)) {
      none = 1;
      atomicMax(&s_ext, band.ext(p));
    }
  }
  const bool any_none = __syncthreads_or(none);
  int k0 = band.lo(p_first), n = band.hi(p_last);
  if (any_none) {
    k0 = 0;
    n = max(n, s_ext);
  }
  n = max(n, k0);

  const int lane = tid & 31;
  // tile row of this lane's row h: row g (h even) or g + 8 (h odd) of
  // atom h / 2 of its warp
  auto tile_row = [&](int h) {
    return ((tid >> 5) * M + h / 2) * 16 + (lane >> 2) + 8 * (h & 1);
  };
  BandRows<M> mask;
  mask.full_lo = band.lo(p_last);
  mask.full_hi = any_none ? 0 : band.hi(p_first);
#pragma unroll
  for (int h = 0; h < 2 * M; ++h) {
    const int p = min((row0 + tile_row(h)) / G, p_last);
    mask.lo[h] = band.lo(p);
    mask.hi[h] = band.hi(p);
    mask.ext[h] = mask.lo[h] < mask.hi[h] ? 0 : band.ext(p);
  }

  char* ring = mma_smem + M * mma_tile_bytes<D>();
  const long kv_off = (long)b * band.Sk * KH * D + (long)kh * D;
  const StridedBf16KV<D> src{k + kv_off, v + kv_off, (long)KH * D};
  MmaRows<D, M> acc;
  attend_rows_mma<D, M>(sq, ring, nullptr, src, k0, n, mask, scale_log2, acc);

  // epilogue: lane holds rows g and g + 8 of each of its warp's atoms,
  // columns 8 c + 2 t + 0,1 of each column block c; a row that saw no
  // valid key keeps m = -1e30, and its lse is -1e30 as the plain version's
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2 * M; ++h) {
    const int r = tile_row(h);
    if (r >= rows) continue;
    const int a = h / 2, e = h & 1;
    const int row = row0 + r;
    const long o = ((long)b * band.Sq + row / G) * H + kh * G + row % G;
    const float l = fmaxf(acc.l[a][e], 1e-37f);
    const float inv = 1.f / l;
    __nv_bfloat16* orow = out + o * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c) = pack_bf16(
          acc.o[a][c][2 * e] * inv, acc.o[a][c][2 * e + 1] * inv);
    if (t == 0)
      lse[o] = acc.m[a][e] == kNegInf ? kNegInf
                                      : acc.m[a][e] * kLn2 + logf(l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int KH, const Band& band,
                   cudaStream_t stream) {
  constexpr int M = prefill_atoms<D>(), R = kMmaRows * M;
  constexpr int smem = mma_smem_bytes<D, StridedBf16KV<D>, R>();
  auto kern = flash_prefill_mma_kernel<D, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long rows = (long)band.Sq * (H / KH);
  dim3 grid((unsigned)((rows + R - 1) / R * KH), B);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), band, H, KH, kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
}  // namespace moska

// q (B, Sq, H, D), k, v (B, Sk, KH, D) bf16; out (B, Sq, H, D) bf16;
// lse (B, Sq, H) fp32. causal 0/1; kv_len: keys at or past it never count
// (Sk for none); window 0 for none; block_q, block_k: the plain version's
// blocks (what a row with no valid key averages).
extern "C" int moska_flash_prefill_attn(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int B, int Sq, int Sk, int H, int KH,
                                        int D, int causal, int q_offset,
                                        int kv_offset, int kv_len, int window,
                                        int block_q, int block_k,
                                        void* stream) {
  using namespace moska;
  if (H % KH || B < 1 || B > 65535 || Sq < 1 || Sk < 1 || block_q < 1 ||
      block_k < 1 || window < 0)
    return cudaErrorInvalidValue;
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out))
    return cudaErrorMisalignedAddress;
  const Band band{Sq, Sk, causal, q_offset, kv_offset, kv_len, window,
                  block_q, block_k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, out, lse, B, H, KH, band, st);
    case 128: return launch<128>(q, k, v, out, lse, B, H, KH, band, st);
    default: return cudaErrorInvalidValue;
  }
}
