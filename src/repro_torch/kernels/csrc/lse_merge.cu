// Exact LSE merge of P partial attentions for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lse_merge.py, function
// lse_merge (_kernel): lse is clamped at -1e30, m = max_p lse,
// w_p = exp(lse_p - m), out = sum_p w_p o_p / max(sum_p w_p, 1e-37) and
// lse = m + log sum_p w_p (-1e30 where the sum is 0).
//
// What bounds it on the H100: at the serving shapes (P = 2 or 8 partials of
// 64-256 rows x 32 heads x 64 dims) it moves 0.5-8.4 MB, so launch latency
// and one round trip to HBM bound it; at larger shapes, HBM bytes (a few
// flops per element read).
//
// Its design: one body, three loaders. A group of LPR lanes owns one
// (row, head): at D 64 in bf16 a row is 128 bytes, 8 lanes x 16 bytes.
// Lane i of the group computes the weight of partial i of each batch of 8
// once, and the group shares it by shuffle. A lane issues its 16-byte loads
// of all 8 partials of a batch before it reduces them, and sums the
// partials in the order p = 0, 1, ..., P - 1 whatever the loader, so the
// three entries agree bit for bit on the same partials. The loaders only
// say where partial p of a row lies, or that it is empty (out 0, lse
// -1e30):
//   - dense:  outs (P, N, H, D), lses (P, N, H), the TPU kernel's contract;
//   - pair:   two (N, H, D) partials apart, the unique and the shared
//             partial of a MoSKA layer, with no stacked copy;
//   - routed: the K-chunk merge of batched shared attention, reading
//             partial k of group g straight from row lin[g, k] of the shared
//             kernel's output (R, Q, H, D), a row >= R being a dropped route.
// Rows whose bytes are not a multiple of 16, or whose pointers are not
// 16-byte aligned, take the scalar path of the same body (V = 1).
#include "common.cuh"

namespace moska {
namespace {  // launch helpers are private to this file

constexpr int kMergeThreads = 128;
constexpr int kMergeBatch = 8;  // partials whose loads a lane issues together

// A loader's at(r) gives the partials of output row r: slot(p) is where
// partial p's lse lies in lse(p), and its D elements at D * slot(p) in
// out(p); a slot < 0 is an empty partial.
template <typename T>
struct DenseParts {  // outs (P, N, H, D), lses (P, N, H)
  const T* outs;
  const float* lses;
  long NH;
  struct Row {
    long r, NH;
    __device__ long slot(int p) const { return p * NH + r; }
  };
  __device__ Row at(long r) const { return {r, NH}; }
  __device__ const T* out(int) const { return outs; }
  __device__ const float* lse(int) const { return lses; }
};

template <typename T>
struct PairParts {  // two partials (N, H, D), (N, H)
  const T* o0;
  const T* o1;
  const float* l0;
  const float* l1;
  struct Row {
    long r;
    __device__ long slot(int) const { return r; }
  };
  __device__ Row at(long r) const { return {r}; }
  __device__ const T* out(int p) const { return p ? o1 : o0; }
  __device__ const float* lse(int p) const { return p ? l1 : l0; }
};

template <typename T>
struct RoutedParts {  // od (R, Q, H, D), lsed (R, Q, H), lin (G, K) int64
  const T* od;
  const float* lsed;
  const int64_t* lin;
  long R;
  int K, QH;  // QH = Q * H; output row r = g * QH + (q * H + h)
  struct Row {
    const int64_t* routes;  // lin[g]
    long R;
    int QH, qh;
    __device__ long slot(int p) const {
      const int64_t row = routes[p];
      return row >= 0 && row < R ? row * QH + qh : -1;
    }
  };
  __device__ Row at(long r) const {
    const long g = r / QH;
    return {lin + g * K, R, QH, (int)(r - g * QH)};
  }
  __device__ const T* out(int) const { return od; }
  __device__ const float* lse(int) const { return lsed; }
};

template <class Parts, class Row>
__device__ __forceinline__ float part_lse(const Parts& parts, const Row& row,
                                          int p) {
  const long s = row.slot(p);
  return s < 0 ? kNegInf : fmaxf(parts.lse(p)[s], kNegInf);
}

// V elements per lane access (16 bytes, or 1); LPR lanes per row, >= 8 so
// that a group holds the weights of a whole batch
template <typename T, int V, int LPR, class Parts>
__global__ void __launch_bounds__(kMergeThreads)
    lse_merge_kernel(Parts parts, int P, long rows, int D,
                     T* __restrict__ out, float* __restrict__ lse) {
  static_assert(LPR >= kMergeBatch && LPR <= 32 && (LPR & (LPR - 1)) == 0);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (LPR - 1);          // lane within its row's group
  const int wl = gl & (kMergeBatch - 1);    // its partial within a batch
  const int base = lane - gl;               // first lane of the group
  const long r = ((long)blockIdx.x * kMergeThreads + threadIdx.x) / LPR;
  const bool live = r < rows;  // dead lanes stay for the shuffles
  const auto row = parts.at(live ? r : 0);

  float m = kNegInf;
  if (live)
    for (int p = wl; p < P; p += kMergeBatch)
      m = fmaxf(m, part_lse(parts, row, p));
#pragma unroll
  for (int o = kMergeBatch / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

  const int chunks = D / V;
  for (int c0 = 0; c0 < chunks; c0 += LPR) {  // the same trips in every lane
    const int c = c0 + gl;
    const bool mine = live && c < chunks;
    float acc[V] = {};
    float den = 0.f;
    for (int p0 = 0; p0 < P; p0 += kMergeBatch) {
      const float w_own =
          live && p0 + wl < P ? expf(part_lse(parts, row, p0 + wl) - m) : 0.f;
      vec_t<T, V> raw[kMergeBatch];
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        const long s = mine && p0 + i < P ? row.slot(p0 + i) : -1;
        if (s >= 0)
          raw[i] = load_vec<T, V>(parts.out(p0 + i) + s * D + (long)c * V);
        else if constexpr (V == 1)
          raw[i] = from_f<T>(0.f);  // an empty partial's out is +0
        else
          raw[i] = make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        if (p0 + i < P) {  // P is the same in every lane
          const float w = __shfl_sync(0xffffffffu, w_own, base + i);
          den += w;
          float x[V];
          widen<T, V>(raw[i], x);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(w, x[j], acc[j]);
        }
      }
    }
    if (mine) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] /= fmaxf(den, 1e-37f);
      store_vec<T, V>(out + r * D + (long)c * V, acc);
    }
    if (live && c0 == 0 && gl == 0)
      lse[r] = den > 0.f ? m + logf(fmaxf(den, 1e-37f)) : kNegInf;
  }
}

template <typename T, int V, int LPR, class Parts>
cudaError_t go(const Parts& parts, int P, long rows, int D, void* out,
               void* lse, cudaStream_t stream) {
  const long blocks = (rows * LPR + kMergeThreads - 1) / kMergeThreads;
  lse_merge_kernel<T, V, LPR, Parts><<<(unsigned)blocks, kMergeThreads, 0,
                                       stream>>>(
      parts, P, rows, D, static_cast<T*>(out), static_cast<float*>(lse));
  return cudaGetLastError();
}

// vec: every T pointer 16-byte aligned; the row's bytes are checked here
template <typename T, class Parts>
cudaError_t launch(const Parts& parts, int P, long rows, int D, bool vec,
                   void* out, void* lse, cudaStream_t stream) {
  if (rows <= 0 || P <= 0 || D <= 0) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  if (vec && D % V == 0 && aligned16(out)) {
    const int chunks = D / V;
    if (chunks <= 8) return go<T, V, 8>(parts, P, rows, D, out, lse, stream);
    if (chunks <= 16) return go<T, V, 16>(parts, P, rows, D, out, lse, stream);
    return go<T, V, 32>(parts, P, rows, D, out, lse, stream);
  }
  return go<T, 1, 32>(parts, P, rows, D, out, lse, stream);
}

}  // namespace
}  // namespace moska

// outs (P, N, H, D); lses (P, N, H) fp32 -> out (N, H, D) in the outs
// dtype, lse (N, H) fp32. NH = N * H.
extern "C" int moska_lse_merge(const void* outs, const void* lses, void* out,
                               void* lse, int P, long NH, int D, int dtype,
                               void* stream) {
  using namespace moska;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(outs);
  if (dtype == kF32)
    return launch<float>(
        DenseParts<float>{static_cast<const float*>(outs),
                          static_cast<const float*>(lses), NH},
        P, NH, D, vec, out, lse, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(
        DenseParts<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(outs),
                                  static_cast<const float*>(lses), NH},
        P, NH, D, vec, out, lse, st);
  return cudaErrorInvalidValue;
}

// o0, o1 (N, H, D); l0, l1 (N, H) fp32 -> the merge of the two, as
// moska_lse_merge of the pair stacked (partial 0 first).
extern "C" int moska_lse_merge_pair(const void* o0, const void* l0,
                                    const void* o1, const void* l1,
                                    void* out, void* lse, long NH, int D,
                                    int dtype, void* stream) {
  using namespace moska;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(o0) && aligned16(o1);
  const float* f0 = static_cast<const float*>(l0);
  const float* f1 = static_cast<const float*>(l1);
  if (dtype == kF32)
    return launch<float>(
        PairParts<float>{static_cast<const float*>(o0),
                         static_cast<const float*>(o1), f0, f1},
        2, NH, D, vec, out, lse, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(
        PairParts<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(o0),
                                 static_cast<const __nv_bfloat16*>(o1), f0,
                                 f1},
        2, NH, D, vec, out, lse, st);
  return cudaErrorInvalidValue;
}

// od (R, Q, H, D), lsed (R, Q, H) fp32: the shared kernel's rows; lin
// (G, K) int64: partial k of group g is row lin[g, k], empty if outside
// [0, R) -> out (G * Q, H, D) in the od dtype, lse (G * Q, H) fp32. QH = Q * H.
extern "C" int moska_lse_merge_routed(const void* od, const void* lsed,
                                      const void* lin, void* out, void* lse,
                                      long R, int G, int K, int QH, int D,
                                      int dtype, void* stream) {
  using namespace moska;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(od);
  const float* l = static_cast<const float*>(lsed);
  const int64_t* idx = static_cast<const int64_t*>(lin);
  const long rows = (long)G * QH;
  if (dtype == kF32)
    return launch<float>(
        RoutedParts<float>{static_cast<const float*>(od), l, idx, R, K, QH},
        K, rows, D, vec, out, lse, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(
        RoutedParts<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(od), l,
                                   idx, R, K, QH},
        K, rows, D, vec, out, lse, st);
  return cudaErrorInvalidValue;
}
