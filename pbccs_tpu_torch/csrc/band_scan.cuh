// The circular-lane pieces shared by the kernels (csrc/arrow_fill.cu,
// csrc/quiver_fill.cu, csrc/dense_score.cu): one warp holds one band
// column of W = 32 * NS lanes in a strided layout, lane L = slot * 32 +
// thread, NS slots per thread.  Every roll is by a compile-time distance,
// so it is one __shfl_sync per held slot and a select (or, for a multiple
// of 32, a pure slot rotation), and register arrays are only ever indexed
// by constants.  The arithmetic is the plain versions'
// (ops/fwdbwd_cuda._scan_plain, ops/fwdbwd._affine_scan_circ): built with
// -fmad=false -ftz=true, each product and sum rounds and flushes as there.

#pragma once

#include <cuda_runtime.h>

namespace band_scan {

constexpr unsigned kFull = 0xffffffffu;

// out[L] = in[(L - D) mod W], W = 32 * NS, lane L = slot * 32 + thread.
template <int NS, int D>
__device__ __forceinline__ void roll(const float (&in)[NS], float (&out)[NS],
                                     int tid) {
  constexpr int Q = D / 32, R = D % 32;
  if constexpr (R == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) out[s] = in[((s - Q) % NS + NS) % NS];
  } else {
    float got[NS];
    const int src = (tid - R) & 31;
#pragma unroll
    for (int s = 0; s < NS; ++s) got[s] = __shfl_sync(kFull, in[s], src);
    const bool wrap = tid < R;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      out[s] = wrap ? got[((s - Q - 1) % NS + 2 * NS) % NS]
                    : got[((s - Q) % NS + NS) % NS];
  }
}

// The in-column circular Hillis-Steele scan, steps d = STEP, 2 STEP, ...
// below W: b += c * b[(L - t*d) mod W], c *= c[(L - t*d) mod W], t = +1
// forward and -1 backward.
template <int NS, bool BWD, int STEP>
__device__ __forceinline__ void scan(float (&b)[NS], float (&c)[NS],
                                     int tid) {
  constexpr int W = 32 * NS;
  if constexpr (STEP < W) {
    float bs[NS], cs[NS];
    roll<NS, BWD ? W - STEP : STEP>(b, bs, tid);
    roll<NS, BWD ? W - STEP : STEP>(c, cs, tid);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      b[s] = b[s] + c[s] * bs[s];
      c[s] = c[s] * cs[s];
    }
    scan<NS, BWD, 2 * STEP>(b, c, tid);
  }
}

// K independent forward scans of the same form side by side (K3's
// extension columns), step by step: the K chains of a step are
// independent, so their shuffles can be in flight together, and each
// chain's rolled copies are dead once it has stepped.  Each chain's b is
// bitwise scan<NS, false, 1>'s; the c products of the last step, which no
// caller reads, are not formed.
template <int K, int NS, int STEP = 1>
__device__ __forceinline__ void scan_group(float (&b)[K][NS],
                                           float (&c)[K][NS], int tid) {
  constexpr int W = 32 * NS;
  if constexpr (STEP < W) {
    constexpr bool kLast = 2 * STEP >= W;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float bs[NS];
      roll<NS, STEP>(b[k], bs, tid);
      if constexpr (!kLast) {
        float cs[NS];
        roll<NS, STEP>(c[k], cs, tid);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          b[k][s] = b[k][s] + c[k][s] * bs[s];
          c[k][s] = c[k][s] * cs[s];
        }
      } else {
#pragma unroll
        for (int s = 0; s < NS; ++s) b[k][s] = b[k][s] + c[k][s] * bs[s];
      }
    }
    scan_group<K, NS, 2 * STEP>(b, c, tid);
  }
}

// The column max over the warp's W lanes: a register max over the held
// slots, then five xor shuffles.
template <int NS>
__device__ __forceinline__ float warp_max(const float (&b)[NS]) {
  float m = b[0];
#pragma unroll
  for (int s = 1; s < NS; ++s) m = fmaxf(m, b[s]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, x));
  return m;
}

__device__ __forceinline__ bool in_band(int row, int o, int W) {
  return row >= o && row < o + W;
}

// The band row lane s * 32 + tid holds in a column with band offset o:
// the row congruent to the lane mod W in [o, o + W) (ops/fwdbwd.circ_rows).
template <int W>
__device__ __forceinline__ int band_row(int o, int s, int tid) {
  const int q = o % W;
  const int L = s * 32 + tid;
  return o - q + L + (L < q ? W : 0);
}

}  // namespace band_scan
