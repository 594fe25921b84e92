// K3: dense interior mutation scores over the 9-slot grid.
//
// Replaces the TPU Pallas kernel pbccs_tpu/ops/dense_score_pallas.py::
// _dense_kernel + _dense_kernel_body, launched there by
// dense_interior_scores_batch.
//
// What it computes: for read r and window position p, the absolute
// log-likelihood of the read against the window with each of the 9
// single-base mutations at p (sub A/C/G/T, ins A/C/G/T, del):
//   * sub b / ins b: extend alpha from column p-1 through two patched
//     columns (the first, ext0, is shared by sub b and ins b), link against
//     beta column p+2 (sub) or p+1 (ins);
//   * del: extend alpha from column p-2 through two columns, link against
//     beta column p+2;
//   * add the alpha scale prefix and the beta scale suffix.
// Each extension column is an in-column first-order recurrence solved as a
// circular Hillis-Steele scan, associated exactly as the plain version
// (ops/dense_score_cuda._dense_rows_plain) does; the build uses -fmad=false.
// Values are valid for interior slots only (window position >= 3, end <=
// len - 2); other entries are finite garbage the caller masks.
//
// What bounds it on this card: latency and operation count, not bytes.
// Per (read, position) it reads about 12 W-float rows (alpha, beta, read
// windows) and writes 9 floats, but runs 14 band scans of ceil(log2 W)
// steps plus 9 band reductions.
//
// What the design does about it: one block per (read, 64-position block),
// one thread per circular lane.  Independent scans run together: the four
// ext0 columns and the deletion's first column share one 5-wide scan, and
// the eight second columns and the deletion's second column one 9-wide
// scan, so a position costs 2 * ceil(log2 W) scan barriers instead of 14x.
// The lane rolls of the saved alpha/beta columns read rolled addresses
// straight from device memory; only the computed ext0 columns go through
// shared memory.  The nine link sums are warp-shuffle reductions finished
// across warps in shared memory.  Blocks whose `live` flag is 0 (no
// candidate slot in rounds > 0 of the refinement loop) write zeros and
// return at once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPB = 64;
constexpr int kSlots = 9;
constexpr int kMatch = 0, kBranch = 1, kStick = 2, kDark = 3;

__device__ __forceinline__ int wrap_lane(int x, int W) {
  x %= W;
  return x < 0 ? x + W : x;
}

// absolute row held by circular lane L of a column with band offset o
__device__ __forceinline__ int circ_row(int o, int L, int W) {
  const int q = o % W;
  return o - q + L + (L < q ? W : 0);
}

__device__ __forceinline__ bool in_band(int row, int o, int W) {
  return row >= o && row < o + W;
}

// ExtendAlpha b-coefficient from the cross-column operands (pm1, p0)
__device__ __forceinline__ float ext_b(float pm1, float p0, int rows,
                                       float em, float tr_m, float tr_d,
                                       int I) {
  float b = pm1 * em * (rows < I ? tr_m : 0.0f);
  b = b + (rows != I ? p0 * tr_d : 0.0f);
  return (rows >= 1 && rows <= I) ? b : 0.0f;
}

__device__ __forceinline__ bool cmask(int rows, int o_col, int I) {
  return rows > 1 && rows < I && rows > o_col;
}

// insertion coefficient of the in-column recurrence
__device__ __forceinline__ float ext_c(bool m, float rb, float next_b,
                                       float tr_b, float tr_s) {
  return m ? (rb == next_b ? tr_b : tr_s / 3.0f) : 0.0f;
}

// K independent circular scans v[L] = b[L] + c[L] * v[L-1], one barrier
// per step; sb/sc hold 2*K*W floats each (double-buffered).
template <int K>
__device__ __forceinline__ void scan_k(float (&b)[K], float (&c)[K],
                                       float* sb, float* sc, int L, int W,
                                       bool lane_ok) {
  int buf = 0;
  for (int d = 1; d < W; d <<= 1) {
    if (lane_ok) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sb[(buf * K + k) * W + L] = b[k];
        sc[(buf * K + k) * W + L] = c[k];
      }
    }
    __syncthreads();
    if (lane_ok) {
      const int s = wrap_lane(L - d, W);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float bs = sb[(buf * K + k) * W + s];
        const float cs = sc[(buf * K + k) * W + s];
        b[k] = b[k] + c[k] * bs;
        c[k] = c[k] * cs;
      }
    }
    buf ^= 1;
  }
  __syncthreads();   // the buffers are reused by the next exchange
}

__global__ void dense_score_kernel(
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const float* __restrict__ rbase, const float* __restrict__ rnext,
    const int* __restrict__ offs, const float* __restrict__ apre,
    const float* __restrict__ bsuf, const int* __restrict__ wtpl,
    const float* __restrict__ wtrans, const float* __restrict__ ptrans,
    const int* __restrict__ rlens, const int* __restrict__ live,
    float* __restrict__ out, int nc, int Jm, int NB, int W, float hit,
    float miss) {
  const int blk = blockIdx.x;
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int p_lo = blk * kPB;
  const int p_hi = min(p_lo + kPB, Jm);
  float* out_r = out + (size_t)r * Jm * kSlots;

  if (live[(size_t)r * NB + blk] == 0) {
    for (int i = tid; i < (p_hi - p_lo) * kSlots; i += blockDim.x)
      out_r[(size_t)p_lo * kSlots + i] = 0.0f;
    return;
  }

  extern __shared__ float smem[];
  float* sb = smem;              // 2 * 9 * W
  float* sc = sb + 18 * W;       // 2 * 9 * W
  float* xr = sc + 18 * W;       // 5 * W: ext0 columns for the lane roll
  float* red = xr + 5 * W;       // 32 * 9: per-warp link sums

  const bool lane_ok = tid < W;
  const int L = lane_ok ? tid : W - 1;
  const int Lm1 = wrap_lane(L - 1, W);
  const int Lp1 = wrap_lane(L + 1, W);
  const int I = rlens[r];
  const int nwarps = (blockDim.x + 31) >> 5;
  const size_t col0 = (size_t)r * nc;

  // position-indexed operands read as zero outside their arrays
  auto A = [&](int j, int lane) -> float {
    return (j >= 0 && j < nc) ? alpha[(col0 + j) * W + lane] : 0.0f;
  };
  auto B = [&](int j, int lane) -> float {
    return (j >= 0 && j < nc) ? beta[(col0 + j) * W + lane] : 0.0f;
  };
  auto RB = [&](int j) -> float {
    return (j >= 0 && j < nc) ? rbase[(col0 + j) * W + L] : 0.0f;
  };
  auto RN = [&](int j) -> float {
    return (j >= 0 && j < nc) ? rnext[(col0 + j) * W + L] : 0.0f;
  };
  auto OFF = [&](int j) -> int {
    return (j >= 0 && j < nc) ? offs[col0 + j] : 0;
  };
  auto APRE = [&](int j) -> float {
    return (j >= 0 && j <= nc) ? apre[(size_t)r * (nc + 1) + j] : 0.0f;
  };
  auto BSUF = [&](int j) -> float {
    return (j >= 0 && j <= nc) ? bsuf[(size_t)r * (nc + 1) + j] : 0.0f;
  };
  auto WT = [&](int j) -> float {
    return (j >= 0 && j < Jm) ? (float)wtpl[(size_t)r * Jm + j] : 0.0f;
  };
  auto TR = [&](int j, int k) -> float {
    return (j >= 0 && j < Jm) ? wtrans[((size_t)r * Jm + j) * 4 + k] : 0.0f;
  };

  for (int p = p_lo; p < p_hi; ++p) {
    const int o_m2 = OFF(p - 2), o_m1 = OFF(p - 1), o_0 = OFF(p);
    const int o_p1 = OFF(p + 1), o_p2 = OFF(p + 2);
    const float w_m2 = WT(p - 2), w_m1 = WT(p - 1), w_0 = WT(p);
    const float w_p1 = WT(p + 1);
    const float* pt = ptrans + ((size_t)r * Jm + p) * (kSlots * 8);
    // patch transition row (slot, column) -> 4 floats at pt[(s*2+c)*4]
    auto PT = [&](int s, int c, int k) -> float {
      return pt[(s * 2 + c) * 4 + k];
    };

    const int rows_m1 = circ_row(o_m1, L, W);
    const int rows_0 = circ_row(o_0, L, W);
    const int rows_p1 = circ_row(o_p1, L, W);
    const float rb_m1 = RB(p - 1), rb_0 = RB(p), rb_p1 = RB(p + 1);
    const float rn_0 = RN(p), rn_p1 = RN(p + 1);

    // ---- first extension columns: ext0 of sub/ins b (shared b term) and
    // the deletion's first column (from alpha column p-2)
    float b1[5], c1[5];
    {
      const float pm1 = in_band(rows_0 - 1, o_m1, W) ? A(p - 1, Lm1) : 0.0f;
      const float p0 = in_band(rows_0, o_m1, W) ? A(p - 1, L) : 0.0f;
      const float em = rb_0 == w_m1 ? hit : miss;
      const float b0 = ext_b(pm1, p0, rows_0, em, TR(p - 2, kMatch),
                             TR(p - 2, kDark), I);
      const bool mc0 = cmask(rows_0, o_0, I);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        b1[b] = b0;
        c1[b] = ext_c(mc0, rb_0, (float)b, PT(b, 0, kBranch),
                      PT(b, 0, kStick));
      }
      const float dm1 = in_band(rows_m1 - 1, o_m2, W) ? A(p - 2, Lm1) : 0.0f;
      const float d0 = in_band(rows_m1, o_m2, W) ? A(p - 2, L) : 0.0f;
      const float dem = rb_m1 == w_m2 ? hit : miss;
      b1[4] = ext_b(dm1, d0, rows_m1, dem, TR(p - 3, kMatch),
                    TR(p - 3, kDark), I);
      c1[4] = ext_c(cmask(rows_m1, o_m1, I), rb_m1, w_m1, TR(p - 2, kBranch),
                    TR(p - 2, kStick));
    }
    scan_k<5>(b1, c1, sb, sc, tid, W, lane_ok);

    // lane roll of the computed first columns
    if (lane_ok) {
#pragma unroll
      for (int k = 0; k < 5; ++k) xr[k * W + L] = b1[k];
    }
    __syncthreads();
    float e_r[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) e_r[k] = xr[k * W + Lm1];

    // ---- second extension columns: sub b, ins b, del
    float b2[9], c2[9];
    {
      const bool mc1 = cmask(rows_p1, o_p1, I);
      const bool ib_m = in_band(rows_p1 - 1, o_0, W);
      const bool ib_0 = in_band(rows_p1, o_0, W);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float pm1 = ib_m ? e_r[b] : 0.0f;
        const float p0 = ib_0 ? b1[b] : 0.0f;
        const float em = rb_p1 == (float)b ? hit : miss;
        const float bb = ext_b(pm1, p0, rows_p1, em, PT(b, 0, kMatch),
                               PT(b, 0, kDark), I);
        b2[b] = bb;
        c2[b] = ext_c(mc1, rb_p1, w_p1, PT(b, 1, kBranch), PT(b, 1, kStick));
        b2[4 + b] = bb;
        c2[4 + b] = ext_c(mc1, rb_p1, w_0, PT(4 + b, 1, kBranch),
                          PT(4 + b, 1, kStick));
      }
      const float pm1 = in_band(rows_0 - 1, o_m1, W) ? e_r[4] : 0.0f;
      const float p0 = in_band(rows_0, o_m1, W) ? b1[4] : 0.0f;
      const float em = rb_0 == w_m1 ? hit : miss;
      b2[8] = ext_b(pm1, p0, rows_0, em, TR(p - 2, kMatch),
                    TR(p - 2, kDark), I);
      c2[8] = ext_c(cmask(rows_0, o_0, I), rb_0, w_p1, PT(8, 0, kBranch),
                    PT(8, 0, kStick));
    }
    scan_k<9>(b2, c2, sb, sc, tid, W, lane_ok);

    // ---- links against the saved beta columns
    float term[9];
    {
      const bool lt_p1 = rows_p1 < I;
      // sub family: beta column p+2
      const float bip1_s =
          in_band(rows_p1 + 1, o_p2, W) ? B(p + 2, Lp1) : 0.0f;
      const float bi_s = in_band(rows_p1, o_p2, W) ? B(p + 2, L) : 0.0f;
      const float em_s = rn_p1 == w_p1 ? hit : miss;
      const float mterm_s = lt_p1 ? em_s * bip1_s : 0.0f;
      // ins family: beta column p+1
      const float bip1_i =
          in_band(rows_p1 + 1, o_p1, W) ? B(p + 1, Lp1) : 0.0f;
      const float bi_i = in_band(rows_p1, o_p1, W) ? B(p + 1, L) : 0.0f;
      const float em_i = rn_p1 == w_0 ? hit : miss;
      const float mterm_i = lt_p1 ? em_i * bip1_i : 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float ms = b2[b] * PT(b, 1, kMatch) * mterm_s;
        const float ds = b2[b] * PT(b, 1, kDark) * bi_s;
        term[b] = ms + ds;
        const float mi = b2[4 + b] * PT(4 + b, 1, kMatch) * mterm_i;
        const float di = b2[4 + b] * PT(4 + b, 1, kDark) * bi_i;
        term[4 + b] = mi + di;
      }
      // del: rows of column p, beta column p+2
      const float em_l = rn_0 == w_p1 ? hit : miss;
      const float bip1 = in_band(rows_0 + 1, o_p2, W) ? B(p + 2, Lp1) : 0.0f;
      const float bi = in_band(rows_0, o_p2, W) ? B(p + 2, L) : 0.0f;
      const float mterm = rows_0 < I ? em_l * bip1 : 0.0f;
      const float md = b2[8] * PT(8, 0, kMatch) * mterm;
      const float dd = b2[8] * PT(8, 0, kDark) * bi;
      term[8] = md + dd;
    }

    // nine band sums: warp shuffles, then across warps
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      float v = lane_ok ? term[k] : 0.0f;
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if ((tid & 31) == 0) red[(tid >> 5) * kSlots + k] = v;
    }
    __syncthreads();
    if (tid < kSlots) {
      float v = red[tid];
      for (int w = 1; w < nwarps; ++w) v += red[w * kSlots + tid];
      float pre, suf;
      if (tid < 4) {
        pre = APRE(p);
        suf = BSUF(p + 2);
      } else if (tid < 8) {
        pre = APRE(p);
        suf = BSUF(p + 1);
      } else {
        pre = APRE(p - 1);
        suf = BSUF(p + 2);
      }
      out_r[(size_t)p * kSlots + tid] = logf(fmaxf(v, 1e-30f)) + pre + suf;
    }
  }
}

}  // namespace

extern "C" int pbccs_dense_score(
    const float* alpha, const float* beta, const float* rbase,
    const float* rnext, const int* offs, const float* apre, const float* bsuf,
    const int* wtpl, const float* wtrans, const float* ptrans,
    const int* rlens, const int* live, float* out, int R, int nc, int Jm,
    int NB, int W, float hit, float miss, void* stream) {
  if (R <= 0 || Jm <= 0) return (int)cudaSuccess;
  const int threads = ((W + 31) / 32) * 32;
  const size_t smem = (size_t)(41 * W + 32 * kSlots) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dense_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(NB, R);
  dense_score_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      alpha, beta, rbase, rnext, offs, apre, bsuf, wtpl, wtrans, ptrans,
      rlens, live, out, nc, Jm, NB, W, hit, miss);
  return (int)cudaGetLastError();
}
