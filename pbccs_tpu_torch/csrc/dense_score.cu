// K3: dense interior mutation scores over the 9-slot grid, every operand
// built in the kernel from the raw inputs.
//
// Replaces the TPU Pallas kernel pbccs_tpu/ops/dense_score_pallas.py::
// _dense_kernel (:238) + _dense_kernel_body (:286), launched there by
// dense_interior_scores_batch (:617), together with the operand planes that
// feed it (band_read_windows, dense_patch_grids).  The plain torch version
// is ops/dense_score_cuda.dense_score_plain (those planes, then
// _dense_rows_plain); the arithmetic below is its, operation for
// operation, so the two agree bitwise.
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
// circular Hillis-Steele scan (band_scan.cuh), each link a band sum.
// Values are valid for interior slots only (window position >= 3, end <=
// len - 2); other entries are finite garbage the caller masks.
//
// Inputs per read r: alpha and beta band values (R, nc, W) on the band
// offsets (R, nc), their scale prefix / suffix (R, nc + 1), the read
// (R, Imax) int8 with its length I, the window template (R, Jm) int8 with
// its length and transition rows (R, Jm, 4) (match, branch, stick, dark),
// the read's transition table (R, 8, 4) by dinucleotide context, and a
// live flag per 64 positions.  The kernel builds, per position, what the
// plain version reads from planes:
//   * the read windows of columns p-1, p, p+1: lane L of column j holds
//     band row row(L) = o_j - (o_j mod W) + L (+ W when L < o_j mod W);
//     rnext = read[row], rbase = read[row - 1], 0 outside [0, Imax) and
//     for a column outside [0, nc).  band_read_windows' rbase takes the
//     band's first row from column j-1 and can hold another value there
//     when o_{j-1} == o_j; every use of that lane is masked (the match
//     operand by in_band(rows - 1, o_prev), the insertion operand by
//     rows > o_col), so the scores do not depend on it;
//   * the patch transition rows of position p: rows of the read's table,
//     context next + 4 (cur != next) clamped to 7, over the window bases
//     p-1, p, p+1 (clipped to the window) and gated by p against the
//     window length, as dense_patch_grids selects them.
//
// What bounds it on this card: instruction issue.  Per (read, position) it
// reads one new alpha and one new beta column (8 W bytes) and writes 36
// bytes, but runs 14 band scans of ceil(log2 W) steps and 9 band sums
// over W lanes: by operation type about 1 ms at 384 x 2112 x 96
// (chip_smoke.k3_bound) against 0.2 ms of bytes.  As built it issues
// several times that work: each shuffled scan step adds two shuffles and
// two selects per slot to its three float32 operations, and the SASS
// holds about as many shuffles and selects as float32 multiplies.  The
// design:
//  - one block of two warps per (read, 64-position live cell), one warp
//    per 32 positions, in band_scan.cuh's strided layout: every roll is a
//    compile-time shuffle or slot rotation, the scans and sums never leave
//    registers, and no block barrier or shared memory serves them (each
//    warp keeps its read's 8 table rows, stick already divided by 3, in
//    128 bytes of shared memory).  A dead cell's block writes its zeros
//    and frees its slot at once; 32 positions per warp, so that the live
//    cells of a late refinement round still spread over twice as many
//    warps;
//  - a sliding window of columns in registers: moving from p to p+1 turns
//    alpha column p-1 into p-2 and beta column p+2 into p+1, so each
//    position loads one alpha and one beta column and the read codes of
//    one column (coalesced), issued after the position's scans so that
//    they hold no registers there; the read codes of the three columns
//    in use are packed into one register per slot;
//  - the 14 scans run as independent chains side by side (band_scan::
//    scan_group), kFam of the five families at a time (the four bases --
//    ext0, then sub and ins -- and the deletion's two columns): their
//    first columns, then their second columns, so that a family's shared
//    b term never outlives it.  kFam is per width the fastest that fits
//    in registers without a spill (W = 256 spills at every kFam);
//  - each link sum adds a thread's slots in a register, then five xor
//    shuffles: the plain version's band_sum order.
// The build uses -fmad=false -ftz=true, so products and sums round and
// flush as in the plain version; stick / 3 is an IEEE divide, taken once
// per table row and per window row.

#include <cuda_runtime.h>
#include <math.h>

#include "band_scan.cuh"

namespace {

using band_scan::band_row;
using band_scan::in_band;
using band_scan::kFull;
using band_scan::roll;
using band_scan::scan_group;

constexpr int kPW = 32;      // positions per warp
constexpr int kPB = 64;      // positions per live flag and per block
constexpr int kWarps = kPB / kPW;
constexpr int kSlots = 9;

struct Args {
  const float* alpha;
  const float* beta;
  const int* offs;
  const float* apre;
  const float* bsuf;
  const signed char* reads;
  const int* rlens;
  const signed char* wtpl;
  const int* wlens;
  const float4* wtrans;      // (match, branch, stick, dark) per position
  const float4* tables;      // 8 context rows per read
  const int* live;
  float* out;
  int R, nc, Imax, Jm, NB;
  float hit, miss;
};

// A transition row as the extension needs it: (match, branch, stick / 3,
// dark), the IEEE quotient taken once per row
__device__ __forceinline__ float4 third_stick(float4 t) {
  t.z = t.z / 3.0f;
  return t;
}

// ExtendAlpha b-coefficient from the cross-column operands (pm1, p0)
__device__ __forceinline__ float ext_b(float pm1, float p0, int row, float em,
                                       float4 tr, int I) {
  float b = pm1 * em * (row < I ? tr.x : 0.0f);
  b = b + (row != I ? p0 * tr.w : 0.0f);
  return (row >= 1 && row <= I) ? b : 0.0f;
}

__device__ __forceinline__ bool cmask(int row, int o_col, int I) {
  return row > 1 && row < I && row > o_col;
}

// insertion coefficient of the in-column recurrence (tr.z holds stick / 3)
__device__ __forceinline__ float ext_c(bool m, int rb, int next_b, float4 tr) {
  return m ? (rb == next_b ? tr.y : tr.z) : 0.0f;
}

// dinucleotide context row of the transition table (params.context_index,
// clamped as transition_lookup clamps it)
__device__ __forceinline__ int context(int cur, int next) {
  return min(next + (cur != next ? 4 : 0), 7);
}

// The warp total of one link: sum over lanes of
// e * tr.match * mterm + e * tr.dark * bi (band_sum's order).
template <int NS>
__device__ __forceinline__ float link_sum(const float (&e)[NS], float4 tr,
                                          const float (&mterm)[NS],
                                          const float (&bi)[NS]) {
  float v = 0.0f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float t = e[s] * tr.x * mterm[s] + e[s] * tr.w * bi[s];
    v = s == 0 ? t : v + t;
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) v = v + __shfl_xor_sync(kFull, v, x);
  return v;
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// f(Int<k0>, Int<n>) for consecutive groups [k0, k0 + n) of the chains
// [K0, N), n = G but the last: groups of compile-time size, so a group's
// register arrays hold exactly its chains.
template <int N, int G, int K0 = 0, typename F>
__device__ __forceinline__ void for_groups(F&& f) {
  if constexpr (K0 < N) {
    constexpr int n = N - K0 < G ? N - K0 : G;
    f(Int<K0>{}, Int<n>{});
    for_groups<N, G, K0 + n>(f);
  }
}

// The read codes of the columns p-1, p, p+1 are packed one byte per column
// (rbase in the low, rnext in the high nibble), column p-1 in the lowest
// byte, so a position slides the window with one shift.
__device__ __forceinline__ int rb_of(int pk, int col) {
  return (pk >> (8 * col)) & 15;
}
__device__ __forceinline__ int rn_of(int pk, int col) {
  return (pk >> (8 * col + 4)) & 15;
}

template <int NS, int kFam>
__device__ __forceinline__ void score_warp(const Args& a, int r, int p_lo,
                                           int p_hi, int tid,
                                           const float4* tab) {
  constexpr int W = 32 * NS;
  const int nc = a.nc, Jm = a.Jm, Imax = a.Imax;
  const int I = a.rlens[r], Lw = a.wlens[r];
  const float hit = a.hit, miss = a.miss;
  const float* al = a.alpha + (size_t)r * nc * W + tid;
  const float* be = a.beta + (size_t)r * nc * W + tid;
  const int* orow = a.offs + (size_t)r * nc;
  const float* apre = a.apre + (size_t)r * (nc + 1);
  const float* bsuf = a.bsuf + (size_t)r * (nc + 1);
  const signed char* rd = a.reads + (size_t)r * Imax;
  const signed char* tp = a.wtpl + (size_t)r * Jm;
  const float4* wtr = a.wtrans + (size_t)r * Jm;
  float* out = a.out + (size_t)r * Jm * kSlots;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // position-indexed operands read as zero outside their arrays (the plain
  // version's _at); the patch contexts clip to the window instead
  auto OFF = [&](int j) { return (j >= 0 && j < nc) ? orow[j] : 0; };
  auto WT = [&](int j) { return (j >= 0 && j < Jm) ? (int)tp[j] : 0; };
  auto TB = [&](int j) { return (int)tp[min(max(j, 0), Jm - 1)]; };
  auto TR = [&](int j) { return (j >= 0 && j < Jm) ? wtr[j] : zero4; };
  auto PRE = [&](int j) { return (j >= 0 && j <= nc) ? apre[j] : 0.0f; };
  auto SUF = [&](int j) { return (j >= 0 && j <= nc) ? bsuf[j] : 0.0f; };
  auto COL = [&](const float* base, int j, float (&v)[NS]) {
    const bool ok = j >= 0 && j < nc;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      v[s] = ok ? base[(size_t)j * W + s * 32] : 0.0f;
  };
  // column j's read codes as one byte per slot: rbase = read[row - 1],
  // rnext = read[row]
  auto CODES = [&](int j, int (&byte)[NS]) {
    const bool ok = j >= 0 && j < nc;
    const int o = ok ? orow[j] : 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int row = band_row<W>(o, s, tid);
      const int rn = (ok && row < Imax) ? (int)rd[row] : 0;
      const int rb = (ok && row >= 1 && row <= Imax) ? (int)rd[row - 1] : 0;
      byte[s] = rb | rn << 4;
    }
  };

  // the sliding window: alpha columns p-2, p-1, beta columns p+1, p+2, the
  // read codes of columns p-1, p, p+1
  float am2[NS], am1[NS], bp1[NS], bp2[NS];
  int pk[NS];
  {
    int c0[NS], c1[NS], c2[NS];
    COL(al, p_lo - 2, am2);
    COL(al, p_lo - 1, am1);
    COL(be, p_lo + 1, bp1);
    COL(be, p_lo + 2, bp2);
    CODES(p_lo - 1, c0);
    CODES(p_lo, c1);
    CODES(p_lo + 1, c2);
#pragma unroll
    for (int s = 0; s < NS; ++s) pk[s] = c0[s] | c1[s] << 8 | c2[s] << 16;
  }

  for (int p = p_lo; p < p_hi; ++p) {
    const int o_m2 = OFF(p - 2), o_m1 = OFF(p - 1), o_0 = OFF(p);
    const int o_p1 = OFF(p + 1), o_p2 = OFF(p + 2);
    const int w_m2 = WT(p - 2), w_m1 = WT(p - 1), w_0 = WT(p);
    const int w_p1 = WT(p + 1);
    const float4 wt_m3 = TR(p - 3), wt_m2 = third_stick(TR(p - 2));
    // patch transition rows (dense_patch_grids): sub/ins b at p-1, sub b
    // and ins b at p, del at p-1; the table holds stick / 3
    const int prev_b = TB(p - 1), cur_b = TB(p), next_b = TB(p + 1);
    auto PT0 = [&](int b) { return p > 0 ? tab[context(prev_b, b)] : zero4; };
    auto PT1S = [&](int b) {
      return p + 1 < Lw ? tab[context(b, next_b)] : zero4;
    };
    auto PT1I = [&](int b) { return p < Lw ? tab[context(b, cur_b)] : zero4; };
    const float4 pt_del =
        (p > 0 && p < Lw - 1) ? tab[context(prev_b, next_b)] : zero4;
    // band rows of columns p-1, p, p+1
    auto ROWS = [&](int o, int s) { return band_row<W>(o, s, tid); };

    // The link operands of family 0 (sub: beta column p+2 at column p+1's
    // rows), 1 (ins: p+1 at p+1's rows) and 2 (del: p+2 at p's rows).
    auto link_ops = [&](int fam, float (&mt)[NS], float (&bi)[NS]) {
      float bcol[NS], br[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) bcol[s] = fam == 1 ? bp1[s] : bp2[s];
      roll<NS, W - 1>(bcol, br, tid);
      const int o_b = fam == 1 ? o_p1 : o_p2;
      const int o_r = fam == 2 ? o_0 : o_p1;
      const int w_l = fam == 1 ? w_0 : w_p1;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int row = ROWS(o_r, s);
        const int rn = rn_of(pk[s], fam == 2 ? 1 : 2);
        const float bip1 = in_band(row + 1, o_b, W) ? br[s] : 0.0f;
        bi[s] = in_band(row, o_b, W) ? bcol[s] : 0.0f;
        const float em = rn == w_l ? hit : miss;
        mt[s] = row < I ? em * bip1 : 0.0f;
      }
    };

    // ---- the nine slots by family: f < 4 is base f (its first column,
    // ext0, shared by sub f and ins f; then their second columns), f = 4
    // the deletion (its first column from alpha column p-2, then its
    // second).  kFam families at a time: their first columns scan side by
    // side, each gives its second columns' b term, and their second
    // columns scan side by side and link against the saved beta columns.
    float v[kSlots];   // by slot: sub b at b, ins b at 4 + b, del at 8
    for_groups<5, kFam>([&](auto f0_, auto n_) {
      constexpr int f0 = decltype(f0_)::value, n = decltype(n_)::value;
      // second columns: two per base (sub at 2g, ins at 2g + 1), one for
      // the deletion, which is the last family
      constexpr int m = 2 * n - (f0 + n == 5 ? 1 : 0);
      float b2[m][NS], c2[m][NS];
      {
        float b1[n][NS], c1[n][NS];
        float am1r[NS], am2r[NS];
        roll<NS, 1>(am1, am1r, tid);
        roll<NS, 1>(am2, am2r, tid);
#pragma unroll
        for (int g = 0; g < n; ++g) {
          const int f = f0 + g;
          const float4 t0 = f < 4 ? PT0(f) : zero4;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            if (f < 4) {
              const int row = ROWS(o_0, s);
              const int rb0 = rb_of(pk[s], 1);
              const float pm1 = in_band(row - 1, o_m1, W) ? am1r[s] : 0.0f;
              const float p0 = in_band(row, o_m1, W) ? am1[s] : 0.0f;
              const float em = rb0 == w_m1 ? hit : miss;
              b1[g][s] = ext_b(pm1, p0, row, em, wt_m2, I);
              c1[g][s] = ext_c(cmask(row, o_0, I), rb0, f, t0);
            } else {
              const int row = ROWS(o_m1, s);
              const int rbm1 = rb_of(pk[s], 0);
              const float pm1 = in_band(row - 1, o_m2, W) ? am2r[s] : 0.0f;
              const float p0 = in_band(row, o_m2, W) ? am2[s] : 0.0f;
              const float em = rbm1 == w_m2 ? hit : miss;
              b1[g][s] = ext_b(pm1, p0, row, em, wt_m3, I);
              c1[g][s] = ext_c(cmask(row, o_m1, I), rbm1, w_m1, wt_m2);
            }
          }
        }
        scan_group<n, NS>(b1, c1, tid);
#pragma unroll
        for (int g = 0; g < n; ++g) {
          const int f = f0 + g;
          float er[NS];
          roll<NS, 1>(b1[g], er, tid);
          const float4 t0 = f < 4 ? PT0(f) : wt_m2;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            // base: rows of column p+1 against ext0 on column p's band;
            // del: rows of column p against its first column on p-1's
            const int o_prev = f < 4 ? o_0 : o_m1;
            const int o_row = f < 4 ? o_p1 : o_0;
            const int row = ROWS(o_row, s);
            const float pm1 = in_band(row - 1, o_prev, W) ? er[s] : 0.0f;
            const float p0 = in_band(row, o_prev, W) ? b1[g][s] : 0.0f;
            const int rb = rb_of(pk[s], f < 4 ? 2 : 1);
            const float em = rb == (f < 4 ? f : w_m1) ? hit : miss;
            const float bv = ext_b(pm1, p0, row, em, t0, I);
            const bool mc = cmask(row, o_row, I);
            if (f < 4) {
              b2[2 * g][s] = bv;
              c2[2 * g][s] = ext_c(mc, rb, w_p1, PT1S(f));
              b2[2 * g + 1][s] = bv;
              c2[2 * g + 1][s] = ext_c(mc, rb, w_0, PT1I(f));
            } else {
              b2[2 * g][s] = bv;
              c2[2 * g][s] = ext_c(mc, rb, w_p1, pt_del);
            }
          }
        }
      }
      scan_group<m, NS>(b2, c2, tid);
#pragma unroll
      for (int j = 0; j < m; ++j) {
        const int f = f0 + j / 2;
        const int fam = f == 4 ? 2 : j & 1;
        const float4 tr = f == 4 ? pt_del : (j & 1) ? PT1I(f) : PT1S(f);
        float mt[NS], bi[NS];
        link_ops(fam, mt, bi);
        v[f == 4 ? 8 : 4 * (j & 1) + f] = link_sum<NS>(b2[j], tr, mt, bi);
      }
    });

    // ---- the next position's new columns, issued after the scans so that
    // they hold no registers there
    float na[NS], nb[NS];
    int nbyte[NS];
    COL(al, p, na);
    COL(be, p + 3, nb);
    CODES(p + 2, nbyte);

    // ---- lane k < 9 writes slot k: log of the band sum plus the scale
    // prefix (sub/ins: column p, del: p-1) and suffix (sub/del: p+2,
    // ins: p+1)
    float mine = v[0];
#pragma unroll
    for (int k = 1; k < kSlots; ++k) mine = tid == k ? v[k] : mine;
    if (tid < kSlots) {
      const float pre = PRE(tid < 8 ? p : p - 1);
      const float suf = SUF(tid >= 4 && tid < 8 ? p + 1 : p + 2);
      out[(size_t)p * kSlots + tid] = logf(fmaxf(mine, 1e-30f)) + pre + suf;
    }

    // ---- slide the window one position on
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      am2[s] = am1[s];
      am1[s] = na[s];
      bp1[s] = bp2[s];
      bp2[s] = nb[s];
      pk[s] = (pk[s] >> 8) | nbyte[s] << 16;
    }
  }
}

// One block per (read, 64-position live cell), one warp per 32 positions:
// a dead cell's block writes its zeros and frees its slot at once.
template <int NS, int kFam>
__global__ void __launch_bounds__(32 * kWarps)
dense_score_kernel(const Args a) {
  __shared__ float4 tabs[kWarps][8];
  const int tid = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int r = blockIdx.x / a.NB;
  const int cell = blockIdx.x - r * a.NB;
  const int p_lo = cell * kPB + wid * kPW;
  if (p_lo >= a.Jm) return;   // the whole warp: nothing waits on a barrier
  const int p_hi = min(p_lo + kPW, a.Jm);
  if (a.live[(size_t)r * a.NB + cell] == 0) {
    float* out = a.out + ((size_t)r * a.Jm + p_lo) * kSlots;
    for (int i = tid; i < (p_hi - p_lo) * kSlots; i += 32) out[i] = 0.0f;
    return;
  }
  if (tid < 8) tabs[wid][tid] = third_stick(a.tables[(size_t)r * 8 + tid]);
  __syncwarp();
  score_warp<NS, kFam>(a, r, p_lo, p_hi, tid, tabs[wid]);
}

template <int NS, int kFam>
int launch(const Args& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)a.R * (unsigned)a.NB;
  dense_score_kernel<NS, kFam><<<blocks, 32 * kWarps, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Built for K1's widths: W / 32 = 1..6 and 8 slots.  kFam, the families
// scanned side by side, is per width the fastest that ptxas fits in
// registers without a spill (chip runs of every choice, PERF.md); at 8
// slots (W = 256, the 2x retry of an explicit band_width of 128) every
// choice spills, and kFam 5 was the fastest of them.
extern "C" int pbccs_dense_score(
    const float* alpha, const float* beta, const int* offs, const float* apre,
    const float* bsuf, const signed char* reads, const int* rlens,
    const signed char* wtpl, const int* wlens, const float* wtrans,
    const float* tables, const int* live, float* out, int R, int nc,
    int Imax, int Jm, int NB, int W, float hit, float miss, void* stream) {
  if (R <= 0 || Jm <= 0) return (int)cudaSuccess;
  const Args a{alpha, beta, offs, apre, bsuf, reads, rlens, wtpl, wlens,
               reinterpret_cast<const float4*>(wtrans),
               reinterpret_cast<const float4*>(tables), live, out, R, nc,
               Imax, Jm, NB, hit, miss};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 32: return launch<1, 5>(a, st);
    case 64: return launch<2, 3>(a, st);
    case 96: return launch<3, 3>(a, st);
    case 128: return launch<4, 5>(a, st);
    case 160: return launch<5, 2>(a, st);
    case 192: return launch<6, 1>(a, st);
    case 256: return launch<8, 5>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
