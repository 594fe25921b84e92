// K2: banded Quiver alpha/beta fills with the Merge move, each cell's
// operands built in the kernel from per-read emission tables.
//
// Replaces the TPU Pallas kernel pbccs_tpu/ops/fwdbwd_pallas.py::_fill_kernel
// with merge=True, together with the coefficient precompute that feeds it
// there, pbccs_tpu/models/quiver/pallas_fill.py::_forward_coeffs (:94) and
// ::_backward_coeffs (:144).  The plain torch version is
// ops/quiver_fill_cuda.quiver_fill_plain; the arithmetic below is its,
// operation for operation, so the two agree bitwise.
//
// Inputs: emission tables (n_reads, P, 12) float32 (one row per read
// position, models/quiver/fill.emission_tables; ops/quiver_fill_cuda.py
// names the columns), read lengths, an (M, Jmax) int8 window tensor with
// its lengths, and per fill row r: the read row_read[r], the window
// row_win[r] and the band offsets (R, nc = Jmax + 1).  Per kernel column k
// (beta column j = Jmax - k when backward) every lane L holds band row
// rows(L) = o - (o mod W) + L (+ W when L < o mod W) and computes
//   cm, cd, cg, cc  the Incorporate, Delete, Merge and Extra operands:
//                   the table entries of its row selected by base-equality
//                   tests against the template bases at j-2..j (forward)
//                   or j, j+1 (backward), gated by the band-membership of
//                   the source rows at the previous columns' offsets;
//   b[L]  = cm * prev[(L - t) mod W] + cd * prev[L]       (t = +1 fwd, -1 bwd)
//         + cg * (prev2[(L - t) mod W] / sprev)           (the Merge carry)
//         + 1 at the seed lane of the seed column;
//   ceil(log2 W) circular Hillis-Steele steps b += c * b[(L - t*d) mod W],
//   c *= c[(L - t*d) mod W] (d = 1, 2, 4, ...), with c = cc;
//   the column max, scale = (mask && cmax > 0) ? cmax : 1, col = mask ?
//   b / scale : b, ls = log(scale) or 0; prev2 = prev, sprev = scale,
//   prev = col.
// Outputs: the band values (R, nc, W) when `vals` is given, the log-scales
// (R, nc), and the one cell the log-likelihood reads, alpha(I, J) (0 when
// row I is outside column J's band) or beta(0, 0).  With vals null
// (log-likelihood-only mode) the dead columns past J (forward) or before
// the seed column (backward) are skipped: their operands are all zero, so
// they hold zeros with log-scale 0 (the wrapper zero-fills ls), and
// starting the backward scan at its seed column with zero carries is the
// full scan's arithmetic.
//
// What bounds it on this card: latency.  The columns of a read are a
// strict sequence; per column the work is a few dozen operations per lane
// and a handful of bytes, far below either roof, but each column waits on
// its predecessor, and a column is itself one dependent chain of a few
// hundred instructions per thread (the operand build of every held slot,
// the IEEE divides the plain version fixes, the shuffles): one warp alone
// waits out their latencies, so the card fills only with many rows per
// launch and several resident warps per scheduler (PERF.md).  The design:
//  - one warp per fill row (4 rows per block), W / 32 lanes per thread in a
//    strided layout (lane = slot * 32 + thread), so every circular roll by
//    a compile-time distance is one __shfl_sync per held slot and a select
//    (or, for distances that are multiples of 32, a pure slot rotation),
//    and the column max a register max and five xor shuffles.  No block
//    barrier anywhere: a warp whose row is past R returns at once;
//  - no (R, nc, W) operand plane is read: each lane builds its operands
//    from the table rows of its band rows, kept in registers and reloaded
//    only when the band moves past them (a lane's row changes about once
//    every W / (I/J) columns), and the uniform per-column data (offsets,
//    template bases) is loaded two columns ahead;
//  - column k+1's table loads are issued before column k's scan, so no
//    device-memory round trip sits on the column chain;
//  - in log-likelihood-only mode nothing of size nc x W is written.
// The build uses -fmad=false -ftz=true, so products, sums and quotients
// round and flush as in the plain version.

#include <cuda_runtime.h>
#include <math.h>

#include "band_scan.cuh"

namespace {

using band_scan::band_row;
using band_scan::in_band;
using band_scan::roll;
using band_scan::scan;
using band_scan::warp_max;

constexpr int kCols = 12;       // emission table row (ops/quiver_fill_cuda.py)
constexpr int kMatch = 10, kDeln = 11;
constexpr int kWarps = 4;       // fill rows per block

template <int NS, bool BWD>
__global__ void __launch_bounds__(32 * kWarps)
quiver_fill_kernel(const float* __restrict__ tab, int P,
                   const int* __restrict__ rlens,
                   const signed char* __restrict__ wins,
                   const int* __restrict__ wlens,
                   const int* __restrict__ row_read,
                   const int* __restrict__ row_win,
                   const int* __restrict__ offs, float* __restrict__ vals,
                   float* __restrict__ ls, float* __restrict__ fin, int R,
                   int Jmax, int use_merge) {
  constexpr int W = 32 * NS;
  const int tid = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;   // the whole warp: nothing waits on a barrier

  const int nc = Jmax + 1;
  const int rd = row_read[r];
  const int I = rlens[rd];
  const int J = wlens[row_win[r]];
  const float* T = tab + (size_t)rd * P * kCols;
  const signed char* tp = wins + (size_t)row_win[r] * Jmax;
  const int* orow = offs + (size_t)r * nc;
  const float e_match = T[kMatch], e_deln = T[kDeln];

  const int dj = BWD ? -1 : 1;
  const int seedcol = BWD ? Jmax - J : 0;
  const int seedlane = BWD ? I % W : 0;
  const bool ll_only = vals == nullptr;
  const int k0 = (ll_only && BWD) ? seedcol : 0;
  const int k1 = (ll_only && !BWD) ? J : Jmax;

  // uniform per-column data: offsets and template bases, clamped as the
  // plain version's _clip_cols
  auto off_at = [&](int j) { return orow[min(max(j, 0), nc - 1)]; };
  auto tpl_at = [&](int j) { return (int)tp[min(max(j, 0), Jmax - 1)]; };

  int j = BWD ? Jmax - k0 : k0;
  int o0 = off_at(j), o1 = off_at(j - dj), o2 = off_at(j - 2 * dj);
  int on = off_at(j + dj), on2 = off_at(j + 2 * dj);
  int b0 = tpl_at(j), b1 = tpl_at(j - dj), b2 = tpl_at(j - 2 * dj);
  int bn = tpl_at(j + dj);

  // per held slot: the band row and its table entries.  Forward reads the
  // Incorporate / Extra / Merge features at row - 1 (table row `row`) and
  // the deletion tag at row (table row row + 1); backward reads all at row.
  int crow[NS];
  float t_seq[NS], t_mis[NS], t_br[NS], t_nce[NS];
  float t_m0[NS], t_m1[NS], t_m2[NS], t_m3[NS], t_dtag[NS], t_delt[NS];
#define QF_LOAD(s, row)                                                      \
  {                                                                          \
    const int im_ = min(BWD ? (row) + 1 : (row), P - 1);                     \
    const int i0_ = min((row) + 1, P - 1);                                   \
    const float4 a_ =                                                        \
        *reinterpret_cast<const float4*>(T + (size_t)im_ * kCols);           \
    const float4 m_ =                                                        \
        *reinterpret_cast<const float4*>(T + (size_t)im_ * kCols + 4);       \
    const float2 d_ =                                                        \
        *reinterpret_cast<const float2*>(T + (size_t)i0_ * kCols + 8);       \
    t_seq[s] = a_.x; t_mis[s] = a_.y; t_br[s] = a_.z; t_nce[s] = a_.w;       \
    t_m0[s] = m_.x; t_m1[s] = m_.y; t_m2[s] = m_.z; t_m3[s] = m_.w;          \
    t_dtag[s] = d_.x; t_delt[s] = d_.y;                                      \
    crow[s] = (row);                                                         \
  }

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int rw = band_row<W>(o0, s, tid);
    QF_LOAD(s, rw);
  }

  float prev[NS], prev2[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) prev[s] = prev2[s] = 0.0f;
  float sprev = 1.0f;

  for (int k = k0; k <= k1; ++k, j += dj) {
    // ---- column k's operands
    const bool live = BWD ? (j >= 0 && j < J) : (j >= 1 && j <= J);
    const bool mask = BWD ? (j >= 0 && j <= J) : (j <= J);
    const bool in_tpl = j < J;
    const bool mrg_ok = use_merge && (BWD ? (j + 1 < J) : (j >= 2));
    const float fA = (float)(BWD ? b0 : b1);      // Incorporate, Delete tag
    const float fE = (float)b0;                   // Extra
    const int tM = BWD ? b0 : b2;                 // Merge: base consumed
    const int tM2 = b1;                           // ... and its partner
    const bool mrg_pair = mrg_ok && tM == tM2;
    const float fM = (float)tM;
    const int mb = min(max(tM, 0), 3);
    float cm[NS], cd[NS], cg[NS], c[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int row = crow[s];
      const bool valid = row >= 0 && row <= I;
      const int rn = BWD ? row + 1 : row - 1;           // the move's source
      const bool step_ok = BWD ? row < I : row >= 1;
      const bool cut = BWD ? row < o0 + W - 1 : row > o0;
      const float seq = t_seq[s];
      const float inc = seq == fA ? e_match : t_mis[s];
      const bool tagged = row < I && t_dtag[s] == fA;
      const float dele = tagged ? t_delt[s] : e_deln;
      const float extra = (in_tpl && seq == fE) ? t_br[s] : t_nce[s];
      const float mq = mb == 0 ? t_m0[s] : mb == 1 ? t_m1[s]
                     : mb == 2 ? t_m2[s] : t_m3[s];
      const float mrg = (mrg_pair && seq == fM) ? mq : 0.0f;
      cm[s] = (valid && step_ok && live && in_band(rn, o1, W)) ? inc : 0.0f;
      cd[s] = (valid && live && in_band(row, o1, W)) ? dele : 0.0f;
      cg[s] = (valid && step_ok && live && in_band(rn, o2, W)) ? mrg : 0.0f;
      c[s] = (valid && step_ok && mask && cut) ? extra : 0.0f;
    }

    // ---- column k+1's table rows and column k+2's uniform data, in flight
    // while column k scans
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int rw = band_row<W>(on, s, tid);
      if (rw != crow[s]) QF_LOAD(s, rw);
    }
    const int on3 = off_at(j + 3 * dj);
    const int bn2 = tpl_at(j + 2 * dj);

    // ---- column k
    float pr[NS], pr2[NS], b[NS];
    roll<NS, BWD ? W - 1 : 1>(prev, pr, tid);
    roll<NS, BWD ? W - 1 : 1>(prev2, pr2, tid);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      b[s] = cm[s] * pr[s] + cd[s] * prev[s];
      b[s] = b[s] + cg[s] * (pr2[s] / sprev);
      if (k == seedcol && s * 32 + tid == seedlane) b[s] = b[s] + 1.0f;
    }
    scan<NS, BWD, 1>(b, c, tid);

    const float cmax = warp_max<NS>(b);
    const bool do_scale = mask && cmax > 0.0f;
    const float scale = do_scale ? cmax : 1.0f;
    const int kout = BWD ? nc - 1 - k : k;
    const int lane_fin = BWD ? 0 : I % W;
    const bool at_fin = BWD ? k == Jmax : k == J;
    const bool fin_in_band = BWD || in_band(I, o0, W);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float col = mask ? b[s] / scale : b[s];
      if (vals) vals[((size_t)r * nc + kout) * W + s * 32 + tid] = col;
      if (at_fin && s * 32 + tid == lane_fin)
        fin[r] = fin_in_band ? col : 0.0f;
      prev2[s] = prev[s];
      prev[s] = col;
    }
    if (tid == 0) ls[(size_t)r * nc + kout] = do_scale ? logf(scale) : 0.0f;
    sprev = scale;

    o2 = o1; o1 = o0; o0 = on; on = on2; on2 = on3;
    b2 = b1; b1 = b0; b0 = bn; bn = bn2;
  }
#undef QF_LOAD
}

template <int NS>
int launch(const float* tab, int P, const int* rlens, const signed char* wins,
           const int* wlens, const int* row_read, const int* row_win,
           const int* offs, float* vals, float* ls, float* fin, int R,
           int Jmax, int use_merge, int backward, cudaStream_t stream) {
  const int blocks = (R + kWarps - 1) / kWarps;
  if (backward)
    quiver_fill_kernel<NS, true><<<blocks, 32 * kWarps, 0, stream>>>(
        tab, P, rlens, wins, wlens, row_read, row_win, offs, vals, ls, fin,
        R, Jmax, use_merge);
  else
    quiver_fill_kernel<NS, false><<<blocks, 32 * kWarps, 0, stream>>>(
        tab, P, rlens, wins, wlens, row_read, row_win, offs, vals, ls, fin,
        R, Jmax, use_merge);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pbccs_quiver_fill(const float* tab, int P, const int* rlens,
                                 const signed char* wins, const int* wlens,
                                 const int* row_read, const int* row_win,
                                 const int* offs, float* vals, float* ls,
                                 float* fin, int R, int Jmax, int W,
                                 int use_merge, int backward, void* stream) {
  if (R <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 32:
      return launch<1>(tab, P, rlens, wins, wlens, row_read, row_win, offs,
                       vals, ls, fin, R, Jmax, use_merge, backward, st);
    case 64:
      return launch<2>(tab, P, rlens, wins, wlens, row_read, row_win, offs,
                       vals, ls, fin, R, Jmax, use_merge, backward, st);
    case 96:
      return launch<3>(tab, P, rlens, wins, wlens, row_read, row_win, offs,
                       vals, ls, fin, R, Jmax, use_merge, backward, st);
    case 128:
      return launch<4>(tab, P, rlens, wins, wlens, row_read, row_win, offs,
                       vals, ls, fin, R, Jmax, use_merge, backward, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
