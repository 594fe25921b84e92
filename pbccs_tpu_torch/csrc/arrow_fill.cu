// K1: banded Arrow alpha/beta fills, each cell's coefficients built in the
// kernel from the fill's raw inputs.
//
// Replaces the TPU Pallas kernel pbccs_tpu/ops/fwdbwd_pallas.py::_fill_kernel
// (:320) with merge=False, launched there by _run_fill (:426) for
// pallas_forward_batch / pallas_backward_batch, together with the
// coefficient precompute that feeds it, _forward_coeffs (:182) and
// _backward_coeffs (:251).  The plain torch version is
// ops/fwdbwd_cuda.arrow_fill_plain (the coefficient planes of
// _forward_coeffs / _backward_coeffs, then fill_scan_plain); the arithmetic
// below is its, operation for operation, so the two agree bitwise.
//
// Inputs per read r: the read (R, Imax) int8 with its length I, its
// template window (R, Jmax) int8 with its length J and transition rows
// (R, Jmax, 4) float32 (match, branch, stick, dark), the band offsets
// (R, nc = Jmax + 1), and hit = 1 - eps, miss = eps / 3.  Per kernel
// column k (alpha column j = k, beta column j = Jmax - k) every lane L
// holds band row rows(L) = o - (o mod W) + L (+ W when L < o mod W) and
// builds, with the gates of _forward_coeffs / _backward_coeffs in their
// order:
//   cm  the match move from row -+ 1 of column j -+ 1: em (read base
//       against template base) times the match transition, or the pins of
//       the first (forward) or last (backward) read row; gated by the
//       row's validity and the source row's band membership;
//   cd  the deletion move from column j -+ 1: the dark transition;
//   cc  the insertion chain inside the column: branch (bases equal) or
//       stick / 3, cut at the band's first row (forward) or last (backward);
// then the pinned column J (forward) or terminal column 0 (backward) and
// the dead columns override them.  The column:
//   b[L] = cm * prev[(L - t) mod W] + cd * prev[L]  (t = +1 fwd, -1 bwd)
//          + 1 at the seed lane of the seed column;
//   ceil(log2 W) circular Hillis-Steele steps with c = cc (band_scan.cuh);
//   the column max, scale = (mask && cmax > 0) ? cmax : 1, col = mask ?
//   b / scale : b, ls = log(scale) or 0; prev = col.
// Outputs: band values (R, nc, W) and log-scales (R, nc) per direction,
// backward column k stored at nc - 1 - k (natural column order).
//
// What bounds it on this card: latency, as for K2 (csrc/quiver_fill.cu).
// The columns of a read are a strict sequence, and each column is one
// dependent chain of a few hundred instructions per thread; its bytes (one
// band column written) and operations are far below either roof.  The
// design:
//  - one warp per read (4 reads per block) in band_scan.cuh's strided
//    layout, W / 32 lanes per thread: every roll and the column max are
//    register work and shuffles; no block barrier, no shared memory, and a
//    warp whose read is past R returns at once;
//  - no (R, nc, W) coefficient plane is built or read: the per-column data
//    is the same for every lane (offsets at j and j -+ 1, template bases,
//    transition rows) and is loaded two columns ahead; each lane keeps its
//    read base in a register, reloaded only when the band moves its row
//    (about once every W / (I/J) columns), and column k+1's reloads are
//    issued before column k's scan;
//  - alpha and beta in one launch: blockIdx.y picks the direction, so the
//    two fills of a batch on known offsets run side by side and twice the
//    warps hide each other's latency.
// The build uses -fmad=false -ftz=true, so products, sums and quotients
// round and flush as in the plain version; stick / 3 is an IEEE divide.

#include <cuda_runtime.h>
#include <math.h>

#include "band_scan.cuh"

namespace {

using band_scan::band_row;
using band_scan::in_band;
using band_scan::roll;
using band_scan::scan;
using band_scan::warp_max;

constexpr int kWarps = 4;   // reads per block

struct Fill {
  const signed char* reads;
  const int* rlens;
  const signed char* tpls;
  const float4* trans;      // (match, branch, stick, dark) per column
  const int* tlens;
  const int* offs;
  float* vals[2];           // [direction]: alpha, beta
  float* ls[2];
  int R, Imax, Jmax;
  float hit, miss;
};

template <int NS, bool BWD>
__device__ __forceinline__ void fill_read(const Fill f, int r, int tid) {
  constexpr int W = 32 * NS;
  constexpr int dj = BWD ? -1 : 1;
  const int Imax = f.Imax, Jmax = f.Jmax, nc = Jmax + 1;
  const int I = f.rlens[r], J = f.tlens[r];
  const signed char* rd = f.reads + (size_t)r * Imax;
  const signed char* tp = f.tpls + (size_t)r * Jmax;
  const float4* tr = f.trans + (size_t)r * Jmax;
  const int* orow = f.offs + (size_t)r * nc;
  float* vals = f.vals[BWD] + (size_t)r * nc * W + tid;
  float* ls = f.ls[BWD] + (size_t)r * nc;
  const float hit = f.hit, miss = f.miss;

  // uniform per-column data, clamped as the plain version's _clip_cols
  auto off_at = [&](int j) { return orow[min(max(j, 0), nc - 1)]; };
  auto tpl_at = [&](int j) { return (int)tp[min(max(j, 0), Jmax - 1)]; };
  auto tr_at = [&](int j) { return tr[min(max(j, 0), Jmax - 1)]; };
  // the emission of the pinned cell (I, J) (forward: read base I-1 against
  // template base J-1) or of the terminal cell (0, 0) (backward: bases 0)
  const int r_end = BWD ? rd[0] : rd[min(max(I - 1, 0), Imax - 1)];
  const int t_end = BWD ? tp[0] : tp[min(max(J - 1, 0), Jmax - 1)];
  const float em_end = r_end == t_end ? hit : miss;

  // column j's offsets (o0; o1 at the moves' source column j - dj) and the
  // next two columns'; template bases j - 1 (tA, forward's emission base)
  // and j (tB) and the next; transition rows j - 2 (trp, forward's match
  // and dark) and j - 1 (trc) and the next
  int j = BWD ? Jmax : 0;
  int o0 = off_at(j), o1 = off_at(j - dj);
  int on = off_at(j + dj), on2 = off_at(j + 2 * dj);
  int tA = tpl_at(j - 1), tB = tpl_at(j), tBn = tpl_at(j + dj);
  float4 trp = tr_at(j - 2), trc = tr_at(j - 1), trn = tr_at(j - 1 + dj);

  // per held slot: the band row and its read base (forward read[row - 1],
  // backward read[row]; rows outside 1..I-1 never reach an operand)
  int crow[NS], rb[NS];
#define AF_LOAD(s, row)                                                      \
  {                                                                          \
    crow[s] = (row);                                                         \
    rb[s] = rd[min(max(BWD ? (row) : (row) - 1, 0), Imax - 1)];              \
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) AF_LOAD(s, band_row<W>(o0, s, tid));

  float prev[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) prev[s] = 0.0f;
  const int seedcol = BWD ? Jmax - J : 0;
  const int seedlane = BWD ? I % W : 0;

  for (int k = 0; k < nc; ++k, j += dj) {
    // ---- column k's coefficients
    const bool dead = BWD ? (j >= J || j < 0) : (j == 0 || j > J);
    const bool pin = BWD ? j == 0 : j == J;
    const bool mask = j >= 1 && j < J;
    const bool no_dc = pin || dead;
    const float stick3 = trc.z / 3.0f;
    const int t_em = BWD ? tB : tA;
    float cm[NS], cd[NS], c[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int row = crow[s];
      const bool valid = row >= 1 && row <= I - 1;
      const float em = rb[s] == t_em ? hit : miss;
      const float ins = rb[s] == tB ? trc.y : stick3;
      float m, d, x;
      if constexpr (BWD) {
        const float mfac = row < I - 1 ? trc.x
                           : (row == I - 1 && j == J - 1) ? 1.0f : 0.0f;
        m = (valid && in_band(row + 1, o1, W)) ? em * mfac : 0.0f;
        d = (valid && j >= 1 && j < J - 1 && in_band(row, o1, W)) ? trc.w
                                                                  : 0.0f;
        x = (valid && row < I - 1 && row < o0 + W - 1) ? ins : 0.0f;
        if (pin) m = (row == 0 && in_band(row + 1, o1, W)) ? em_end : 0.0f;
      } else {
        const float mfac = j == 1 ? (row == 1 ? 1.0f : 0.0f)
                           : row == 1 ? 0.0f : trp.x;
        m = (valid && in_band(row - 1, o1, W)) ? em * mfac : 0.0f;
        d = (valid && j > 1 && in_band(row, o1, W)) ? trp.w : 0.0f;
        x = (valid && row > 1 && row > o0) ? ins : 0.0f;
        if (pin) m = (row == I && in_band(row - 1, o1, W)) ? em_end : 0.0f;
      }
      cm[s] = dead ? 0.0f : m;
      cd[s] = no_dc ? 0.0f : d;
      c[s] = no_dc ? 0.0f : x;
    }

    // ---- column k+1's read-base reloads and column k+2's uniform data, in
    // flight while column k scans
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int rw = band_row<W>(on, s, tid);
      if (rw != crow[s]) AF_LOAD(s, rw);
    }
    const int on3 = off_at(j + 3 * dj);
    const int tBn2 = tpl_at(j + 2 * dj);
    const float4 trn2 = tr_at(j - 1 + 2 * dj);

    // ---- column k
    float pr[NS], b[NS];
    roll<NS, BWD ? W - 1 : 1>(prev, pr, tid);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      b[s] = cm[s] * pr[s] + cd[s] * prev[s];
      if (k == seedcol && s * 32 + tid == seedlane) b[s] = b[s] + 1.0f;
    }
    scan<NS, BWD, 1>(b, c, tid);

    const float cmax = warp_max<NS>(b);
    const bool do_scale = mask && cmax > 0.0f;
    const float scale = do_scale ? cmax : 1.0f;
    const int kout = BWD ? nc - 1 - k : k;
    float* out = vals + (size_t)kout * W;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float col = mask ? b[s] / scale : b[s];
      out[s * 32] = col;
      prev[s] = col;
    }
    if (tid == 0) ls[kout] = do_scale ? logf(scale) : 0.0f;

    o1 = o0; o0 = on; on = on2; on2 = on3;
    tA = tB; tB = tBn; tBn = tBn2;
    trp = trc; trc = trn; trn = trn2;
  }
#undef AF_LOAD
}

// blockIdx.y picks the direction: first_dir + y (0 alpha, 1 beta).
template <int NS>
__global__ void __launch_bounds__(32 * kWarps)
arrow_fill_kernel(const Fill f, int first_dir) {
  const int tid = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= f.R) return;   // the whole warp: nothing waits on a barrier
  if (first_dir + (int)blockIdx.y)
    fill_read<NS, true>(f, r, tid);
  else
    fill_read<NS, false>(f, r, tid);
}

template <int NS>
int launch(const Fill& f, int first_dir, int n_dirs, cudaStream_t stream) {
  const dim3 grid((f.R + kWarps - 1) / kWarps, n_dirs);
  arrow_fill_kernel<NS><<<grid, 32 * kWarps, 0, stream>>>(f, first_dir);
  return (int)cudaGetLastError();
}

}  // namespace

// vals_a/ls_a (alpha) and vals_b/ls_b (beta): a null vals pointer skips
// that direction; both given, both fills run in one launch.  Built for
// W / 32 = 1..6 and 8 slots (7 spills under ptxas, so W = 224 is left out).
extern "C" int pbccs_arrow_fill(const signed char* reads, const int* rlens,
                                const signed char* tpls, const float* trans,
                                const int* tlens, const int* offs,
                                float* vals_a, float* ls_a, float* vals_b,
                                float* ls_b, int R, int Imax, int Jmax, int W,
                                float hit, float miss, void* stream) {
  if (R <= 0 || (vals_a == nullptr && vals_b == nullptr))
    return (int)cudaSuccess;
  const Fill f{reads, rlens, tpls, reinterpret_cast<const float4*>(trans),
               tlens, offs, {vals_a, vals_b}, {ls_a, ls_b}, R, Imax, Jmax,
               hit, miss};
  const int first_dir = vals_a != nullptr ? 0 : 1;
  const int n_dirs = (vals_a != nullptr && vals_b != nullptr) ? 2 : 1;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
    case 32: return launch<1>(f, first_dir, n_dirs, st);
    case 64: return launch<2>(f, first_dir, n_dirs, st);
    case 96: return launch<3>(f, first_dir, n_dirs, st);
    case 128: return launch<4>(f, first_dir, n_dirs, st);
    case 160: return launch<5>(f, first_dir, n_dirs, st);
    case 192: return launch<6>(f, first_dir, n_dirs, st);
    case 256: return launch<8>(f, first_dir, n_dirs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
