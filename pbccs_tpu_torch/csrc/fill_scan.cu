// K1: banded Arrow alpha/beta column scan over circular lanes.
//
// Replaces the TPU Pallas kernel pbccs_tpu/ops/fwdbwd_pallas.py::_fill_kernel
// (merge=False), launched there by _run_fill for pallas_forward_batch and
// pallas_backward_batch.
//
// What it computes, per read and per kernel column k (0..nc-1):
//   b[L]  = cm[L] * prev[(L - t) mod W] + cd[L] * prev[L]   (t = +1 fwd, -1 bwd)
//   b[L] += seed[L]                        if k == seedcol
//   ceil(log2 W) circular Hillis-Steele steps, d = 1, 2, 4, ...:
//       b[L] = b[L] + c[L] * b[(L - t*d) mod W];  c[L] = c[L] * c[(L - t*d) mod W]
//   cmax  = max_L b[L]; scale = (mask && cmax > 0) ? cmax : 1
//   col   = mask ? b / scale : b;  ls = (mask && cmax > 0) ? log(scale) : 0
// stored at column k (forward) or nc-1-k (backward), then prev = col.
// The association is exactly ops/fwdbwd._affine_scan_circ's, and the build
// uses -fmad=false, so products and sums round as in the plain torch version.
//
// What bounds it on this card: not bytes (three W-float coefficient rows in
// and one out per column, about 16 bytes per lane) and not arithmetic (about
// 3*log2(W) flops per lane per column), but latency: the columns of a read
// are a strict sequence, and each column is ceil(log2 W) + 2 block-wide
// barriers long.
//
// What the design does about it: one block per read and one thread per
// lane (W rounded up to a warp multiple), so the R reads of a batch run as
// R independent blocks that the SMs interleave to hide each other's barrier
// latency; the column loop stays inside the block and nothing is carried
// between blocks.  The cross-lane roll and each scan step exchange through
// shared memory (the scan double-buffers it so one barrier per step
// suffices), and the column max is a warp-shuffle reduction.  W need not be
// a power of two (96, 192): every roll index is (L - t*d) mod W.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ int wrap_lane(int x, int W) {
  x %= W;
  return x < 0 ? x + W : x;
}

__global__ void fill_scan_kernel(const float* __restrict__ cm,
                                 const float* __restrict__ cd,
                                 const float* __restrict__ cc,
                                 const float* __restrict__ mask,
                                 const float* __restrict__ seed,
                                 const int* __restrict__ seedcol,
                                 float* __restrict__ vals,
                                 float* __restrict__ ls,
                                 int nc, int W, int backward) {
  extern __shared__ float smem[];
  float* prev = smem;         // W: the previous column
  float* sb = prev + W;       // 2W: scan b, double-buffered
  float* sc = sb + 2 * W;     // 2W: scan c, double-buffered
  float* red = sc + 2 * W;    // one max per warp

  const int r = blockIdx.x;
  const int L = threadIdx.x;
  const bool lane_ok = L < W;
  const int t = backward ? -1 : 1;
  const int nwarps = (blockDim.x + 31) >> 5;
  const size_t row0 = (size_t)r * nc * W;
  const int scol = seedcol[r];
  const float sd = lane_ok ? seed[(size_t)r * W + L] : 0.0f;
  const int src1 = lane_ok ? wrap_lane(L - t, W) : 0;

  if (lane_ok) prev[L] = 0.0f;   // the first column sees a zero predecessor
  __syncthreads();

  for (int k = 0; k < nc; ++k) {
    const size_t at = row0 + (size_t)k * W + L;
    float b = 0.0f, c = 0.0f;
    if (lane_ok) {
      b = cm[at] * prev[src1] + cd[at] * prev[L];
      if (k == scol) b = b + sd;
      c = cc[at];
    }
    int buf = 0;
    for (int d = 1; d < W; d <<= 1) {
      if (lane_ok) {
        sb[buf * W + L] = b;
        sc[buf * W + L] = c;
      }
      __syncthreads();
      if (lane_ok) {
        const int s = wrap_lane(L - t * d, W);
        const float bs = sb[buf * W + s];
        const float cs = sc[buf * W + s];
        b = b + c * bs;
        c = c * cs;
      }
      buf ^= 1;
    }

    float v = lane_ok ? b : -INFINITY;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((L & 31) == 0) red[L >> 5] = v;
    __syncthreads();
    float cmax = red[0];
    for (int w = 1; w < nwarps; ++w) cmax = fmaxf(cmax, red[w]);

    const bool m = mask[(size_t)r * nc + k] > 0.0f;
    const bool do_scale = m && cmax > 0.0f;
    const float scale = do_scale ? cmax : 1.0f;
    const float col = m ? b / scale : b;
    const int kout = backward ? nc - 1 - k : k;
    if (lane_ok) {
      vals[row0 + (size_t)kout * W + L] = col;
      prev[L] = col;
    }
    if (L == 0) ls[(size_t)r * nc + kout] = do_scale ? logf(scale) : 0.0f;
    __syncthreads();   // prev and red are rewritten by the next column
  }
}

}  // namespace

extern "C" int pbccs_fill_scan(const float* cm, const float* cd,
                               const float* cc, const float* mask,
                               const float* seed, const int* seedcol,
                               float* vals, float* ls, int R, int nc, int W,
                               int backward, void* stream) {
  if (R <= 0 || nc <= 0) return (int)cudaSuccess;
  const int threads = ((W + 31) / 32) * 32;
  const size_t smem = (size_t)(5 * W + 32) * sizeof(float);
  fill_scan_kernel<<<R, threads, smem, (cudaStream_t)stream>>>(
      cm, cd, cc, mask, seed, seedcol, vals, ls, nc, W, backward);
  return (int)cudaGetLastError();
}
