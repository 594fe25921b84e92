"""Banded Arrow forward/backward fills: coefficient precompute + the K1
column-scan kernel (csrc/fill_scan.cu).

Port of pbccs_tpu.ops.fwdbwd_pallas.  A fill runs in two steps:

  1. a torch coefficient precompute: for every (read, column) the three
     band-coefficient vectors of the column recurrence in circular lane
     layout (fwdbwd.BandedMatrix: cell (i, j) at lane i mod W)

         col[L] = cm[L] * roll(prev, +-1)[L]   (match from (i-+1, j-+1))
                + cd[L] * prev[L]              (deletion from (i, j-+1))
                + cc[L] * col[L-+1 circ]       (insertion, in-column)

     with every cross-column band-membership mask folded into cm/cd and
     the circular scan's cut (the band's first row forward, last row
     backward) folded into cc;

  2. the column scan (`fill_scan`): per column one lane roll, the
     in-column recurrence as a ceil(log2 W)-step circular Hillis-Steele
     scan, and the per-column max-rescale (reference ScaledMatrix,
     Matrix/ScaledMatrix-inl.hpp:74-123).  On a CUDA tensor it launches
     the hand-written kernel; on a CPU tensor it runs `fill_scan_plain`,
     the same arithmetic as a loop over columns.

The backward (beta) fill reuses the scan in backward mode (rolls and scan
run the other circular direction) over kernel columns k holding beta
column j = Jmax - k, and stores column k at output column nc-1-k, so the
returned matrix is in natural column order.

Layout: the coefficient tensors are (R, nc, W), read-major, so a kernel
block (one read) streams contiguous W-float rows; the TPU kernel's
column-major (nc, R, W) layout existed for VMEM addressing and has no
use here.  nc = Jmax + 1 (the TPU's 64-column padding is not needed)."""

from __future__ import annotations

import ctypes

import torch

from pbccs_tpu_torch.models.arrow.params import (
    MISMATCH_PROBABILITY,
    TRANS_BRANCH,
    TRANS_DARK,
    TRANS_MATCH,
    TRANS_STICK,
)
from pbccs_tpu_torch.ops import cuda_lib
from pbccs_tpu_torch.ops.fwdbwd import (BandedMatrix, band_offsets,
                                        circ_roll, circ_rows, ftz, in_band)

_TINY = 1e-30


# --------------------------------------------------------------------------
# coefficient precompute
# --------------------------------------------------------------------------


def window_rows_circ(x: torch.Tensor, starts: torch.Tensor,
                     W: int) -> torch.Tensor:
    """y[r, j, L] = x[r, circ_rows(starts[r, j], W)[L]], 0 past the end of
    x.  x (R, N); starts (R, nc) >= 0.  A plain gather: the TPU picks the
    same values with one-hot matmuls (exact for these small integer
    codes)."""
    R, N = x.shape
    rows = circ_rows(starts, W)                              # (R, nc, W)
    got = torch.gather(x, 1, rows.clamp(max=N - 1).reshape(R, -1).long())
    return torch.where(rows < N, got.reshape(rows.shape),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _clip_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[:, clip(idx, 0, n-1)] along the column axis (axis 1)."""
    return x[:, idx.clamp(0, x.shape[1] - 1)]


def _forward_coeffs(reads, I, tpls, trans, J, offsets, W: int, eps: float):
    """Per-column circular-lane coefficients of the alpha recurrence for a
    read batch.  reads (R, Imax) int32; I, J (R,) int32; tpls (R, Jmax)
    int32; trans (R, Jmax, 4) f32; offsets (R, nc) int32.  Returns
    (cm, cd, cc) (R, nc, W), mask (R, nc), seed (R, W), seedcol (R,).
    Mirrors fwdbwd.banded_forward column for column."""
    R = reads.shape[0]
    nc = offsets.shape[1]
    dev = reads.device
    hit, miss = 1.0 - eps, eps / 3.0

    jr = torch.arange(nc, device=dev)
    j = jr.to(torch.int32)[None, :, None]                      # (1, nc, 1)
    o = offsets[:, :, None]
    om1 = _clip_cols(offsets, jr - 1)[:, :, None]             # col j-1
    I3, J3 = I[:, None, None], J[:, None, None]

    rows = circ_rows(offsets, W)                               # (R, nc, W)
    read_pad = torch.cat([reads[:, :1], reads], dim=1)        # [row]=read[row-1]
    rbase = window_rows_circ(read_pad, offsets, W)
    t_cur = _clip_cols(tpls, jr - 1)[:, :, None]
    t_next = _clip_cols(tpls, jr)[:, :, None]
    tr_prev = _clip_cols(trans, jr - 2)                        # (R, nc, 4)
    tr_cur = _clip_cols(trans, jr - 1)

    valid = (rows >= 1) & (rows <= I3 - 1)
    em = torch.where(rbase == t_cur, hit, miss)
    mfac = torch.where(
        j == 1,
        torch.where(rows == 1, 1.0, 0.0),
        torch.where(rows == 1, 0.0, tr_prev[..., TRANS_MATCH:TRANS_MATCH + 1]))
    cm = torch.where(valid & in_band(rows - 1, om1, W), em * mfac, 0.0)
    cd = torch.where(valid & (j > 1) & in_band(rows, om1, W),
                     tr_prev[..., TRANS_DARK:TRANS_DARK + 1], 0.0)
    ins = torch.where(rbase == t_next,
                      tr_cur[..., TRANS_BRANCH:TRANS_BRANCH + 1],
                      tr_cur[..., TRANS_STICK:TRANS_STICK + 1] / 3.0)
    cc = torch.where(valid & (rows > 1) & (rows > o), ins, 0.0)

    # final pinned column j == J: alpha(I, J) = alpha(I-1, J-1) * em_last
    # (SimpleRecursor.cpp:171-180)
    r_last = reads.gather(1, (I - 1).clamp(0, reads.shape[1] - 1)[:, None].long())
    t_last = tpls.gather(1, (J - 1).clamp(0, tpls.shape[1] - 1)[:, None].long())
    em_last = torch.where(r_last == t_last, hit, miss)[:, :, None]
    pinned = j == J3
    cm = torch.where(pinned,
                     torch.where((rows == I3) & in_band(rows - 1, om1, W),
                                 em_last, 0.0), cm)
    dead = (j == 0) | (j > J3)
    cd = torch.where(pinned | dead, 0.0, cd)
    cc = torch.where(pinned | dead, 0.0, cc)
    cm = torch.where(dead, 0.0, cm)

    mask = ((j[:, :, 0] >= 1) & (j[:, :, 0] < J[:, None])).float()
    seed = torch.zeros(R, W, device=dev)
    seed[:, 0] = 1.0
    seedcol = torch.zeros(R, dtype=torch.int32, device=dev)
    return cm, cd, cc, mask, seed, seedcol


def _backward_coeffs(reads, I, tpls, trans, J, offsets, W: int, eps: float):
    """Beta coefficients: kernel column k holds beta column j = Jmax - k in
    the same circular lane layout as alpha (the backward scan rolls the
    other way).  Same conventions as _forward_coeffs; mirrors
    fwdbwd.banded_backward column for column."""
    R, Imax = reads.shape
    Jmax = tpls.shape[1]
    nc = offsets.shape[1]
    dev = reads.device
    hit, miss = 1.0 - eps, eps / 3.0

    k = torch.arange(nc, device=dev)
    j = (Jmax - k).to(torch.int32)[None, :, None]              # beta column
    o_j = _clip_cols(offsets, Jmax - k)                        # (R, nc)
    o_j1 = _clip_cols(offsets, Jmax + 1 - k)[:, :, None]      # col j+1
    I3, J3 = I[:, None, None], J[:, None, None]

    rows = circ_rows(o_j, W)
    read_pad = torch.cat([reads, reads[:, Imax - 1:]], dim=1)
    rnext = window_rows_circ(read_pad, o_j, W)                 # read base i+1
    t_next = _clip_cols(tpls, Jmax - k)[:, :, None]            # base of col j+1
    tr_cur = _clip_cols(trans, Jmax - 1 - k)                   # moves leaving j-1
    o_j = o_j[:, :, None]

    valid = (rows >= 1) & (rows <= I3 - 1)
    nxt_match = rnext == t_next
    em = torch.where(nxt_match, hit, miss)
    mfac = torch.where(
        rows < I3 - 1,
        tr_cur[..., TRANS_MATCH:TRANS_MATCH + 1],
        torch.where((rows == I3 - 1) & (j == J3 - 1), 1.0, 0.0))
    cm = torch.where(valid & in_band(rows + 1, o_j1, W), em * mfac, 0.0)
    cd = torch.where(valid & (j >= 1) & (j < J3 - 1)
                     & in_band(rows, o_j1, W),
                     tr_cur[..., TRANS_DARK:TRANS_DARK + 1], 0.0)
    ins = torch.where(nxt_match, tr_cur[..., TRANS_BRANCH:TRANS_BRANCH + 1],
                      tr_cur[..., TRANS_STICK:TRANS_STICK + 1] / 3.0)
    # rows < o + W - 1 cuts the reverse circular scan at the band's top row
    cc = torch.where(valid & (rows < I3 - 1) & (rows < o_j + W - 1), ins, 0.0)

    # terminal beta column j == 0: beta(0,0) = beta(1,1) * em(read[0], tpl[0])
    em0 = torch.where(reads[:, :1] == tpls[:, :1], hit, miss)[:, :, None]
    at0 = j == 0
    cm = torch.where(at0,
                     torch.where((rows == 0) & in_band(rows + 1, o_j1, W),
                                 em0, 0.0), cm)
    dead = (j >= J3) | (j < 0)
    cd = torch.where(at0 | dead, 0.0, cd)
    cc = torch.where(at0 | dead, 0.0, cc)
    cm = torch.where(dead, 0.0, cm)

    jj = j[:, :, 0]
    mask = ((jj >= 1) & (jj <= J[:, None] - 1)).float()
    seed = (torch.arange(W, device=dev)[None, :]
            == (I % W)[:, None]).float()
    seedcol = (Jmax - J).to(torch.int32)
    return cm, cd, cc, mask, seed, seedcol


# --------------------------------------------------------------------------
# the column scan: kernel wrapper and its plain version
# --------------------------------------------------------------------------


def fill_scan_plain(cm, cd, cc, mask, seed, seedcol, backward: bool):
    """The column scan in plain torch, a loop over columns with the
    kernel's exact association: per column b = cm*roll(prev) + cd*prev
    (+ seed at seedcol), the circular Hillis-Steele scan, a divide by the
    column max where mask is set, and log(scale); every product, sum and
    quotient flushed to zero below F32_MIN_NORMAL, as the kernel's
    -ftz=true arithmetic does.  Returns vals (R, nc, W) and log-scales
    (R, nc); column k is stored at k (forward) or nc-1-k (backward)."""
    R, nc, W = cm.shape
    t = -1 if backward else 1
    vals = torch.empty_like(cm)
    ls = torch.empty(R, nc, dtype=cm.dtype, device=cm.device)
    prev = torch.zeros(R, W, dtype=cm.dtype, device=cm.device)
    at_seed = seedcol[:, None].long() == torch.arange(nc, device=cm.device)
    for k in range(nc):
        b = ftz(ftz(cm[:, k] * circ_roll(prev, t)) + ftz(cd[:, k] * prev))
        b = torch.where(at_seed[:, k:k + 1], ftz(b + seed), b)
        c = cc[:, k]
        d = 1
        while d < W:
            b = ftz(b + ftz(c * circ_roll(b, t * d)))
            c = ftz(c * circ_roll(c, t * d))
            d *= 2
        cmax = b.max(dim=1, keepdim=True).values
        m = mask[:, k:k + 1] > 0
        do_scale = m & (cmax > 0)
        scale = torch.where(do_scale, cmax, 1.0)
        col = torch.where(m, ftz(b / scale), b)
        kout = nc - 1 - k if backward else k
        vals[:, kout] = col
        ls[:, kout] = torch.where(do_scale, torch.log(scale), 0.0)[:, 0]
        prev = col
    return vals, ls


def _check_f32(name: str, x: torch.Tensor, shape: tuple, dev) -> None:
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bind_fill(lib: ctypes.CDLL):
    fn = lib.pbccs_fill_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fill_scan(cm, cd, cc, mask, seed, seedcol, backward: bool):
    """The K1 column scan (the TPU `_run_fill` boundary): coefficients
    (R, nc, W), mask (R, nc), seed (R, W), seedcol (R,) int32 in; vals
    (R, nc, W) and log-scales (R, nc) out.  CPU tensors run
    fill_scan_plain; CUDA tensors launch csrc/fill_scan.cu on the current
    stream (no fallback)."""
    if cm.device.type == "cpu":
        return fill_scan_plain(cm, cd, cc, mask, seed, seedcol, backward)
    if cm.device.type != "cuda":
        raise ValueError(f"fill_scan: unsupported device {cm.device}")
    R, nc, W = cm.shape
    dev = cm.device
    for name, x in (("cm", cm), ("cd", cd), ("cc", cc)):
        _check_f32(name, x, (R, nc, W), dev)
    _check_f32("mask", mask, (R, nc), dev)
    _check_f32("seed", seed, (R, W), dev)
    if seedcol.device != dev or seedcol.dtype != torch.int32 \
            or tuple(seedcol.shape) != (R,) or not seedcol.is_contiguous():
        raise ValueError("seedcol must be a contiguous (R,) int32 tensor "
                         f"on {dev}")
    if not 2 <= W <= 1024:
        raise ValueError(f"fill_scan: band width {W} outside [2, 1024]")
    vals = torch.empty_like(cm)
    ls = torch.empty(R, nc, dtype=torch.float32, device=dev)
    fn = _bind_fill(cuda_lib.load("fill_scan"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cm.data_ptr(), cd.data_ptr(), cc.data_ptr(),
                 mask.data_ptr(), seed.data_ptr(), seedcol.data_ptr(),
                 vals.data_ptr(), ls.data_ptr(), R, nc, W, int(backward),
                 stream)
    cuda_lib.check(err, "fill_scan")
    fill_scan.launches += 1
    return vals, ls


fill_scan.launches = 0


# --------------------------------------------------------------------------
# public batched fills
# --------------------------------------------------------------------------


def _resolve_offsets(offsets, I, J, nc: int, width: int) -> torch.Tensor:
    """Diagonal offsets unless supplied ones are given; supplied offsets
    are padded to nc columns by repeating the last value."""
    if offsets is None:
        return band_offsets(I, J, nc, width)
    offsets = offsets.to(torch.int32)
    if offsets.shape[1] < nc:
        offsets = torch.cat([offsets, offsets[:, -1:].expand(
            -1, nc - offsets.shape[1])], dim=1)
    return offsets[:, :nc].contiguous()


def _fill(reads, rlens, tpls, trans, tlens, width: int, pr_miscall: float,
          offsets, backward: bool) -> BandedMatrix:
    Jmax = tpls.shape[1]
    nc = Jmax + 1
    I = rlens.to(torch.int32)
    J = tlens.to(torch.int32)
    offsets = _resolve_offsets(offsets, I, J, nc, width)
    coeffs = _backward_coeffs if backward else _forward_coeffs
    cm, cd, cc, mask, seed, seedcol = coeffs(
        reads.to(torch.int32), I, tpls.to(torch.int32), trans.float(), J,
        offsets, width, pr_miscall)
    vals, ls = fill_scan(cm.contiguous(), cd.contiguous(), cc.contiguous(),
                         mask.contiguous(), seed.contiguous(),
                         seedcol.contiguous(), backward)
    return BandedMatrix(vals, offsets, ls)


def forward_batch(reads, rlens, tpls, trans, tlens, width: int,
                  pr_miscall: float = MISMATCH_PROBABILITY,
                  offsets=None) -> BandedMatrix:
    """Batched banded forward (alpha) fills: reads (R, Imax), rlens (R,),
    tpls (R, Jmax), trans (R, Jmax, 4), tlens (R,).  Returns leaves
    (R, Jmax+1, W) / (R, Jmax+1).  `offsets` (R, >= Jmax+1): precomputed
    monotone band offsets (guided rebanding); default diagonal layout.
    Counterpart of fwdbwd_pallas.pallas_forward_batch."""
    return _fill(reads, rlens, tpls, trans, tlens, width, pr_miscall,
                 offsets, backward=False)


def backward_batch(reads, rlens, tpls, trans, tlens, width: int,
                   pr_miscall: float = MISMATCH_PROBABILITY,
                   offsets=None) -> BandedMatrix:
    """Batched banded backward (beta) fills; conventions of forward_batch
    (counterpart of fwdbwd_pallas.pallas_backward_batch)."""
    return _fill(reads, rlens, tpls, trans, tlens, width, pr_miscall,
                 offsets, backward=True)


def forward_loglik_batch(alpha: BandedMatrix, rlens, tlens) -> torch.Tensor:
    """LL[r] = log alpha(I, J) + sum of column log-scales; column J is
    one-hot, so the final value is a masked band sum."""
    J = tlens.to(torch.int32)[:, None]
    jcols = torch.arange(alpha.vals.shape[1], device=J.device)[None, :]
    final = torch.where((jcols == J)[:, :, None], alpha.vals, 0.0).sum((1, 2))
    ls = torch.where(jcols <= J, alpha.log_scales, 0.0).sum(1)
    return torch.log(torch.clamp(final, min=_TINY)) + ls


def backward_loglik_batch(beta: BandedMatrix, tlens) -> torch.Tensor:
    """LL[r] = log beta(0, 0) + sum of column log-scales."""
    J = tlens.to(torch.int32)[:, None]
    jcols = torch.arange(beta.vals.shape[1], device=J.device)[None, :]
    ls = torch.where(jcols <= J, beta.log_scales, 0.0).sum(1)
    return torch.log(torch.clamp(beta.vals[:, 0, 0], min=_TINY)) + ls
