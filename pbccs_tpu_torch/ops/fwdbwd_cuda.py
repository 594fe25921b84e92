"""Banded Arrow forward/backward fills: K1 (csrc/arrow_fill.cu) and its
plain torch version.

Port of pbccs_tpu.ops.fwdbwd_pallas.  A fill computes, per read and column,
the column recurrence over circular lanes (fwdbwd.BandedMatrix: cell
(i, j) at lane i mod W)

    col[L] = cm[L] * roll(prev, +-1)[L]   (match from (i-+1, j-+1))
           + cd[L] * prev[L]              (deletion from (i, j-+1))
           + cc[L] * col[L-+1 circ]       (insertion, in-column)

with every cross-column band-membership mask folded into cm/cd and the
circular scan's cut (the band's first row forward, last row backward)
folded into cc, solved as a ceil(log2 W)-step circular Hillis-Steele scan
and rescaled by the column max (reference ScaledMatrix,
Matrix/ScaledMatrix-inl.hpp:74-123).

`arrow_fill` is the kernel's wrapper: on CUDA tensors it launches K1, which
builds each cell's coefficients itself from the reads, template windows,
transitions and band offsets (no (R, nc, W) coefficient plane exists on
the card) and runs alpha and beta in one launch when both are asked for;
on CPU tensors it runs `arrow_fill_plain`: the coefficient planes of
`_forward_coeffs` / `_backward_coeffs`, then the column scan
`fill_scan_plain`, a loop over columns.  The two agree bitwise.

The backward (beta) fill runs the scan in backward mode (rolls and scan
the other circular direction) over kernel columns k holding beta column
j = Jmax - k, and stores column k at output column nc-1-k, so the returned
matrix is in natural column order.

Layout: (R, nc, W), read-major; the TPU kernel's column-major (nc, R, W)
layout existed for VMEM addressing and has no use here.  nc = Jmax + 1
(the TPU's 64-column padding is not needed)."""

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
#: band widths K1 is built for: 32 lanes per held slot, 1..8 slots but 7
#: (csrc/arrow_fill.cu spills there)
K1_WIDTHS = (32, 64, 96, 128, 160, 192, 256)
#: band widths a run may polish at on the card: K1 and K3 take W, and the
#: pipeline's 2x mating retry takes 2W
RUN_WIDTHS = tuple(w for w in K1_WIDTHS if 2 * w in K1_WIDTHS)


def check_band_width(width: int, device) -> None:
    """Refuse, before a run starts, a band width the card cannot polish
    at: on a CUDA device W and 2W must both be widths K1 and K3 are built
    for (RUN_WIDTHS).  Any width passes on another device (the plain
    versions take every W).  Raises ValueError naming the allowed
    widths."""
    dev = torch.device(device)
    if dev.type == "cuda" and width not in RUN_WIDTHS:
        raise ValueError(
            f"band width {width} cannot polish on {dev.type}: the kernels "
            f"are built for {K1_WIDTHS} and the 2x band retry needs twice "
            f"the width, so the widths allowed are "
            f"{', '.join(map(str, RUN_WIDTHS))}")


def check_run_band_width(device, banding=None, widths=()) -> None:
    """check_band_width on every width a run with these banding options
    can fix, by effective_band_width's ladder (explicit, PBCCS_BAND_W,
    the tuned profile's band_w, the per-length schedule at both of its
    steps), and on each of ``widths`` (a tuner's band_w candidates).
    Entry points call it after a tune profile is applied."""
    from pbccs_tpu_torch.models.arrow.params import (BandingOptions,
                                                     effective_band_width)

    banding = banding or BandingOptions()
    for jmax in (576, 577):   # the schedule's two steps
        check_band_width(effective_band_width(banding, jmax), device)
    for w in widths:
        check_band_width(w, device)


def check_polisher_width(width: int, device) -> None:
    """Refuse, when a polisher is built, a width K1 and K3 have no build
    for on a CUDA device (one polisher launches at W alone; its 2x retry
    builds another at 2W).  Raises LaunchRefused, a ValueError that the
    pipeline treats as the device's and does not bisect."""
    from pbccs_tpu_torch.ops.cuda_lib import LaunchRefused

    if torch.device(device).type == "cuda" and width not in K1_WIDTHS:
        raise LaunchRefused(f"BatchPolisher: band width {width} is not "
                            f"one the kernels are built for {K1_WIDTHS}")


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


def _third(x: torch.Tensor) -> torch.Tensor:
    """x / 3 as an IEEE float32 divide on every device, as K1 computes it
    (PyTorch's CUDA kernels turn a Python-scalar divisor into a multiply
    by its rounded reciprocal; a tensor divisor keeps the divide)."""
    return x / torch.full((), 3.0, dtype=x.dtype, device=x.device)


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
                      _third(tr_cur[..., TRANS_STICK:TRANS_STICK + 1]))
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
                      _third(tr_cur[..., TRANS_STICK:TRANS_STICK + 1]))
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
# the column scan, the plain version and the kernel's wrapper
# --------------------------------------------------------------------------


def _scan_plain(cm, cd, cc, cg, mask, seed, seedcol, backward: bool):
    """The column scan of K1 (cg None) and of K2 (the Merge carry) in
    plain torch."""
    R, nc, W = cm.shape
    t = -1 if backward else 1
    vals = torch.empty_like(cm)
    ls = torch.empty(R, nc, dtype=cm.dtype, device=cm.device)
    prev = torch.zeros(R, W, dtype=cm.dtype, device=cm.device)
    prev2 = torch.zeros_like(prev)
    sprev = torch.ones(R, 1, dtype=cm.dtype, device=cm.device)
    at_seed = seedcol[:, None].long() == torch.arange(nc, device=cm.device)
    for k in range(nc):
        b = ftz(ftz(cm[:, k] * circ_roll(prev, t)) + ftz(cd[:, k] * prev))
        if cg is not None:
            b = ftz(b + ftz(cg[:, k] * ftz(circ_roll(prev2, t) / sprev)))
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
        prev2, sprev, prev = prev, scale, col
    return vals, ls


def fill_scan_plain(cm, cd, cc, mask, seed, seedcol, backward: bool):
    """The K1 column scan in plain torch, a loop over columns with the
    kernel's exact association: per column b = cm*roll(prev) + cd*prev
    (+ seed at seedcol), the circular Hillis-Steele scan, a divide by the
    column max where mask is set, and log(scale); every product, sum and
    quotient flushed to zero below F32_MIN_NORMAL, as the kernel's
    -ftz=true arithmetic does.  Returns vals (R, nc, W) and log-scales
    (R, nc); column k is stored at k (forward) or nc-1-k (backward)."""
    return _scan_plain(cm, cd, cc, None, mask, seed, seedcol, backward)


def fill_scan_merge_plain(cm, cd, cc, cg, mask, seed, seedcol,
                          backward: bool):
    """The scan half of K2's plain version (ops.quiver_fill_cuda
    .quiver_fill_plain), in plain torch: fill_scan_plain's column plus
    the Merge term b = b + cg * (roll(prev2) / sprev) before the seed,
    prev2 the column two back and sprev the scale applied to the
    previous column (0 and 1 at the first column), each quotient,
    product and sum flushed to zero as in the kernel."""
    return _scan_plain(cm, cd, cc, cg, mask, seed, seedcol, backward)


def arrow_fill_plain(reads, rlens, tpls, trans, tlens, offsets, width: int,
                     pr_miscall: float = MISMATCH_PROBABILITY,
                     alpha: bool = True, beta: bool = True):
    """arrow_fill in plain torch: per direction asked for, the coefficient
    planes (_forward_coeffs / _backward_coeffs), then fill_scan_plain.
    Returns ((vals, log-scales) or None for alpha, the same for beta)."""
    I, J = rlens.to(torch.int32), tlens.to(torch.int32)
    out = []
    for backward, want in ((False, alpha), (True, beta)):
        coeffs = _backward_coeffs if backward else _forward_coeffs
        planes = coeffs(reads.to(torch.int32), I, tpls.to(torch.int32),
                        trans.float(), J, offsets, width,
                        pr_miscall) if want else None
        out.append(fill_scan_plain(*(x.contiguous() for x in planes),
                                   backward) if want else None)
    return tuple(out)


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def arrow_fill(reads, rlens, tpls, trans, tlens, offsets, width: int,
               pr_miscall: float = MISMATCH_PROBABILITY, alpha: bool = True,
               beta: bool = True):
    """K1, the banded Arrow fills of R reads (the TPU `_run_fill` boundary
    with its coefficient precompute): reads (R, Imax) int8 with lengths
    rlens (R,) int32, template windows tpls (R, Jmax) int8 with lengths
    tlens (R,) int32 and transitions trans (R, Jmax, 4) float32, band
    offsets (R, Jmax + 1) int32; `alpha` / `beta` pick the directions, both
    on the same offsets.  Returns ((vals (R, nc, W), log-scales (R, nc)) or
    None for alpha, the same for beta).  CPU tensors run arrow_fill_plain;
    CUDA tensors launch csrc/arrow_fill.cu once on the current stream, both
    directions in that one launch (no fallback; W must be in K1_WIDTHS;
    arguments it cannot launch on raise cuda_lib.LaunchRefused)."""
    args = {"reads": (reads, torch.int8, 2), "rlens": (rlens, torch.int32, 1),
            "tpls": (tpls, torch.int8, 2), "trans": (trans, torch.float32, 3),
            "tlens": (tlens, torch.int32, 1),
            "offsets": (offsets, torch.int32, 2)}
    dev = offsets.device
    for name, (x, _, _) in args.items():
        if x.device != dev:
            raise cuda_lib.LaunchRefused(f"arrow_fill: {name} is on "
                                         f"{x.device}, offsets on {dev}")
    if dev.type == "cpu":
        return arrow_fill_plain(reads, rlens, tpls, trans, tlens, offsets,
                                width, pr_miscall, alpha, beta)
    for name, (x, dtype, ndim) in args.items():
        cuda_lib.check_tensor("arrow_fill", name, x, dtype, ndim)
    R, Imax = reads.shape
    Jmax = tpls.shape[1]
    nc = Jmax + 1
    if width not in K1_WIDTHS:
        raise cuda_lib.LaunchRefused(f"arrow_fill: band width {width} is "
                                     f"not one of {K1_WIDTHS}")
    if Imax < 1 or Jmax < 1 or tuple(offsets.shape) != (R, nc) \
            or tuple(trans.shape) != (R, Jmax, 4) \
            or tuple(rlens.shape) != (R,) or tuple(tlens.shape) != (R,) \
            or tpls.shape[0] != R:
        raise cuda_lib.LaunchRefused(
            f"arrow_fill: shapes do not match: reads {tuple(reads.shape)}, "
            f"tpls {tuple(tpls.shape)}, trans {tuple(trans.shape)}, "
            f"offsets {tuple(offsets.shape)}")
    if trans.data_ptr() % 16:
        raise cuda_lib.LaunchRefused("arrow_fill: trans must be 16-byte "
                                     "aligned")
    if not (alpha or beta):
        raise cuda_lib.LaunchRefused("arrow_fill: neither alpha nor beta "
                                     "asked for")
    if dev.type != "cuda":
        raise cuda_lib.LaunchRefused(f"arrow_fill: unsupported device {dev}")
    outs = [(torch.empty(R, nc, width, device=dev),
             torch.empty(R, nc, device=dev)) if want else None
            for want in (alpha, beta)]
    ptrs = [p for o in outs
            for p in ((o[0].data_ptr(), o[1].data_ptr()) if o else (None,) * 2)]
    fn = cuda_lib.load("arrow_fill").pbccs_arrow_fill
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    hit, miss = 1.0 - pr_miscall, pr_miscall / 3.0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(reads.data_ptr(), rlens.data_ptr(), tpls.data_ptr(),
                 trans.data_ptr(), tlens.data_ptr(), offsets.data_ptr(),
                 *ptrs, R, Imax, Jmax, width, hit, miss, stream)
    cuda_lib.check(err, "arrow_fill")
    cuda_lib.count_launch(arrow_fill)
    return tuple(outs)


arrow_fill.launches = 0


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


def _fills(reads, rlens, tpls, trans, tlens, width: int, pr_miscall: float,
           offsets, alpha: bool, beta: bool):
    """arrow_fill on the operand types K1 takes, as BandedMatrix leaves."""
    offsets = _resolve_offsets(offsets, rlens.to(torch.int32),
                               tlens.to(torch.int32), tpls.shape[1] + 1,
                               width)
    out = arrow_fill(reads.to(torch.int8).contiguous(),
                     rlens.to(torch.int32).contiguous(),
                     tpls.to(torch.int8).contiguous(),
                     trans.float().contiguous(),
                     tlens.to(torch.int32).contiguous(), offsets, width,
                     pr_miscall, alpha, beta)
    return tuple(BandedMatrix(o[0], offsets, o[1]) if o else None
                 for o in out)


def forward_batch(reads, rlens, tpls, trans, tlens, width: int,
                  pr_miscall: float = MISMATCH_PROBABILITY,
                  offsets=None) -> BandedMatrix:
    """Batched banded forward (alpha) fills: reads (R, Imax), rlens (R,),
    tpls (R, Jmax), trans (R, Jmax, 4), tlens (R,).  Returns leaves
    (R, Jmax+1, W) / (R, Jmax+1).  `offsets` (R, >= Jmax+1): precomputed
    monotone band offsets (guided rebanding); default diagonal layout.
    Counterpart of fwdbwd_pallas.pallas_forward_batch."""
    return _fills(reads, rlens, tpls, trans, tlens, width, pr_miscall,
                  offsets, alpha=True, beta=False)[0]


def backward_batch(reads, rlens, tpls, trans, tlens, width: int,
                   pr_miscall: float = MISMATCH_PROBABILITY,
                   offsets=None) -> BandedMatrix:
    """Batched banded backward (beta) fills; conventions of forward_batch
    (counterpart of fwdbwd_pallas.pallas_backward_batch)."""
    return _fills(reads, rlens, tpls, trans, tlens, width, pr_miscall,
                  offsets, alpha=False, beta=True)[1]


def forward_backward_batch(reads, rlens, tpls, trans, tlens, width: int,
                           pr_miscall: float = MISMATCH_PROBABILITY,
                           offsets=None) -> tuple[BandedMatrix, BandedMatrix]:
    """The alpha and beta fills of forward_batch / backward_batch on the
    same band offsets, in one K1 launch on the card."""
    return _fills(reads, rlens, tpls, trans, tlens, width, pr_miscall,
                  offsets, alpha=True, beta=True)


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
