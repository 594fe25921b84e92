"""Dense interior mutation scoring over the 9-slot grid: the K3 kernel
(csrc/dense_score.cu) and the window-frame programs around it.

Port of pbccs_tpu.ops.dense_score_pallas.  For every read r and window
position p the kernel evaluates the Extend(2 columns)+Link algebra
(reference ConsensusCore SimpleRecursor.cpp:373-487, :306-357) for all 9
slots of the position-major mutation grid (subs A/C/G/T, ins A/C/G/T,
del -- models.arrow.mutations._SLOT_* order) and writes the absolute
mutated-window log-likelihood to out[r, p, slot].  Every operand of slot
(p, k) sits at a static offset from p: alpha columns p-2, p-1, beta
columns p+1, p+2, band offsets p-2..p+2, read windows p-1..p+1, scale
prefix/suffix and window template p-3..p+1, and the patch transitions
at p.  Position-indexed operands read as zero outside their arrays, as
the TPU kernel's zero-padded layout does.

The kernel takes the raw inputs (fills, reads, window template and
transitions, the per-read transition tables) and builds the read windows
(`band_read_windows`) and patch transitions (`dense_patch_grids`) of each
position itself; the plain version `dense_score_plain` builds them as
planes.  Both plane functions take an optional column / position list,
so the edge programs and the refill fallback build only the rows they
read.

Scope contract (unchanged from the JAX package): kernel values are valid
only for INTERIOR slots (window position >= 3 and mutation end <=
window_len - 2); other entries are finite garbage the caller masks.
Edge slots come from edge_window_scores_batch (plain torch, as the JAX
package's edge programs are plain JAX).

The TPU layout devices (DenseLayout, halo'd step views, cb blocking,
packed aux planes) are not ported."""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from pbccs_tpu_torch.models.arrow.params import (
    MISMATCH_PROBABILITY,
    TRANS_BRANCH,
    TRANS_DARK,
    TRANS_MATCH,
    TRANS_STICK,
    transition_lookup,
)
from pbccs_tpu_torch.ops import cuda_lib
from pbccs_tpu_torch.ops.fwdbwd import (BandedMatrix, _affine_scan_circ,
                                        circ_roll, circ_rows, ftz)
from pbccs_tpu_torch.ops.fwdbwd_cuda import K1_WIDTHS, _third, window_rows_circ
from pbccs_tpu_torch.ops.mutation_score import (_circ_rows_batch, _ext_col,
                                                _in_band)

_TINY = 1e-30
PB = 64           # template positions per live flag (liveness granule)
N_SLOTS = 9
#: band widths K3 is built for (csrc/dense_score.cu): those K1 fills
K3_WIDTHS = K1_WIDTHS
_HIT = 1.0 - MISMATCH_PROBABILITY
_MISS = MISMATCH_PROBABILITY / 3.0


# --------------------------------------------------------------------------
# window-frame patch grids and read windows
# --------------------------------------------------------------------------


def dense_patch_grids(win_tpl, win_trans, table, wl, pos=None) -> torch.Tensor:
    """Virtual-mutation patch TRANSITION planes for the window-frame slot
    grid of a read batch.

    win_tpl (R, Jm) int; win_trans (R, Jm, 4); table (R, 8, 4); wl (R,);
    pos (R, K) window positions in [0, Jm), default every position.
    Returns (R, K, 9, 2, 4) f32: for slot (pos, k) the transition rows
    the mutation patches in at virtual positions pos-1 and pos
    (make_patches_fast values; neighbours clipped to the window).  Slot
    order: subs A,C,G,T; ins A,C,G,T; del.  Pure selection: the rows at
    given positions are bitwise the full grid's."""
    R, Jm = win_tpl.shape
    dev = win_tpl.device
    if pos is None:
        pos = torch.arange(Jm, device=dev)[None, :].expand(R, Jm)
    pos = pos.long()
    L = wl.to(torch.int64)[:, None]
    t64 = win_tpl.to(torch.int64)
    near = lambda k: (pos + k).clamp(0, Jm - 1)  # noqa: E731
    cur_b = t64.gather(1, near(0))
    prev_b = t64.gather(1, near(-1))
    next_b = t64.gather(1, near(1))
    trans_p1 = win_trans.float().gather(
        1, near(1)[..., None].expand(-1, -1, 4))

    def T(a, b):
        return transition_lookup(a, b, table)

    def gate(cond, v):
        return torch.where(cond[..., None], v, 0.0)

    slots = []
    for b in range(4):                                       # SUB b
        nb = torch.full_like(cur_b, b)
        slots.append(torch.stack([gate(pos > 0, T(prev_b, nb)),
                                  gate(pos + 1 < L, T(nb, next_b))], 2))
    for b in range(4):                                       # INS b
        nb = torch.full_like(cur_b, b)
        slots.append(torch.stack([gate(pos > 0, T(prev_b, nb)),
                                  gate(pos < L, T(nb, cur_b))], 2))
    slots.append(torch.stack([                               # DEL
        gate((pos > 0) & (pos < L - 1), T(prev_b, next_b)),
        gate(pos < L - 1, trans_p1)], 2))
    return torch.stack(slots, 2)


def band_read_windows(reads: torch.Tensor, offsets: torch.Tensor,
                      width: int, cols=None):
    """(rbase, rnext), each (R, K, W) f32: the circular-lane read windows
    of band columns `cols` (R, K) (default every column, K = nc).
    rnext[r, j, L] is read[row] for the band row lane L of column j holds
    (the insertion/link operand), 0 past the read array; rbase the
    read[row - 1] value (the emission operand).

    rbase derives from rnext: rbase[j] = circ_roll(rnext[j], 1) at every
    lane except the band's first row (the cut lane o_j % W), whose
    operand row o_j - 1 lives in column j-1's window at the same rolled
    lane (column 0 uses its own).  When o_j == o_{j-1} that cut lane
    holds garbage (read[o_j + W - 1]); every consumer masks it: the cut
    lane's match operand is gated by in_band(rows - 1, o_prev), its
    insertion operand by rows > o_col, and rows outside [1, I] by
    in_read.  Any new consumer of rbase must keep those gates.  Given
    columns are bitwise the full planes' columns, cut lane included."""
    if cols is None:
        o = offsets
        o_prev = torch.cat([offsets[:, :1], offsets[:, :-1]], dim=1)
    else:
        cols = cols.long()
        o = offsets.gather(1, cols)
        o_prev = offsets.gather(1, (cols - 1).clamp(min=0))
    x = reads.float()
    rnext = window_rows_circ(x, o, width)
    prev_col = window_rows_circ(x, o_prev, width)
    lane = torch.arange(width, device=reads.device)
    cut = (o % width)[:, :, None] == lane
    rbase = torch.where(cut, circ_roll(prev_col, 1), circ_roll(rnext, 1))
    return rbase, rnext


# --------------------------------------------------------------------------
# the interior kernel: wrapper and plain version
# --------------------------------------------------------------------------


def _at(x: torch.Tensor, off: int, n_pos: int) -> torch.Tensor:
    """x[:, p + off] for p in range(n_pos), zero outside x's axis 1."""
    n = x.shape[1]
    idx = torch.arange(n_pos, device=x.device) + off
    ok = (idx >= 0) & (idx < n)
    got = x[:, idx.clamp(0, n - 1)]
    ok = ok.view((1, n_pos) + (1,) * (x.dim() - 2))
    return torch.where(ok, got, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


_XOR_STEPS = (16, 8, 4, 2, 1)


def band_sum(x: torch.Tensor) -> torch.Tensor:
    """x.sum(-1) over the W band lanes in the kernel's order: lanes are
    viewed as (W / 32 slots, 32 threads) -- csrc/band_scan.cuh's strided
    layout, zero-padded to a multiple of 32 -- each thread adds its slots
    in turn, then five xor-butterfly steps add across threads.  The terms
    are non-negative and flushed, so no partial sum is subnormal."""
    pad = -x.shape[-1] % 32
    v = F.pad(x, (0, pad)).unflatten(-1, (-1, 32))
    acc = v[..., 0, :]
    for s in range(1, v.shape[-2]):
        acc = acc + v[..., s, :]
    lane = torch.arange(32, device=x.device)
    for o in _XOR_STEPS:
        acc = acc + acc[..., lane ^ o]
    return acc[..., 0]


def _dense_rows_plain(alpha, beta, rbase, rnext, offsets, apre, bsuf,
                      wtpl, wtrans, ptrans, rlens, hit, miss):
    """All 9 slot scores of every position of a few reads from the
    operand planes (band_read_windows, dense_patch_grids): the kernel's
    arithmetic vectorised over (R, Jm, W), every product and sum flushed
    to zero below F32_MIN_NORMAL as the kernel's -ftz=true arithmetic
    does (fwdbwd.ftz), the band sums in its order (band_sum)."""
    W = alpha.shape[2]
    Jm = wtpl.shape[1]
    I = rlens.to(torch.int32)[:, None, None]
    at = lambda x, off: _at(x, off, Jm)  # noqa: E731

    a_m1, a_m2 = at(alpha, -1), at(alpha, -2)
    b_p1, b_p2 = at(beta, 1), at(beta, 2)
    rb_m1, rb_0, rb_p1 = at(rbase, -1), at(rbase, 0), at(rbase, 1)
    rn_0, rn_p1 = at(rnext, 0), at(rnext, 1)
    o_m2, o_m1, o_0, o_p1, o_p2 = (at(offsets, k)[..., None]
                                   for k in (-2, -1, 0, 1, 2))
    ap_m1, ap_0 = at(apre, -1), at(apre, 0)
    bs_p1, bs_p2 = at(bsuf, 1), at(bsuf, 2)
    wf = wtpl.float()
    w_m2, w_m1, w_0, w_p1 = (at(wf, k)[..., None] for k in (-2, -1, 0, 1))
    wt_m3, wt_m2 = at(wtrans, -3), at(wtrans, -2)
    pt = ptrans                                   # (R, Jm, 9, 2, 4)

    crows = lambda o: circ_rows(o[..., 0], W)  # noqa: E731
    rows_m1, rows_0, rows_p1 = crows(o_m1), crows(o_0), crows(o_p1)

    def in_band(rows, o):
        return (rows >= o) & (rows < o + W)

    def tr(x, k):
        return x[..., k:k + 1]

    def ext_parts(prev, o_prev, rows):
        pm1 = torch.where(in_band(rows - 1, o_prev), circ_roll(prev, 1), 0.0)
        p0 = torch.where(in_band(rows, o_prev), prev, 0.0)
        return pm1, p0

    def ext_b(pm1, p0, rows, em, prev_tr):
        in_read = (rows >= 1) & (rows <= I)
        b = ftz(ftz(pm1 * em)
                * torch.where(rows < I, tr(prev_tr, TRANS_MATCH), 0.0))
        b = ftz(b + torch.where(rows != I, ftz(p0 * tr(prev_tr, TRANS_DARK)),
                                0.0))
        return torch.where(in_read, b, 0.0)

    def cmask(rows, o_col):
        return (rows > 1) & (rows < I) & (rows > o_col)

    def ext_c(mask_c, rb, next_b, cur_tr):
        ins_em = torch.where(rb == next_b, tr(cur_tr, TRANS_BRANCH),
                             _third(tr(cur_tr, TRANS_STICK)))
        return torch.where(mask_c, ins_em, 0.0)

    def ext_col(prev, o_prev, o_col, rows, rb, cur_b, next_b, prev_tr,
                cur_tr):
        pm1, p0 = ext_parts(prev, o_prev, rows)
        em = torch.where(rb == cur_b, hit, miss)
        b = ext_b(pm1, p0, rows, em, prev_tr)
        c = ext_c(cmask(rows, o_col), rb, next_b, cur_tr)
        return _affine_scan_circ(b, c)

    def beta_pair(rows, bcol, o_b):
        beta_ip1 = torch.where(in_band(rows + 1, o_b), circ_roll(bcol, -1),
                               0.0)
        beta_i = torch.where(in_band(rows, o_b), bcol, 0.0)
        return beta_ip1, beta_i

    def link_shared(ext1, link_tr, mterm, beta_i, apre_s, bsuf_b):
        match = ftz(ftz(ext1 * tr(link_tr, TRANS_MATCH)) * mterm)
        dele = ftz(ftz(ext1 * tr(link_tr, TRANS_DARK)) * beta_i)
        v = band_sum(ftz(match + dele))
        return torch.log(torch.clamp(v, min=_TINY)) + apre_s + bsuf_b

    outs = [None] * N_SLOTS
    pm1_0, p0_0 = ext_parts(a_m1, o_m1, rows_0)
    em_0 = torch.where(rb_0 == w_m1, hit, miss)
    b0_shared = ext_b(pm1_0, p0_0, rows_0, em_0, wt_m2)
    mask_c0 = cmask(rows_0, o_0)
    mask_c1 = cmask(rows_p1, o_p1)
    lt_p1 = rows_p1 < I
    bip1_s, bi_s = beta_pair(rows_p1, b_p2, o_p2)
    em_s = torch.where(rn_p1 == w_p1, hit, miss)
    mterm_s = torch.where(lt_p1, ftz(em_s * bip1_s), 0.0)
    bip1_i, bi_i = beta_pair(rows_p1, b_p1, o_p1)
    em_i = torch.where(rn_p1 == w_0, hit, miss)
    mterm_i = torch.where(lt_p1, ftz(em_i * bip1_i), 0.0)
    for b in range(4):
        t0, t1s, t1i = pt[:, :, b, 0], pt[:, :, b, 1], pt[:, :, 4 + b, 1]
        nb = float(b)
        ext0 = _affine_scan_circ(b0_shared, ext_c(mask_c0, rb_0, nb, t0))
        pm1_1, p0_1 = ext_parts(ext0, o_0, rows_p1)
        em_1 = torch.where(rb_p1 == nb, hit, miss)
        b1 = ext_b(pm1_1, p0_1, rows_p1, em_1, t0)
        ext1s = _affine_scan_circ(b1, ext_c(mask_c1, rb_p1, w_p1, t1s))
        outs[b] = link_shared(ext1s, t1s, mterm_s, bi_s, ap_0, bs_p2)
        ext1i = _affine_scan_circ(b1, ext_c(mask_c1, rb_p1, w_0, t1i))
        outs[4 + b] = link_shared(ext1i, t1i, mterm_i, bi_i, ap_0, bs_p1)
    t0 = pt[:, :, 8, 0]
    ext0 = ext_col(a_m2, o_m2, o_m1, rows_m1, rb_m1, w_m2, w_m1, wt_m3, wt_m2)
    ext1 = ext_col(ext0, o_m1, o_0, rows_0, rb_0, w_m1, w_p1, wt_m2, t0)
    em_link = torch.where(rn_0 == w_p1, hit, miss)
    beta_ip1, beta_i = beta_pair(rows_0, b_p2, o_p2)
    mterm = torch.where(rows_0 < I, ftz(em_link * beta_ip1), 0.0)
    outs[8] = link_shared(ext1, t0, mterm, beta_i, ap_m1, bs_p2)
    return torch.stack(outs, dim=2)


def dense_score_plain(alpha, beta, offsets, apre, bsuf, reads, rlens,
                      win_tpl, wlens, win_trans, tables, live,
                      hit: float = _HIT, miss: float = _MISS) -> torch.Tensor:
    """The kernel's function in plain torch, on dense_score's arguments:
    (R, Jm, 9) scores, zero in dead (read, 64-position block) cells.
    Reads are processed in chunks, each building its read windows
    (band_read_windows) and patch grid (dense_patch_grids) as planes, so
    the (R, Jm, W) intermediates stay bounded."""
    R, nc, W = alpha.shape
    Jm = win_tpl.shape[1]
    out = torch.zeros(R, Jm, N_SLOTS, dtype=torch.float32,
                      device=alpha.device)
    step = max(1, (1 << 22) // max(Jm * W, 1))
    for lo in range(0, R, step):
        sl = slice(lo, lo + step)
        rbase, rnext = band_read_windows(reads[sl], offsets[sl], W)
        ptrans = dense_patch_grids(win_tpl[sl], win_trans[sl], tables[sl],
                                   wlens[sl])
        out[sl] = _dense_rows_plain(
            alpha[sl], beta[sl], rbase, rnext, offsets[sl], apre[sl],
            bsuf[sl], win_tpl[sl], win_trans[sl], ptrans, rlens[sl], hit,
            miss)
    live_pos = live[:, torch.arange(Jm, device=out.device) // PB] != 0
    return torch.where(live_pos[:, :, None], out, 0.0)


def _check(name: str, x: torch.Tensor, shape: tuple, dtype, dev) -> None:
    refuse = cuda_lib.LaunchRefused
    if x.device != dev:
        raise refuse(f"dense_score: {name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise refuse(f"dense_score: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise refuse(f"dense_score: {name} has shape {tuple(x.shape)}, "
                     f"expected {shape}")
    if not x.is_contiguous():
        raise refuse(f"dense_score: {name} must be contiguous")


_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def dense_score(alpha, beta, offsets, apre, bsuf, reads, rlens, win_tpl,
                wlens, win_trans, tables, live) -> torch.Tensor:
    """The K3 interior scorer: (R, Jm, 9) slot log-likelihoods.

    alpha, beta (R, nc, W) f32 band values on the band offsets (R, nc)
    int32, with their scale prefix / suffix apre, bsuf (R, nc+1) f32;
    reads (R, Imax) int8 with rlens (R,) int32; the window template
    win_tpl (R, Jm) int8 with wlens (R,) int32 and win_trans (R, Jm, 4)
    f32; the per-read transition tables (R, 8, 4) f32; live
    (R, ceil(Jm/64)) int32, 0 = dead block (written as zeros).  CPU
    tensors run dense_score_plain; CUDA tensors launch
    csrc/dense_score.cu on the current stream (no fallback; W must be in
    K3_WIDTHS; arguments it cannot launch on raise
    cuda_lib.LaunchRefused)."""
    dev = alpha.device
    R, nc, W = alpha.shape
    Imax, Jm = reads.shape[1], win_tpl.shape[1]
    NB = -(-Jm // PB)
    f32, i32, i8 = torch.float32, torch.int32, torch.int8
    args = (("alpha", alpha, (R, nc, W), f32), ("beta", beta, (R, nc, W), f32),
            ("offsets", offsets, (R, nc), i32),
            ("apre", apre, (R, nc + 1), f32), ("bsuf", bsuf, (R, nc + 1), f32),
            ("reads", reads, (R, Imax), i8), ("rlens", rlens, (R,), i32),
            ("win_tpl", win_tpl, (R, Jm), i8), ("wlens", wlens, (R,), i32),
            ("win_trans", win_trans, (R, Jm, 4), f32),
            ("tables", tables, (R, 8, 4), f32), ("live", live, (R, NB), i32))
    for name, x, _, _ in args:
        if x.device != dev:
            raise cuda_lib.LaunchRefused(f"dense_score: {name} is on "
                                         f"{x.device}, alpha on {dev}")
    if dev.type == "cpu":
        return dense_score_plain(alpha, beta, offsets, apre, bsuf, reads,
                                 rlens, win_tpl, wlens, win_trans, tables,
                                 live)
    for name, x, shape, dtype in args:
        _check(name, x, shape, dtype, dev)
    if W not in K3_WIDTHS:
        raise cuda_lib.LaunchRefused(f"dense_score: band width {W} is not "
                                     f"one of {K3_WIDTHS}")
    if win_trans.data_ptr() % 16 or tables.data_ptr() % 16:
        raise cuda_lib.LaunchRefused("dense_score: win_trans and tables must "
                                     "be 16-byte aligned")
    if dev.type != "cuda":
        raise cuda_lib.LaunchRefused(f"dense_score: unsupported device {dev}")
    out = torch.empty(R, Jm, N_SLOTS, dtype=f32, device=dev)
    fn = cuda_lib.load("dense_score").pbccs_dense_score
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(alpha.data_ptr(), beta.data_ptr(), offsets.data_ptr(),
                 apre.data_ptr(), bsuf.data_ptr(), reads.data_ptr(),
                 rlens.data_ptr(), win_tpl.data_ptr(), wlens.data_ptr(),
                 win_trans.data_ptr(), tables.data_ptr(), live.data_ptr(),
                 out.data_ptr(), R, nc, Imax, Jm, NB, W, _HIT, _MISS, stream)
    cuda_lib.check(err, "dense_score")
    cuda_lib.count_launch(dense_score)
    return out


dense_score.launches = 0


def dense_interior_scores_batch(reads, rlens, win_tpl, win_trans, wlens,
                                tables, alpha: BandedMatrix,
                                beta: BandedMatrix, apre, bsuf, width: int,
                                live=None) -> torch.Tensor:
    """(R, Jm, 9) window-frame interior scores for a flat read batch.

    reads (R, Imax); rlens (R,); win_tpl (R, Jm); win_trans (R, Jm, 4);
    wlens (R,); tables (R, 8, 4); alpha/beta the banded fills of the
    unmutated windows on alpha's band offsets; apre/bsuf (R, nc+1).
    `live` (R, NB) bool gates 64-position blocks (default all live)."""
    R, Jm = win_tpl.shape
    if live is None:
        live = torch.ones(R, -(-Jm // PB), dtype=torch.bool,
                          device=reads.device)
    i32 = torch.int32
    return dense_score(
        alpha.vals.contiguous(), beta.vals.contiguous(),
        alpha.offsets.to(i32).contiguous(), apre.float().contiguous(),
        bsuf.float().contiguous(), reads.to(torch.int8).contiguous(),
        rlens.to(i32).contiguous(), win_tpl.to(torch.int8).contiguous(),
        wlens.to(i32).contiguous(), win_trans.float().contiguous(),
        tables.float().contiguous(), live.to(i32).contiguous())


# --------------------------------------------------------------------------
# window-frame edge-slot scoring (plain torch)
#
# Slots the interior kernel cannot score sit at STATIC window-frame
# positions: near-begin rows {0, 1, 2} and near-end rows {J-2, J-1, J}.
# The same extend/link algebra (the edge_scores_fast oracle, reference
# MutationScorer.cpp:208-231) is evaluated per read over a (6, 9) slot
# grid whose per-slot geometry is static, so every lookup below is a
# gather with a static index table or one J-relative window per read.
# --------------------------------------------------------------------------

_K27 = np.tile(np.arange(9), 3)
_Q27 = np.repeat(np.arange(3), 9)
_SHIFT27 = np.array([0, 0, 0, 0, -1, -1, -1, -1, 1])[_K27]
_LD27 = -_SHIFT27
_NEWBASE27 = np.array([0, 1, 2, 3, 0, 1, 2, 3, -1])[_K27]
_ISDEL27 = _K27 == 8
# near-end replace mask: row J-2 keeps its ins slots (they are interior)
_NE_MASK9 = np.array([[True] * 4 + [False] * 4 + [True],
                      [True] * 9,
                      [True] * 9])
# t = s - (J-4) in {1..4} per near-end slot (s = p - [k == del])
_T27 = _Q27 + 2 - _ISDEL27.astype(int)


def _virtual_table(v, p):
    """Static lookup plan of the virtual (mutated) template at virtual
    index v for each of the 27 slots with mutation position p: the
    mutation patches positions p-1 and p and shifts indices beyond p.
    Returns (base_idx, base_is_const, trans_kind, trans_idx): trans_kind
    0 = unmutated row trans_idx, 1 / 2 = patch column 0 / 1."""
    below, at = v == p - 1, v == p
    idx = np.where(v > p, v + _SHIFT27, v)
    base_idx = np.where(below, p - 1, np.where(at & _ISDEL27, p + 1, idx))
    base_const = at & ~_ISDEL27
    trans_kind = np.where(below, 1, np.where(at, 2, 0))
    return base_idx, base_const, trans_kind, idx


class _VirtualLookup:
    """vB(v) / vT(v) of the edge programs over a batch: the virtual base
    (R, 27) and transition row (R, 27, 4) at virtual index v, from
    per-read template/transition tracks and the 27 slots' patch rows."""

    def __init__(self, tplf, trans, pt, q):
        self.tplf, self.trans, self.pt = tplf, trans, pt
        self.dev = tplf.device
        self.q = torch.as_tensor(q, device=self.dev)
        self.k = torch.as_tensor(_K27, device=self.dev)
        self.newbase = torch.as_tensor(_NEWBASE27, dtype=torch.float32,
                                       device=self.dev)

    def base(self, v, p):
        idx, const, _, _ = _virtual_table(v, p)
        idx = torch.as_tensor(idx, device=self.dev).clamp(
            0, self.tplf.shape[1] - 1)
        const = torch.as_tensor(const, device=self.dev)
        return torch.where(const, self.newbase, self.tplf[:, idx])

    def trans_row(self, v, p):
        _, _, kind, idx = _virtual_table(v, p)
        idx = torch.as_tensor(idx, device=self.dev).clamp(
            0, self.trans.shape[1] - 1)
        kind = torch.as_tensor(kind, device=self.dev)
        patched = self.pt[:, self.q, self.k, (kind - 1).clamp(min=0)]
        return torch.where((kind > 0)[:, None], patched, self.trans[:, idx])


def _window(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """x[r, start[r] : start[r] + size] along axis 1, with start clamped
    into range (lax.dynamic_slice semantics)."""
    start = start.clamp(0, x.shape[1] - size)
    idx = start[:, None].long() + torch.arange(size, device=x.device)
    idx = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(
        (x.shape[0], size) + x.shape[2:])
    return torch.gather(x, 1, idx)


def _edge_columns(J, nc: int) -> torch.Tensor:
    """(R, 10) band columns the edge programs read: 1..4 (near-begin
    refill; column 4 also for its link) and J-3..J+2 (near-end), the
    latter as a window of the columns padded with two copies of the last
    one, its start clamped into range (lax.dynamic_slice semantics)."""
    dev = J.device
    start = (J.long() - 3).clamp(0, nc + 2 - 6)
    ne = (start[:, None] + torch.arange(6, device=dev)).clamp(max=nc - 1)
    nb = torch.arange(1, 5, device=dev).expand(J.shape[0], 4)
    return torch.cat([nb, ne], dim=1)


def _edge_read_windows(reads, offsets, J, W: int) -> torch.Tensor:
    """(R, 11, W) circular-lane read windows for the edge programs, built
    for the columns they read only: rows 0-3 = rbase of columns 1..4
    (near-begin refill), row 4 = the rnext window of column 4 (near-begin
    link), rows 5-10 = rbase of columns J-3..J+2 (near-end)."""
    rbase, rnext = band_read_windows(reads, offsets, W,
                                     _edge_columns(J, offsets.shape[1]))
    return torch.cat([rbase[:, :4], rnext[:, 3:4], rbase[:, 4:]], dim=1)


def _edge_positions(J, Jm: int) -> torch.Tensor:
    """(R, 6) window positions whose patch rows the edge programs read:
    0, 1, 2 and J-2..J (a window of 3 with its start clamped into
    range)."""
    dev = J.device
    start = (J.long() - 2).clamp(0, Jm - 3)
    ne = start[:, None] + torch.arange(3, device=dev)
    return torch.cat([torch.arange(3, device=dev).expand(J.shape[0], 3), ne],
                     dim=1)


def _edge_nb_read(wins, I, tpl, trans, J, offs, bvals, boffs, bsuf, pt3,
                  *, W: int):
    """Near-begin scores: (R, 27) absolute LLs for slots at window
    positions {0, 1, 2}: refill virtual DP columns 1..4 from the pinned
    start, then LinkAlphaBeta at virtual column 4 against saved beta
    column 5 - ld (edge_scores_fast's near-begin branch)."""
    R = wins.shape[0]
    M = 27
    dev = wins.device
    hit, miss = _HIT, _MISS
    maxl = J[:, None] + torch.as_tensor(_LD27, device=dev)
    vl = _VirtualLookup(tpl.float(), trans, pt3, _Q27)
    vB = lambda v: vl.base(np.full(M, v), _Q27)  # noqa: E731
    vT = lambda v: vl.trans_row(np.full(M, v), _Q27)  # noqa: E731
    Im = I[:, None].expand(R, M)

    ext = torch.zeros(R, M, W, device=dev)
    ext[:, :, 0] = 1.0                                   # alpha(0,0) = 1
    o_prev = offs[:, 0]
    for j in range(1, 5):
        o_j = offs[:, j]
        ext = _ext_col(ext, o_prev[:, None].expand(R, M),
                       o_j[:, None].expand(R, M),
                       wins[:, j - 1][:, None].expand(R, M, W),
                       torch.full((R, M), j, dtype=torch.int32, device=dev),
                       vB(j - 1), vB(j), vT(j - 2), vT(j - 1),
                       I=Im, max_left=maxl, hit=hit, em_miss=miss, W=W)
        o_prev = o_j

    blc = torch.as_tensor(5 + _SHIFT27, device=dev)        # 5 - ld
    B_col = bvals[:, blc]                                  # (R, 27, W)
    o_b = boffs[:, blc]
    bsuf_b = bsuf[:, blc]
    rows4 = _circ_rows_batch(offs[:, 4], W)[:, None, :]
    link_tr = vT(3)
    link_b = vB(4)
    em_link = torch.where(wins[:, 4][:, None] == link_b[..., None], hit, miss)
    beta_ip1 = torch.where(_in_band(rows4 + 1, o_b, W), circ_roll(B_col, -1),
                           0.0)
    beta_i = torch.where(_in_band(rows4, o_b, W), B_col, 0.0)
    match = ftz(ftz(ftz(ext * link_tr[..., TRANS_MATCH:TRANS_MATCH + 1])
                    * em_link) * beta_ip1)
    match = torch.where(rows4 < I[:, None, None], match, 0.0)
    dele = ftz(ftz(ext * link_tr[..., TRANS_DARK:TRANS_DARK + 1]) * beta_i)
    v = ftz(match + dele).sum(-1)
    return torch.log(torch.clamp(v, min=_TINY)) + bsuf_b


def _edge_ne_read(wins, I, tpl, trans, J, avals, offs, apre, ptS,
                  *, W: int):
    """Near-end scores: (R, 27) absolute LLs for slots at window positions
    {J-2, J-1, J}: extend saved alpha columns s..s+2 through the pinned
    (I, J') corner; LL = log corner + alpha scale prefix
    (edge_scores_fast's near-end branch).  Geometry is static in the
    J-relative frame; ptS (R, 3, 9, 2, 4) the patch rows of positions
    J-2..J.  Valid for J >= 8 (tiny windows bail)."""
    R = wins.shape[0]
    M = 27
    dev = wins.device
    hit, miss = _HIT, _MISS
    maxl = J[:, None] + torch.as_tensor(_LD27, device=dev)

    A5 = _window(avals, J - 4, 5)                          # cols J-4..J
    offs_pad = torch.cat([offs, offs[:, -1:], offs[:, -1:]], dim=1)
    offs7 = _window(offs_pad, J - 4, 7)                    # J-4..J+2
    apre4 = _window(apre, J - 3, 4)                        # J-3..J
    tplS = _window(torch.cat([tpl.float(), torch.full(
        (R, 4), 4.0, device=dev)], dim=1), J - 6, 10)
    transS = _window(torch.cat([trans, torch.zeros(R, 3, 4, device=dev)],
                               dim=1), J - 6, 9)
    rb6 = wins[:, 5:11]                                    # cols J-3..J+2

    t = _T27
    cl = lambda a, hi: torch.as_tensor(np.clip(a, 0, hi), device=dev)  # noqa: E731
    o_sm1, o_s = offs7[:, cl(t - 1, 6)], offs7[:, cl(t, 6)]
    o_s1, o_s2 = offs7[:, cl(t + 1, 6)], offs7[:, cl(t + 2, 6)]
    A_prev = A5[:, cl(t - 1, 4)]
    rb_s, rb_s1 = rb6[:, cl(t - 1, 5)], rb6[:, cl(t, 5)]
    rb_s2 = rb6[:, cl(t + 1, 5)]
    s_col = J[:, None] - 4 + torch.as_tensor(t, device=dev)
    apre_s = apre4[:, cl(t - 1, 3)]

    # virtual lookups at J-relative indices: r = v - (J-6); slot position
    # p_rel = 4 + q, queried at s-1..s+2 (bases) and s-2..s+1 (trans)
    vl = _VirtualLookup(tplS, transS, ptS, _Q27)
    p_rel = 4 + _Q27
    vB = lambda dv: vl.base(2 + t + dv, p_rel)  # noqa: E731
    vT = lambda dv: vl.trans_row(2 + t + dv, p_rel)  # noqa: E731
    Im = I[:, None].expand(R, M)
    col = lambda prev, op, oc, rb, jc, d: _ext_col(  # noqa: E731
        prev, op, oc, rb, jc, vB(d - 1), vB(d), vT(d - 2), vT(d - 1),
        I=Im, max_left=maxl, hit=hit, em_miss=miss, W=W)
    ext0 = col(A_prev, o_sm1, o_s, rb_s, s_col, 0)
    ext1 = col(ext0, o_s, o_s1, rb_s1, s_col + 1, 1)
    ext2 = col(ext1, o_s1, o_s2, rb_s2, s_col + 2, 2)

    kstar = maxl - s_col                                   # 1 or 2
    corner_vals = torch.where((kstar == 1)[..., None], ext1, ext2)
    o_corner = torch.where(kstar == 1, o_s1, o_s2)
    lane = torch.arange(W, device=dev)
    in_b = (Im >= o_corner) & (Im < o_corner + W)
    pick = (lane == (I % W)[:, None, None]) & in_b[..., None]
    corner = torch.where(pick, corner_vals, 0.0).sum(-1)
    return torch.log(torch.clamp(corner, min=_TINY)) + apre_s


def edge_window_scores_batch(reads, rlens, win_tpl, win_trans, wlens,
                             tables, alpha: BandedMatrix, beta: BandedMatrix,
                             apre, bsuf, width: int) -> torch.Tensor:
    """(R, 6, 9) window-frame edge-slot scores: rows 0..2 = window
    positions {0, 1, 2}, rows 3..5 = {J-2, J-1, J}.  Entries whose slot
    is interior (ins at J-2) or invalid are garbage the caller masks or
    splices around.  Builds only the read-window columns and patch rows
    it reads (_edge_columns, _edge_positions)."""
    I = rlens.to(torch.int32)
    J = wlens.to(torch.int32)
    tpl = win_tpl.to(torch.int32)
    trans = win_trans.float()
    aoffs = alpha.offsets.to(torch.int32)
    wins = _edge_read_windows(reads, aoffs, J, width)
    pt6 = dense_patch_grids(win_tpl, win_trans, tables, wlens,
                            _edge_positions(J, win_tpl.shape[1]))
    nb = _edge_nb_read(wins, I, tpl, trans, J, aoffs, beta.vals,
                       beta.offsets.to(torch.int32), bsuf, pt6[:, :3],
                       W=width)
    ne = _edge_ne_read(wins, I, tpl, trans, J, alpha.vals, aoffs, apre,
                       pt6[:, 3:], W=width)
    R = reads.shape[0]
    return torch.cat([nb.reshape(R, 3, 9), ne.reshape(R, 3, 9)], dim=1)


def splice_edge_rows(grid, e6, J) -> torch.Tensor:
    """Overwrite each read's window-frame grid rows {0,1,2, J-2,J-1,J}
    with the edge scores (ins at J-2 keeps its interior-kernel value).
    grid (R, Jm, 9); e6 (R, 6, 9); J (R,)."""
    R, Jm, _ = grid.shape
    pos = torch.arange(Jm, device=grid.device)[None, :, None]
    head = torch.zeros_like(grid)
    head[:, :3] = e6[:, :3]
    out = torch.where(pos < 3, head, grid)
    ne_mask = torch.as_tensor(_NE_MASK9, device=grid.device)
    J3 = J.to(torch.int64)[:, None, None]
    for i in range(3):
        sel = (pos == J3 - 2 + i) & ne_mask[i]
        out = torch.where(sel, e6[:, 3 + i][:, None, :], out)
    return out


# rev-frame slot permutation: sub b <-> sub 3-b, ins b <-> ins 3-b, del
_REV_PERM = np.array([3, 2, 1, 0, 7, 6, 5, 4, 8])


def window_grid_to_template(grid, strand, ts, te, Jmax: int) -> torch.Tensor:
    """Map each read's window-frame (Jm, 9) score grid onto the
    template-frame slot grid (Jmax, 9).  grid (R, Jm, 9); strand, ts, te
    (R,).

    Forward reads: template position P reads grid[P - ts].  Reverse
    reads score the reverse-complement template, so (P, sub b) reads
    grid[te-1-P, sub 3-b], (P, ins b) reads grid[te-P, ins 3-b] and
    (P, del) reads grid[te-1-P, del].  Out-of-window entries are 0 and
    must be masked by the caller."""
    R, Jm, S = grid.shape
    dev = grid.device
    gpad = torch.cat([grid, torch.zeros(R, 1, S, dtype=grid.dtype,
                                        device=dev)], dim=1)
    P = torch.arange(Jmax, device=dev)[None, :]

    def pick(src, idx):
        safe = torch.where((idx >= 0) & (idx < Jm), idx, Jm)
        return torch.gather(src, 1, safe[..., None].expand(R, Jmax, S))

    ts = ts.to(torch.int64)[:, None]
    te = te.to(torch.int64)[:, None]
    fwd = pick(gpad, P - ts)
    rev_g = gpad[:, :, torch.as_tensor(_REV_PERM, device=dev)]
    rev_subdel = pick(rev_g, te - 1 - P)
    rev_ins = pick(rev_g, te - P)
    rev = torch.cat([rev_subdel[..., :4], rev_ins[..., 4:8],
                     rev_subdel[..., 8:]], dim=2)
    return torch.where((strand == 0)[:, None, None], fwd, rev)
