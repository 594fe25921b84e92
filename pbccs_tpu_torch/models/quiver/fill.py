"""Banded Quiver forward/backward fills: coefficient precompute + the K2
merge-mode column scan (csrc/fill_scan.cu).

Port of pbccs_tpu.models.quiver.pallas_fill.  Same two-step design as
the Arrow fills (ops.fwdbwd_cuda): a torch coefficient precompute turns
the Quiver recurrence (reference ConsensusCore/src/C++/Quiver/
SimpleRecursor.cpp:62-231, move scores QvEvaluator.hpp:160-207) into
per-column circular-lane band coefficients (fwdbwd.BandedMatrix: cell
(i, j) at lane i mod W)

    col[L] = cm[L] * roll(prev, 1)[L]               (Incorporate)
           + cd[L] * prev[L]                        (Delete)
           + cg[L] * roll(prev2, 1)[L] / scale_prev (Merge, from j-2)
           + cc[L] * col[L-1 circ]                  (Extra, in-column)

with every band-membership mask folded into cm/cd/cg and the circular
scan's cut into cc, and the K2 scan (ops.fwdbwd_cuda.fill_scan_merge)
runs the columns with the two-column Merge carry.  The backward (beta)
fill runs the scan in backward mode over kernel columns k holding beta
column j = Jmax - k, stored at output column Jmax - k, so the returned
matrix is in natural column order.

Layout: coefficients are (R, nc, W), read-major, with nc = Jmax + 1 (the
TPU's 64-column and power-of-two padding bounded its compiled-program
menu and is not needed here: columns past a read's template length are
dead, so the LLs do not depend on Jmax or Imax).  Feature windows are
plain gathers where the TPU used one-hot matmuls (exact either way)."""

from __future__ import annotations

import torch

from pbccs_tpu_torch.models.quiver.params import MERGE, QuiverConfig
from pbccs_tpu_torch.models.quiver.recursor import (QuiverFeatureArrays,
                                                    _move_params)
from pbccs_tpu_torch.ops.fwdbwd import (BandedMatrix, band_offsets,
                                        circ_rows, in_band)
from pbccs_tpu_torch.ops.fwdbwd_cuda import _clip_cols, fill_scan_merge

_TINY = 1e-30


def _gather_rows(xp: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """y[r, j, L] = xp[r, rows[r, j, L]], 0 past the end of xp (the
    circular window of ops.fwdbwd_cuda.window_rows_circ, on a row map
    the caller computed once)."""
    R, N = xp.shape
    got = torch.gather(xp, 1, rows.clamp(max=N - 1).reshape(R, -1).long())
    return torch.where(rows < N, got.reshape(rows.shape),
                       torch.zeros((), dtype=xp.dtype, device=xp.device))


def _win(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """y[r, j, L] = x[r, row] over the band rows, x padded with one back
    row repeating its last value (0 past that)."""
    return _gather_rows(torch.cat([x, x[:, -1:]], 1), rows)


def _win_m1(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """y[r, j, L] = x[r, row - 1], row 0 reading x's first value."""
    return _gather_rows(torch.cat([x[:, :1], x], 1), rows)


def _emissions(pp, rows, seq_w, subs_w, ins_w, dtag_w, dqv_w, mqv_w,
               tb_inc, tb_extra, tb_mrg, tb_mrg2, I, in_tpl, mrg_ok):
    """exp-space Incorporate / Delete / Extra / Merge planes over (R, nc,
    W) windows whose feature tracks were gathered at each plane's row
    index (see the callers); tb_* are (R, nc, 1) per-column template
    bases, so the Merge score is indexed by each column's base."""
    inc = torch.where(seq_w == tb_inc, pp["match"],
                      pp["mismatch"] + pp["mismatch_s"] * subs_w)

    tagged = (rows < I) & (dtag_w == tb_inc.float())
    dele = torch.where(tagged,
                       pp["deletion_with_tag"]
                       + pp["deletion_with_tag_s"] * dqv_w,
                       pp["deletion_n"])

    extra_match = in_tpl & (seq_w == tb_extra)
    extra = torch.where(extra_match, pp["branch"] + pp["branch_s"] * ins_w,
                        pp["nce"] + pp["nce_s"] * ins_w)

    good = mrg_ok & (seq_w == tb_mrg) & (tb_mrg == tb_mrg2)
    tb = tb_mrg.clamp(0, 3).long()
    merge = pp["merge"].to(seq_w.device)
    merge_s = pp["merge_s"].to(seq_w.device)
    mrg_score = merge[tb] + merge_s[tb] * mqv_w
    mrg = torch.where(good, torch.exp(mrg_score), 0.0)
    return torch.exp(inc), torch.exp(dele), torch.exp(extra), mrg


def _forward_coeffs(feat: QuiverFeatureArrays, I, tpls, J, offsets, W: int,
                    pp, use_merge: bool):
    """Per-column band coefficients of the Quiver alpha recurrence for a
    read batch, mirroring the JAX package's recursor column for column.
    feat leaves (R, Imax); I, J (R,) int32; tpls (R, Jmax); offsets
    (R, nc).  Returns cm, cd, cc, cg (R, nc, W), mask (R, nc), seed
    (R, W), seedcol (R,)."""
    R, nc = offsets.shape
    dev = offsets.device
    jr = torch.arange(nc, device=dev)
    j = jr.to(torch.int32)[None, :, None]
    o = offsets[:, :, None]
    om1 = _clip_cols(offsets, jr - 1)[:, :, None]
    om2 = _clip_cols(offsets, jr - 2)[:, :, None]
    I3, J3 = I[:, None, None], J[:, None, None]

    rows = circ_rows(offsets, W)
    valid = (rows >= 0) & (rows <= I3)

    # feature windows at row index rows-1 (Inc/Extra/Merge read base) and
    # rows (Del tag/qv)
    seq_m1 = _win_m1(feat.seq.float(), rows)
    subs_m1 = _win_m1(feat.subs_qv, rows)
    ins_m1 = _win_m1(feat.ins_qv, rows)
    mqv_m1 = _win_m1(feat.merge_qv, rows)
    dtag_0 = _win(feat.del_tag, rows)
    dqv_0 = _win(feat.del_qv, rows)

    tb_prev = _clip_cols(tpls, jr - 1)[:, :, None]      # template base j-1
    tb_cur = _clip_cols(tpls, jr)[:, :, None]           # template base j
    tb_prev2 = _clip_cols(tpls, jr - 2)[:, :, None]     # template base j-2

    inc, dele, extra, mrg = _emissions(
        pp, rows, seq_m1, subs_m1, ins_m1, dtag_0, dqv_0, mqv_m1,
        tb_inc=tb_prev, tb_extra=tb_cur, tb_mrg=tb_prev2, tb_mrg2=tb_prev,
        I=I3, in_tpl=j < J3, mrg_ok=(j >= 2) & use_merge)

    live = (j >= 1) & (j <= J3)
    cm = torch.where(valid & (rows >= 1) & live & in_band(rows - 1, om1, W),
                     inc, 0.0)
    cd = torch.where(valid & live & in_band(rows, om1, W), dele, 0.0)
    cg = torch.where(valid & (rows >= 1) & live & in_band(rows - 1, om2, W),
                     mrg, 0.0)
    # column 0 chains Extra below the alpha(0,0) impulse; dead columns
    # j > J have no in-column move; rows > o cuts the circular scan at the
    # band's first row
    cc = torch.where(valid & (rows >= 1) & (j <= J3) & (rows > o), extra, 0.0)

    mask = (j[:, :, 0] <= J[:, None]).float()
    seed = torch.zeros(R, W, device=dev)
    seed[:, 0] = 1.0
    seedcol = torch.zeros(R, dtype=torch.int32, device=dev)
    return cm, cd, cc, cg, mask, seed, seedcol


def _backward_coeffs(feat: QuiverFeatureArrays, I, tpls, J, offsets, W: int,
                     pp, use_merge: bool):
    """Beta coefficients in the kernel frame (kernel column k holds beta
    column j = Jmax - k, lanes in the shared circular layout; the
    backward scan rolls the other way), mirroring the JAX package's
    recursor column for column; conventions of _forward_coeffs."""
    R, nc = offsets.shape
    Jmax = tpls.shape[1]
    dev = offsets.device
    k = torch.arange(nc, device=dev)
    j = (Jmax - k).to(torch.int32)[None, :, None]
    o_jv = _clip_cols(offsets, Jmax - k)
    o_j = o_jv[:, :, None]
    o_j1 = _clip_cols(offsets, Jmax + 1 - k)[:, :, None]
    o_j2 = _clip_cols(offsets, Jmax + 2 - k)[:, :, None]
    I3, J3 = I[:, None, None], J[:, None, None]

    rows = circ_rows(o_jv, W)
    valid = (rows >= 0) & (rows <= I3)

    # every backward lookup is at row index `rows`
    seq_0 = _win(feat.seq.float(), rows)
    subs_0 = _win(feat.subs_qv, rows)
    ins_0 = _win(feat.ins_qv, rows)
    mqv_0 = _win(feat.merge_qv, rows)
    dtag_0 = _win(feat.del_tag, rows)
    dqv_0 = _win(feat.del_qv, rows)

    tb = _clip_cols(tpls, Jmax - k)[:, :, None]            # base j
    tb_next = _clip_cols(tpls, Jmax + 1 - k)[:, :, None]   # base j+1

    inc, dele, extra, mrg = _emissions(
        pp, rows, seq_0, subs_0, ins_0, dtag_0, dqv_0, mqv_0,
        tb_inc=tb, tb_extra=tb, tb_mrg=tb, tb_mrg2=tb_next,
        I=I3, in_tpl=j < J3, mrg_ok=(j + 1 < J3) & use_merge)

    live = (j >= 0) & (j < J3)
    cm = torch.where(valid & (rows < I3) & live & in_band(rows + 1, o_j1, W),
                     inc, 0.0)
    cd = torch.where(valid & live & in_band(rows, o_j1, W), dele, 0.0)
    cg = torch.where(valid & (rows < I3) & live & in_band(rows + 1, o_j2, W),
                     mrg, 0.0)
    # rows < o + W - 1 cuts the reverse circular scan at the band top
    cc = torch.where(valid & (rows < I3) & (j >= 0) & (j <= J3)
                     & (rows < o_j + W - 1), extra, 0.0)

    jj = j[:, :, 0]
    mask = ((jj >= 0) & (jj <= J[:, None])).float()
    seed = (torch.arange(W, device=dev)[None, :]
            == (I % W)[:, None]).float()
    seedcol = (Jmax - J).to(torch.int32)
    return cm, cd, cc, cg, mask, seed, seedcol


def coefficients(feat: QuiverFeatureArrays, rlens, tpls, tlens,
                 config: QuiverConfig, width: int, backward: bool):
    """The K2 scan's operands for a read batch: (cm, cd, cc, cg, mask,
    seed, seedcol) contiguous, and the band offsets (R, Jmax + 1).
    feat leaves (R, Imax); rlens, tlens (R,); tpls (R, Jmax)."""
    nc = tpls.shape[1] + 1
    pp = _move_params(config.qv_params)
    use_merge = bool(config.moves_available & MERGE)
    I = rlens.to(torch.int32)
    J = tlens.to(torch.int32)
    offsets = band_offsets(I, J, nc, width)
    coeff_fn = _backward_coeffs if backward else _forward_coeffs
    ops = coeff_fn(feat, I, tpls.to(torch.int32), J, offsets, width, pp,
                   use_merge)
    return tuple(x.contiguous() for x in ops), offsets


def _fill(feat, rlens, tpls, tlens, config, width,
          backward: bool) -> BandedMatrix:
    ops, offsets = coefficients(feat, rlens, tpls, tlens, config, width,
                                backward)
    vals, ls = fill_scan_merge(*ops, backward)
    return BandedMatrix(vals, offsets, ls)


def forward_batch(feat: QuiverFeatureArrays, rlens, tpls, tlens,
                  config: QuiverConfig, width: int) -> BandedMatrix:
    """Batched banded Quiver alpha fills: feat leaves (R, Imax), tpls
    (R, Jmax), rlens/tlens (R,).  Returns leaves (R, Jmax+1, W) /
    (R, Jmax+1).  Counterpart of pallas_quiver_forward_batch."""
    return _fill(feat, rlens, tpls, tlens, config, width, backward=False)


def backward_batch(feat: QuiverFeatureArrays, rlens, tpls, tlens,
                   config: QuiverConfig, width: int) -> BandedMatrix:
    """Batched banded Quiver beta fills in natural column order
    (counterpart of pallas_quiver_backward_batch)."""
    return _fill(feat, rlens, tpls, tlens, config, width, backward=True)


def quiver_loglik_batch(alpha: BandedMatrix, rlens, tlens) -> torch.Tensor:
    """LL[r] = log alpha(I, J) + the column log-scales, as masked
    reductions (the Quiver final column is a full band, so the pick is
    a lane-and-column mask)."""
    I = rlens.to(torch.int32)[:, None]
    J = tlens.to(torch.int32)[:, None]
    W = alpha.vals.shape[2]
    jcols = torch.arange(alpha.vals.shape[1], device=I.device)[None, :]
    at_J = (jcols == J)[:, :, None]
    rows = circ_rows(alpha.offsets, W)
    final = torch.where(at_J & (rows == I[:, :, None]), alpha.vals,
                        0.0).sum((1, 2))
    ls = torch.where(jcols <= J, alpha.log_scales, 0.0).sum(1)
    return torch.log(torch.clamp(final, min=_TINY)) + ls


def quiver_loglik_backward_batch(beta: BandedMatrix, tlens) -> torch.Tensor:
    """LL[r] = log beta(0, 0) + the column log-scales."""
    J = tlens.to(torch.int32)[:, None]
    jcols = torch.arange(beta.vals.shape[1], device=J.device)[None, :]
    ls = torch.where(jcols <= J, beta.log_scales, 0.0).sum(1)
    return torch.log(torch.clamp(beta.vals[:, 0, 0], min=_TINY)) + ls
