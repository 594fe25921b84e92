"""Pieces of the Extend+Link mutation-scoring algebra the edge programs use.

Port of the parts of pbccs_tpu.ops.mutation_score that the window-frame
edge programs (ops.dense_score_cuda) call: the alpha scale prefix / beta
scale suffix and the generic one-column ExtendAlpha step `_ext_col`
(reference ConsensusCore SimpleRecursor.cpp:373-487).  All functions take
leading batch axes."""

from __future__ import annotations

import torch

from pbccs_tpu_torch.models.arrow.params import (
    TRANS_BRANCH,
    TRANS_DARK,
    TRANS_MATCH,
    TRANS_STICK,
)
from pbccs_tpu_torch.ops.fwdbwd import (_affine_scan_circ, circ_roll,
                                        circ_rows, ftz)


def scale_prefix(log_scales: torch.Tensor) -> torch.Tensor:
    """alpha_prefix[..., k] = sum(log_scales[..., :k]); shape (..., n+1)."""
    z = torch.zeros(log_scales.shape[:-1] + (1,), dtype=log_scales.dtype,
                    device=log_scales.device)
    return torch.cat([z, torch.cumsum(log_scales, dim=-1)], dim=-1)


def scale_suffix(log_scales: torch.Tensor) -> torch.Tensor:
    """beta_suffix[..., k] = sum(log_scales[..., k:]); shape (..., n+1)."""
    z = torch.zeros(log_scales.shape[:-1] + (1,), dtype=log_scales.dtype,
                    device=log_scales.device)
    suf = torch.flip(torch.cumsum(torch.flip(log_scales, [-1]), dim=-1), [-1])
    return torch.cat([suf, z], dim=-1)


def _circ_rows_batch(o: torch.Tensor, W: int) -> torch.Tensor:
    """(..., W) absolute rows of each circular lane for offsets o (...)."""
    return circ_rows(o, W)


def _in_band(rows: torch.Tensor, o: torch.Tensor, W: int) -> torch.Tensor:
    """(..., W) mask: row inside the band [o, o+W) of a column with offset
    o (...)."""
    o = o[..., None]
    return (rows >= o) & (rows < o + W)


def _ext_col(prev_vals, o_prev, o_col, rbase_row, jcol, cur_b, next_b,
             prev_tr, cur_tr, *, I, max_left, hit, em_miss, W):
    """One batched virtual-template DP column (the ExtendAlpha column fill):
    solves the within-column insertion recurrence over the band for every
    row of the batch at virtual DP column `jcol`, in flush-to-zero
    arithmetic (fwdbwd.ftz).

    prev_vals (..., W) previous virtual column, circular lanes; o_prev /
    o_col (...) band offsets of the previous / this column; rbase_row
    (..., W) read bases under each lane; jcol, cur_b, next_b, max_left
    (...); prev_tr / cur_tr (..., 4); I (...) read lengths.  Handles the
    j == 1 start column (reachable only by the pinned initial match,
    SimpleRecursor.cpp:119-141) and the pinned (I, J) corner."""
    rows = _circ_rows_batch(o_col, W)
    I = I[..., None]
    jcol = jcol[..., None]
    max_left = max_left[..., None]
    in_read = (rows >= 1) & (rows <= I)
    em = torch.where(rbase_row == cur_b[..., None], hit, em_miss)
    pm1 = torch.where(_in_band(rows - 1, o_prev, W),
                      circ_roll(prev_vals, 1), 0.0)
    p0 = torch.where(_in_band(rows, o_prev, W), prev_vals, 0.0)

    generic = (rows < I) & (jcol < max_left)
    pinned = (rows == I) & (jcol == max_left)
    mfac = torch.where(generic, prev_tr[..., TRANS_MATCH:TRANS_MATCH + 1],
                       torch.where(pinned, 1.0, 0.0))
    mfac = torch.where(jcol == 1, torch.where(rows == 1, 1.0, 0.0), mfac)
    b = ftz(ftz(pm1 * em) * mfac)
    b = ftz(b + torch.where((jcol > 1) & (jcol < max_left) & (rows != I),
                            ftz(p0 * prev_tr[..., TRANS_DARK:TRANS_DARK + 1]),
                            0.0))
    b = torch.where(in_read, b, 0.0)

    ins_em = torch.where(rbase_row == next_b[..., None],
                         cur_tr[..., TRANS_BRANCH:TRANS_BRANCH + 1],
                         cur_tr[..., TRANS_STICK:TRANS_STICK + 1] / 3.0)
    c = torch.where(in_read & (rows > 1) & (rows < I) & (jcol != max_left)
                    & (rows > o_col[..., None]), ins_em, 0.0)
    return _affine_scan_circ(b, c)
