"""Pieces of the Extend+Link mutation-scoring algebra the edge programs use.

Port of the parts of pbccs_tpu.ops.mutation_score that the window-frame
edge programs (ops.dense_score_cuda) call: the alpha scale prefix / beta
scale suffix and the generic one-column ExtendAlpha step `_ext_col`
(reference ConsensusCore SimpleRecursor.cpp:373-487); and the dense
mutated windows of (read, mutation) pairs that are scored by a full
refill, from patches built in the window frame (`make_window_patches`,
the device loop's refills) or in the template frame (`make_patches`,
the serial scorer's edge pairs), through `mutated_windows_per_pair`.
All functions take leading batch axes."""

from __future__ import annotations

from typing import NamedTuple

import torch

from pbccs_tpu_torch.models.arrow.params import (
    TRANS_BRANCH,
    TRANS_DARK,
    TRANS_MATCH,
    TRANS_STICK,
    transition_lookup,
)
from pbccs_tpu_torch.ops.fwdbwd import (_affine_scan_circ, circ_roll,
                                        circ_rows, ftz)
from pbccs_tpu_torch.ops.fwdbwd_cuda import _third


def scale_prefix(log_scales: torch.Tensor) -> torch.Tensor:
    """alpha_prefix[..., k] = sum(log_scales[..., :k]); shape (..., n+1).

    Accumulated in float64 and rounded once: a float32 scan associates
    by the tensor's length, so a read's sums would follow the batch's
    padded column count (Jmax) and a ZMW's consensus the other ZMWs of
    its batch (a mate whose template outgrows the bucket re-buckets all
    of them)."""
    ls = log_scales.double()
    z = torch.zeros(ls.shape[:-1] + (1,), dtype=ls.dtype, device=ls.device)
    return torch.cat([z, torch.cumsum(ls, dim=-1)],
                     dim=-1).to(log_scales.dtype)


def scale_suffix(log_scales: torch.Tensor) -> torch.Tensor:
    """beta_suffix[..., k] = sum(log_scales[..., k:]); shape (..., n+1).
    In float64, rounded once, as scale_prefix."""
    ls = log_scales.double()
    z = torch.zeros(ls.shape[:-1] + (1,), dtype=ls.dtype, device=ls.device)
    suf = torch.flip(torch.cumsum(torch.flip(ls, [-1]), dim=-1), [-1])
    return torch.cat([suf, z], dim=-1).to(log_scales.dtype)


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
                         _third(cur_tr[..., TRANS_STICK:TRANS_STICK + 1]))
    c = torch.where(in_read & (rows > 1) & (rows < I) & (jcol != max_left)
                    & (rows > o_col[..., None]), ins_em, 0.0)
    return _affine_scan_circ(b, c)


# --------------------------------------------------------------------------
# dense mutated windows of (read, mutation) pairs
# --------------------------------------------------------------------------


class MutationPatch(NamedTuple):
    """Virtual-mutation patches of E pairs: the bases (E, 2) and
    transition rows (E, 2, 4) the mutation writes at window positions
    p-1 and p, and the shift (E,) of the positions past p (0 sub, -1
    ins, +1 del)."""

    bases: torch.Tensor
    trans: torch.Tensor
    shift: torch.Tensor


_SUB, _INS, _DEL = 0, 1, 2


def make_patches(tpl, trans, table, tpl_len: int, pos, mtype,
                 new_base) -> MutationPatch:
    """The virtual-mutation patches of M mutations on one oriented full
    template (port of make_patches_fast; reference ApplyVirtualMutation,
    TemplateParameterPair.cpp:70-140).  tpl (Lm,) int padded template,
    trans (Lm, 4) its transition track, table (8, 4), tpl_len its length
    L, pos / mtype / new_base (M,) oriented mutations.  Neighbour lookups
    clip to the padded template, as the reference's row-selects do."""
    Lm = tpl.shape[0]
    pos = pos.long()
    clip = lambda q: q.clamp(0, Lm - 1)  # noqa: E731
    t64 = tpl.long()
    p = clip(pos)
    prev_b, cur_b, next_b = t64[clip(p - 1)], t64[p], t64[clip(p + 1)]
    trans_p1 = trans.float()[clip(p + 1)]
    nb = new_base.long()

    def T(a, b):
        return transition_lookup(a, b, table)

    def gate(cond, v):
        return torch.where(cond[:, None], v, 0.0)

    L = int(tpl_len)
    ctx_prev_nb = T(prev_b, nb)
    sub_t = torch.stack([gate(pos > 0, ctx_prev_nb),
                         gate(pos + 1 < L, T(nb, next_b))], 1)
    del_t = torch.stack([gate((pos > 0) & (pos < L - 1), T(prev_b, next_b)),
                         gate(pos < L - 1, trans_p1)], 1)
    ins_t = torch.stack([gate(pos > 0, ctx_prev_nb),
                         gate(pos < L, T(nb, cur_b))], 1)
    is_sub = (mtype == _SUB)[:, None]
    is_ins = (mtype == _INS)[:, None]
    bases = torch.where(is_sub | is_ins, torch.stack([prev_b, nb], 1),
                        torch.stack([prev_b, next_b], 1))
    transp = torch.where(is_sub[..., None], sub_t,
                         torch.where(is_ins[..., None], ins_t, del_t))
    shift = torch.where(mtype == _SUB, 0, torch.where(mtype == _INS, -1, 1))
    return MutationPatch(bases.to(torch.int32), transp,
                         shift.to(torch.int32))


def make_window_patches(wt_e, pt_e, p, mtype, new_base) -> MutationPatch:
    """The patches of E window-frame mutations (make_patches_fast's
    values, with the window as the template).  wt_e (E, Jm) window
    bases; pt_e (E, 2, 4) the slot's patch transition rows
    (dense_score_cuda.dense_patch_grids); p, mtype, new_base (E,).
    Positions p-1 / p+1 clamp at the window's ends, where the refill
    masks them (a patch row past the mutated window's end is zeroed by
    mutated_windows_per_pair)."""
    Jm = wt_e.shape[1]
    at = lambda q: wt_e.gather(1, q.clamp(0, Jm - 1)[:, None].long())[:, 0]  # noqa: E731
    prev_b, next_b = at(p - 1), at(p + 1)
    nb = new_base.to(wt_e.dtype)
    second = torch.where(mtype == _DEL, next_b, nb)
    shift = torch.where(mtype == _SUB, 0, torch.where(mtype == _INS, -1, 1))
    return MutationPatch(torch.stack([prev_b, second], 1), pt_e,
                         shift.to(torch.int32))


def mutated_windows_per_pair(wt_e, wtr_e, wlens_e, p, mtype,
                             patch: MutationPatch):
    """Dense mutated windows for E pairs, each with its own window.

    wt_e (E, Jm) int; wtr_e (E, Jm, 4); wlens_e, p, mtype (E,).
    Returns (bases (E, Jm) int8, trans (E, Jm, 4), new_len (E,)): the
    window with positions past p shifted by the patch, positions p-1 and
    p patched, base 4 past the new length and zero transitions from its
    last position on.  Port of ops.mutation_score.mutated_windows_per_pair."""
    E, Jm = wt_e.shape
    dev = wt_e.device
    idx = torch.arange(Jm, device=dev)[None, :]
    p2 = p[:, None]

    def sh_cols(x, t):
        """x[:, clip(col + t, 0, Jm-1)] along the window axis."""
        return x[:, (torch.arange(Jm, device=dev) + t).clamp(0, Jm - 1)]

    sh = patch.shift[:, None]
    tpl = wt_e.to(torch.int32)
    shifted_b = torch.where(sh == -1, sh_cols(tpl, -1),
                            torch.where(sh == 1, sh_cols(tpl, 1), tpl))
    sh3 = sh[..., None]
    shifted_t = torch.where(sh3 == -1, sh_cols(wtr_e, -1),
                            torch.where(sh3 == 1, sh_cols(wtr_e, 1), wtr_e))
    bases = torch.where(idx <= p2, tpl, shifted_b)
    trans = torch.where((idx <= p2)[..., None], wtr_e, shifted_t)
    pb = patch.bases.to(torch.int32)
    bases = torch.where(idx == p2 - 1, pb[:, 0:1], bases)
    bases = torch.where(idx == p2, pb[:, 1:2], bases)
    trans = torch.where((idx == p2 - 1)[..., None], patch.trans[:, None, 0],
                        trans)
    trans = torch.where((idx == p2)[..., None], patch.trans[:, None, 1],
                        trans)

    ld = torch.where(mtype == _INS, 1, torch.where(mtype == _DEL, -1, 0))
    new_len = wlens_e.to(torch.int32) + ld.to(torch.int32)
    valid = idx < new_len[:, None]
    bases = torch.where(valid, bases, 4).to(torch.int8)
    trans = torch.where((idx < new_len[:, None] - 1)[..., None], trans, 0.0)
    return bases, trans, new_len
