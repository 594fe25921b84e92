"""Padded feature tensors and move parameters of the Quiver fills, and
the host dynamic programs of the Quiver model.

Port of the parts of pbccs_tpu.models.quiver.recursor that the port
needs: QuiverFeatureArrays, feature_arrays and _move_params for the
fills (models.quiver.fill), and the dense host DPs viterbi_alignment and
dense_loglik (numpy, off the hot path, copied as they are).  The JAX
package's XLA recursor (quiver_forward / quiver_backward) is its CPU
path; the port's CPU path is K2's plain version
(ops.quiver_fill_cuda.quiver_fill_plain), so the banded recursor itself
is not ported."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pbccs_tpu_torch.models.quiver.params import QvModelParams


class QuiverFeatureArrays(NamedTuple):
    """Padded feature tracks of one read (Imax,) or a batch (R, Imax)."""

    seq: torch.Tensor       # int32 base codes, 4 past the read
    ins_qv: torch.Tensor    # f32
    subs_qv: torch.Tensor
    del_qv: torch.Tensor
    del_tag: torch.Tensor   # f32 base codes, 4 past the read
    merge_qv: torch.Tensor


def feature_arrays(feat, imax: int, device="cpu") -> QuiverFeatureArrays:
    """Pad one read's host features to (imax,) tensors: QVs pad with 0,
    the sequence and the del-tag with 4."""
    n = len(feat.seq)

    def pad(a, fill):
        out = np.full(imax, fill, np.float32)
        out[:min(n, imax)] = np.asarray(a, np.float32)[:imax]
        return torch.as_tensor(out, device=device)

    seq = np.full(imax, 4, np.int32)
    seq[:min(n, imax)] = np.asarray(feat.seq[:imax], np.int32)
    return QuiverFeatureArrays(
        torch.as_tensor(seq, device=device), pad(feat.ins_qv, 0),
        pad(feat.subs_qv, 0), pad(feat.del_qv, 0), pad(feat.del_tag, 4),
        pad(feat.merge_qv, 0))


def stack_features(feats) -> QuiverFeatureArrays:
    """(R, Imax) batch of per-read QuiverFeatureArrays."""
    return QuiverFeatureArrays(*(torch.stack([getattr(f, n) for f in feats])
                                 for n in QuiverFeatureArrays._fields))


def _move_params(params: QvModelParams) -> dict:
    """The move-score parameters as Python floats (scalar terms) and
    (4,) float32 tensors (the per-base Merge scores)."""
    return dict(
        match=params.match, mismatch=params.mismatch,
        mismatch_s=params.mismatch_s, branch=params.branch,
        branch_s=params.branch_s, deletion_n=params.deletion_n,
        deletion_with_tag=params.deletion_with_tag,
        deletion_with_tag_s=params.deletion_with_tag_s,
        nce=params.nce, nce_s=params.nce_s,
        merge=torch.tensor(params.merge, dtype=torch.float32),
        merge_s=torch.tensor(params.merge_s, dtype=torch.float32))


def viterbi_alignment(feat, tpl_codes, params: QvModelParams,
                      use_merge: bool = True, pin_start: bool = True,
                      pin_end: bool = True):
    """Read-vs-template viterbi alignment: max-combiner DP + traceback to
    a gapped PairwiseAlignment (reference RecursorBase::Alignment,
    RecursorBase.hpp:53-116 + RecursorBase.cpp:126-264, including the
    Merge move's two-template-column step).

    Like the reference's, this is a diagnostic/API routine off the hot
    path (the production scorers never traceback), so it runs as a dense
    host DP; moves tie-break in the reference's probe order
    (Incorporate > Delete > Extra > Merge on strict >)."""
    from pbccs_tpu_torch.align.pairwise import PairwiseAlignment
    from pbccs_tpu_torch.models.arrow.params import decode_bases

    seq = np.asarray(feat.seq, np.int64)
    tpl = np.asarray(tpl_codes, np.int64)
    I, J = len(seq), len(tpl)
    NEG = -np.inf

    def inc(i, j):
        if seq[i] == tpl[j]:
            return params.match
        return params.mismatch + params.mismatch_s * feat.subs_qv[i]

    def dele(i, j):
        if (not pin_start and i == 0) or (not pin_end and i == I):
            return 0.0
        if i < I and feat.del_tag[i] == tpl[j]:
            return params.deletion_with_tag + \
                params.deletion_with_tag_s * feat.del_qv[i]
        return params.deletion_n

    def extra(i, j):
        if j < J and seq[i] == tpl[j]:
            return params.branch + params.branch_s * feat.ins_qv[i]
        return params.nce + params.nce_s * feat.ins_qv[i]

    def merge(i, j):
        if seq[i] == tpl[j] and tpl[j] == tpl[j + 1]:
            tb = int(tpl[j])
            return params.merge[tb] + params.merge_s[tb] * feat.merge_qv[i]
        return NEG

    # viterbi fill: dense_loglik's recurrence with max in place of
    # logsumexp (the reference's ViterbiCombiner)
    a = np.full((I + 1, J + 1), NEG)
    a[0, 0] = 0.0
    for j in range(J + 1):
        for i in range(I + 1):
            if i == 0 and j == 0:
                continue
            best = NEG
            if i > 0 and j > 0:
                best = max(best, a[i - 1, j - 1] + inc(i - 1, j - 1))
            if i > 0:
                best = max(best, a[i - 1, j] + extra(i - 1, j))
            if j > 0:
                best = max(best, a[i, j - 1] + dele(i, j - 1))
            if use_merge and j > 1 and i > 0:
                best = max(best, a[i - 1, j - 2] + merge(i - 1, j - 2))
            a[i, j] = best

    # traceback (RecursorBase.cpp:150-218): recompute each move's total
    # and take the best, probing in the reference's order
    i, j = I, J
    moves: list[tuple[int, int]] = []          # (read_delta, ref_delta)
    while i > 0 or j > 0:
        best_move, best = None, NEG
        if i > 0 and j > 0:
            t = a[i - 1, j - 1] + inc(i - 1, j - 1)
            if t > best:
                best_move, best = (1, 1), t
        if j > 0:
            free = (not pin_end and i == I) or (not pin_start and i == 0)
            t = a[i, j - 1] + (0.0 if free else dele(i, j - 1))
            if t > best:
                best_move, best = (0, 1), t
        if i > 0:
            t = a[i - 1, j] + extra(i - 1, j)
            if t > best:
                best_move, best = (1, 0), t
        if use_merge and i > 0 and j > 1:
            t = a[i - 1, j - 2] + merge(i - 1, j - 2)
            if t > best:
                best_move, best = (1, 2), t
        assert best_move is not None
        moves.append(best_move)
        i -= best_move[0]
        j -= best_move[1]
    moves.reverse()

    tstr = decode_bases(tpl.astype(np.int8))
    qstr = decode_bases(seq[:I].astype(np.int8))
    target, query = [], []
    i = j = 0
    for rd, td in moves:
        if rd == 1 and td == 1:          # incorporate
            target.append(tstr[j])
            query.append(qstr[i])
        elif rd == 1 and td == 0:        # extra
            target.append("-")
            query.append(qstr[i])
        elif rd == 0 and td == 1:        # delete
            target.append(tstr[j])
            query.append("-")
        else:                            # merge: two tpl columns, one base
            target.append(tstr[j])
            target.append(tstr[j + 1])
            query.append("-")
            query.append(qstr[i])
        i += rd
        j += td
    return PairwiseAlignment("".join(target), "".join(query))


def dense_loglik(feat, tpl_codes, params: QvModelParams, use_merge: bool = True,
                 pin_start: bool = True, pin_end: bool = True) -> float:
    """Dense log-space oracle (numpy) for validating the banded fills; the
    direct transliteration of the recurrence, kept simple and slow."""
    seq = np.asarray(feat.seq, np.int64)
    tpl = np.asarray(tpl_codes, np.int64)
    I, J = len(seq), len(tpl)
    NEG = -np.inf
    a = np.full((I + 1, J + 1), NEG)
    a[0, 0] = 0.0

    def inc(i, j):
        if seq[i] == tpl[j]:
            return params.match
        return params.mismatch + params.mismatch_s * feat.subs_qv[i]

    def dele(i, j):
        if (not pin_start and i == 0) or (not pin_end and i == I):
            return 0.0
        if i < I and feat.del_tag[i] == tpl[j]:
            return params.deletion_with_tag + params.deletion_with_tag_s * feat.del_qv[i]
        return params.deletion_n

    def extra(i, j):
        if j < J and seq[i] == tpl[j]:
            return params.branch + params.branch_s * feat.ins_qv[i]
        return params.nce + params.nce_s * feat.ins_qv[i]

    def merge(i, j):
        if seq[i] == tpl[j] and tpl[j] == tpl[j + 1]:
            tb = int(tpl[j])
            return params.merge[tb] + params.merge_s[tb] * feat.merge_qv[i]
        return NEG

    for j in range(J + 1):
        for i in range(I + 1):
            terms = []
            if i == 0 and j == 0:
                continue
            if i > 0 and j > 0:
                terms.append(a[i - 1, j - 1] + inc(i - 1, j - 1))
            if i > 0:
                terms.append(a[i - 1, j] + extra(i - 1, j))
            if j > 0:
                terms.append(a[i, j - 1] + dele(i, j - 1))
            if use_merge and j > 1 and i > 0:
                terms.append(a[i - 1, j - 2] + merge(i - 1, j - 2))
            if terms:
                a[i, j] = np.logaddexp.reduce(terms)
    return float(a[I, J])
