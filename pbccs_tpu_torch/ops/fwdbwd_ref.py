"""Dense (unbanded) NumPy reference for the Arrow pair-HMM forward/backward.

This is the framework's ground-truth oracle: a direct, readable float64
implementation of the scaled natural-space recursion that the banded fills
(K1 and its plain version, ops.fwdbwd_cuda) are held against -- the same role the scalar
SimpleRecursor plays for the SSE kernels in the reference test suite
(reference ConsensusCore/src/Tests/TestRecursors.cpp:63-69).

Semantics parity: ConsensusCore Arrow SimpleRecursor FillAlpha/FillBeta
(reference ConsensusCore/src/C++/Arrow/SimpleRecursor.cpp:62-296) with
ScaledMatrix per-column max-rescaling (Matrix/ScaledMatrix-inl.hpp:74-123).

Matrix convention: alpha[(I+1) rows = read prefix, (J+1) cols = template
prefix]; both endpoints pinned to Match.  States folded into one value per
cell (sum-product combiner).  Transition params trans[k] govern moves leaving
template position k (0-indexed); emission compares read base to template base.

A copy of pbccs_tpu.ops.fwdbwd_ref (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import numpy as np

from pbccs_tpu_torch.models.arrow.params import (
    TRANS_BRANCH,
    TRANS_DARK,
    TRANS_MATCH,
    TRANS_STICK,
    ModelParams,
)


def _emission(read_base: int, tpl_base: int, p: ModelParams) -> float:
    return p.pr_not_miscall if read_base == tpl_base else p.pr_third_of_miscall


def fill_alpha_dense(read: np.ndarray, tpl: np.ndarray, trans: np.ndarray,
                     params: ModelParams | None = None):
    """Forward matrix, column-rescaled.

    read: (I,) int8; tpl: (J,) int8; trans: (J, 4) float64.
    Returns (alpha, log_scales): alpha (I+1, J+1) rescaled per column,
    log_scales (J+1,) with log of each column's scale factor.
    Log-likelihood = log(alpha[I, J]) + log_scales.sum().
    """
    p = params or ModelParams()
    I, J = len(read), len(tpl)
    alpha = np.zeros((I + 1, J + 1), dtype=np.float64)
    log_scales = np.zeros(J + 1, dtype=np.float64)
    alpha[0, 0] = 1.0

    for j in range(1, J):
        t_cur = tpl[j - 1]          # template base of this column
        tr_prev = trans[j - 2] if j >= 2 else None  # moves leaving position j-2
        tr_cur = trans[j - 1]       # moves leaving position j-1 (inserts here)
        t_next = tpl[j]             # next template base (branch test)
        for i in range(1, I):
            r = read[i - 1]
            score = 0.0
            # Match (diagonal) -- pinned start has no transition factor.
            m = alpha[i - 1, j - 1] * _emission(r, t_cur, p)
            if i == 1 and j == 1:
                score += m
            elif i != 1 and j != 1:
                score += m * tr_prev[TRANS_MATCH]
            # Stick/Branch (vertical, same column): not for first read base.
            if i > 1:
                ins = tr_cur[TRANS_BRANCH] if r == t_next else tr_cur[TRANS_STICK] / 3.0
                score += alpha[i - 1, j] * ins
            # Deletion (horizontal): not out of the pinned first column.
            if j > 1:
                score += alpha[i, j - 1] * tr_prev[TRANS_DARK]
            alpha[i, j] = score
        # ScaledMatrix: divide the column by its max, accumulate log scale.
        cmax = alpha[1:I, j].max() if I > 1 else 1.0
        if cmax > 0:
            alpha[:, j] /= cmax
            log_scales[j] = np.log(cmax)

    # Final pinned cell: must end in a match.
    if J >= 1 and I >= 1:
        alpha[I, J] = alpha[I - 1, J - 1] * _emission(read[I - 1], tpl[J - 1], p)
    return alpha, log_scales


def fill_beta_dense(read: np.ndarray, tpl: np.ndarray, trans: np.ndarray,
                    params: ModelParams | None = None):
    """Backward matrix, column-rescaled.  Mirrors fill_alpha_dense.

    Log-likelihood = log(beta[0, 0]) + log_scales.sum().
    """
    p = params or ModelParams()
    I, J = len(read), len(tpl)
    beta = np.zeros((I + 1, J + 1), dtype=np.float64)
    log_scales = np.zeros(J + 1, dtype=np.float64)
    beta[I, J] = 1.0

    for j in range(J - 1, 0, -1):
        t_next = tpl[j]             # base of column j+1
        tr_cur = trans[j - 1]       # moves leaving position j-1
        for i in range(I - 1, 0, -1):
            r_next = read[i]
            score = 0.0
            nxt_match = r_next == t_next
            em = _emission(r_next, t_next, p)
            # Match into (i+1, j+1).
            if i < I - 1:
                score += beta[i + 1, j + 1] * em * tr_cur[TRANS_MATCH]
            elif i == I - 1 and j == J - 1:
                score += beta[i + 1, j + 1] * em
            # Stick/Branch into (i+1, j).
            if 0 < i < I - 1:
                ins = tr_cur[TRANS_BRANCH] if nxt_match else tr_cur[TRANS_STICK] / 3.0
                score += beta[i + 1, j] * ins
            # Deletion into (i, j+1).
            if 0 < j < J - 1:
                score += beta[i, j + 1] * tr_cur[TRANS_DARK]
            beta[i, j] = score
        cmax = beta[1:I, j].max() if I > 1 else 1.0
        if cmax > 0:
            beta[:, j] /= cmax
            log_scales[j] = np.log(cmax)

    beta[0, 0] = beta[1, 1] * _emission(read[0], tpl[0], p)
    return beta, log_scales


def loglik_dense(read: np.ndarray, tpl: np.ndarray, trans: np.ndarray,
                 params: ModelParams | None = None) -> float:
    """Full-model log-likelihood via the forward recursion."""
    alpha, ls = fill_alpha_dense(read, tpl, trans, params)
    with np.errstate(divide="ignore"):
        return float(np.log(alpha[-1, -1]) + ls.sum())


def loglik_dense_bwd(read: np.ndarray, tpl: np.ndarray, trans: np.ndarray,
                     params: ModelParams | None = None) -> float:
    alpha, ls = fill_beta_dense(read, tpl, trans, params)
    with np.errstate(divide="ignore"):
        return float(np.log(alpha[0, 0]) + ls.sum())
