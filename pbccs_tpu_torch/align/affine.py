"""Affine gap-penalty alignment (two-state model), vectorized row sweeps.

Behavior parity: reference ConsensusCore Align/AffineAlignment.{hpp,cpp} —
the Durbin et al. two-state formulation with a single GAP state shared by
both gap directions, defaults (0, -1, -1, -0.5) and the IUPAC-aware
variant that half-penalizes partial ambiguity matches
(AffineAlignment.cpp:66-78, 228-236).

Row sweep: M[i,*] depends only on the previous row; the GAP row's in-row
recurrence ``G[i,j] = max(W[j], G[i,j-1] + extend)`` is a prefix max of
``W[j] - j*extend``, so each row is a handful of numpy ops.

A copy of pbccs_tpu.align.affine (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pbccs_tpu_torch.align.pairwise import PairwiseAlignment

_NEG = np.float32(-1e30)

_IUPAC = {
    "R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT", "M": "AC",
}


@dataclasses.dataclass(frozen=True)
class AffineAlignmentParams:
    """Reference AffineAlignment.hpp:51-66."""

    match: float = 0.0
    mismatch: float = -1.0
    gap_open: float = -1.0
    gap_extend: float = -0.5
    partial_match: float = 0.0

    @classmethod
    def default(cls) -> "AffineAlignmentParams":
        return cls(0.0, -1.0, -1.0, -0.5, 0.0)

    @classmethod
    def iupac_aware(cls) -> "AffineAlignmentParams":
        return cls(0.0, -1.0, -1.0, -0.5, -0.25)


def _substitution_row(t: str, qc: str, p: AffineAlignmentParams,
                      iupac: bool) -> np.ndarray:
    tb = np.frombuffer(t.encode(), np.uint8)
    sub = np.where(tb == ord(qc), p.match, p.mismatch).astype(np.float64)
    if iupac:
        for code, pair in _IUPAC.items():
            if qc == code:
                hit = np.isin(tb, np.frombuffer(pair.encode(), np.uint8))
                sub = np.where(hit & (tb != ord(qc)), p.partial_match, sub)
            hit = (tb == ord(code)) & (qc in pair) & (qc != code)
            sub = np.where(hit, p.partial_match, sub)
    return sub


def _align_affine(target: str, query: str, p: AffineAlignmentParams,
                  iupac: bool) -> PairwiseAlignment:
    I, J = len(query), len(target)
    M = np.full((I + 1, J + 1), _NEG, np.float64)
    G = np.full((I + 1, J + 1), _NEG, np.float64)
    M[0, 0] = 0.0
    ramp = p.gap_open + np.arange(J, dtype=np.float64) * p.gap_extend
    G[0, 1:] = ramp
    G[1:, 0] = p.gap_open + np.arange(I, dtype=np.float64) * p.gap_extend
    ej = np.arange(J + 1, dtype=np.float64) * p.gap_extend
    for i in range(1, I + 1):
        sub = _substitution_row(target, query[i - 1], p, iupac)
        M[i, 1:] = np.maximum(M[i - 1, :-1], G[i - 1, :-1]) + sub
        w = np.empty(J + 1, np.float64)
        w[0] = G[i, 0]
        w[1:] = np.maximum(np.maximum(M[i, :-1] + p.gap_open,
                                      M[i - 1, 1:] + p.gap_open),
                           G[i - 1, 1:] + p.gap_extend)
        G[i] = np.maximum.accumulate(w - ej) + ej

    # traceback (reference AffineAlignment.cpp:156-209: M-state ties win)
    gt, gq = [], []
    i, j = I, J
    in_match = M[I, J] >= G[I, J]
    while i > 0 or j > 0:
        if in_match:
            in_match = M[i - 1, j - 1] >= G[i - 1, j - 1]
            i -= 1; j -= 1
            gt.append(target[j]); gq.append(query[i])
        else:
            cand = [
                M[i, j - 1] + p.gap_open if j > 0 else _NEG,
                G[i, j - 1] + p.gap_extend if j > 0 else _NEG,
                M[i - 1, j] + p.gap_open if i > 0 else _NEG,
                G[i - 1, j] + p.gap_extend if i > 0 else _NEG,
            ]
            k = int(np.argmax(cand))
            in_match = k in (0, 2)
            if k in (0, 1):
                j -= 1
                gt.append(target[j]); gq.append("-")
            else:
                i -= 1
                gt.append("-"); gq.append(query[i])
    gt.reverse(); gq.reverse()
    return PairwiseAlignment("".join(gt), "".join(gq))


def align_affine(target: str, query: str,
                 params: AffineAlignmentParams | None = None
                 ) -> PairwiseAlignment:
    """Affine gap-penalty global alignment (reference AlignAffine)."""
    return _align_affine(target, query,
                         params or AffineAlignmentParams.default(), False)


def align_affine_iupac(target: str, query: str,
                       params: AffineAlignmentParams | None = None
                       ) -> PairwiseAlignment:
    """Affine alignment half-penalizing IUPAC partial matches
    (reference AlignAffineIupac)."""
    return _align_affine(target, query,
                         params or AffineAlignmentParams.iupac_aware(), True)
