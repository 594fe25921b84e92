"""O(N)-memory global alignment (Hirschberg divide and conquer).

Behavior parity: reference ConsensusCore Align/LinearAlignment.{hpp,cpp}
(AlignLinear: global alignment in linear memory).  The divide-and-conquer
keeps only two score rows at a time; base cases fall back to the quadratic
aligner over tiny strips, so outputs are optimal global alignments under
the same AlignConfig scoring.

A copy of pbccs_tpu.align.linear (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import numpy as np

from pbccs_tpu_torch.align.pairwise import (
    GLOBAL,
    AlignConfig,
    PairwiseAlignment,
    align,
)


def _last_row(query: str, target: str, p) -> np.ndarray:
    """Final NW row (scores of query vs every target prefix), O(J) memory."""
    J = len(target)
    t = np.frombuffer(target.encode(), np.uint8)
    dj = np.arange(J + 1, dtype=np.int64) * p.delete
    row = dj.copy()
    for i, qc in enumerate(query.encode(), start=1):
        sub = np.where(t == qc, p.match, p.mismatch).astype(np.int64)
        v = np.empty(J + 1, np.int64)
        v[0] = i * p.insert
        v[1:] = np.maximum(row[:-1] + sub, row[1:] + p.insert)
        row = np.maximum.accumulate(v - dj) + dj
    return row


def _hirschberg(target: str, query: str, cfg: AlignConfig) -> tuple[str, str]:
    I, J = len(query), len(target)
    if I <= 1 or J <= 1:
        a = align(target, query, cfg)
        return a.target, a.query
    mid = I // 2
    upper = _last_row(query[:mid], target, cfg.params)
    lower = _last_row(query[mid:][::-1], target[::-1], cfg.params)[::-1]
    split = int(np.argmax(upper + lower))
    lt, lq = _hirschberg(target[:split], query[:mid], cfg)
    rt, rq = _hirschberg(target[split:], query[mid:], cfg)
    return lt + rt, lq + rq


def align_linear(target: str, query: str, config: AlignConfig | None = None
                 ) -> PairwiseAlignment:
    """Optimal global alignment in O(min-side) memory
    (reference AlignLinear, LinearAlignment.cpp)."""
    cfg = config or AlignConfig()
    if cfg.mode != GLOBAL:
        raise ValueError("align_linear is global-only "
                         "(reference AlignLinear, LinearAlignment.cpp:93)")
    gt, gq = _hirschberg(target, query, cfg)
    return PairwiseAlignment(gt, gq)


def align_linear_score(target: str, query: str,
                       config: AlignConfig | None = None) -> int:
    """Global alignment score in O(J) memory."""
    cfg = config or AlignConfig()
    return int(_last_row(query, target, cfg.params)[-1])
