"""Read-coverage helpers (reference ConsensusCore/include/ConsensusCore/
Coverage.hpp:51-64, src/C++/Coverage.cpp): per-position coverage inside a
window and minimum-coverage intervals, from read (tStart, tEnd) spans.

A copy of pbccs_tpu.utils.coverage (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import numpy as np

from pbccs_tpu_torch.utils.intervals import Interval


def coverage_in_window(tstarts, tends, win_start: int, win_len: int) -> np.ndarray:
    """Per-position read depth over [win_start, win_start+win_len)
    (difference-array sweep; reference Coverage.cpp CoverageInWindow)."""
    tstarts = np.asarray(tstarts, np.int64)
    tends = np.asarray(tends, np.int64)
    diff = np.zeros(win_len + 1, np.int64)
    lo = np.clip(tstarts - win_start, 0, win_len)
    hi = np.clip(tends - win_start, 0, win_len)
    np.add.at(diff, lo, 1)
    np.add.at(diff, hi, -1)
    return np.cumsum(diff[:-1]).astype(np.int32)


def covered_intervals(min_coverage: int, tstarts, tends,
                      win_start: int, win_len: int) -> list[Interval]:
    """Maximal intervals with coverage >= min_coverage inside the window
    (reference Coverage.cpp CoveredIntervals)."""
    cov = coverage_in_window(tstarts, tends, win_start, win_len)
    ok = cov >= min_coverage
    out: list[Interval] = []
    start = None
    for i, v in enumerate(ok):
        if v and start is None:
            start = i
        elif not v and start is not None:
            out.append(Interval(win_start + start, win_start + i))
            start = None
    if start is not None:
        out.append(Interval(win_start + start, win_start + len(ok)))
    return out
