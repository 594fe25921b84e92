"""Statistics helpers (reference ConsensusCore/include/ConsensusCore/
Statistics/Binomial.hpp and src/C++/Statistics/Binomial.cpp).

A copy of pbccs_tpu.utils.statistics (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import math


def binomial_survival(q: int, size: int, prob: float,
                      as_phred: bool = False) -> float:
    """P[X > q] for X ~ Binom(size, prob) (R's pbinom(q, size, prob,
    lower.tail=F)); as_phred converts to -10*log10(p)
    (reference Binomial.hpp:42-47)."""
    if size < 0:
        raise ValueError("size must be >= 0")
    p = 0.0
    for k in range(max(q + 1, 0), size + 1):
        p += math.comb(size, k) * prob ** k * (1.0 - prob) ** (size - k)
    p = min(max(p, 0.0), 1.0)
    if as_phred:
        return -10.0 * math.log10(p) if p > 0 else float("inf")
    return p
