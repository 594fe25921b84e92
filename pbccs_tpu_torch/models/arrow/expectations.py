"""Closed-form per-position moments of the Arrow HMM log-likelihood, for
the Z-score read gate at AddRead time (reference
ConsensusCore/include/ConsensusCore/Arrow/Expectations.hpp:11-57).
Port of pbccs_tpu.models.arrow.expectations."""

from __future__ import annotations

import torch

from pbccs_tpu_torch.models.arrow.params import (
    MISMATCH_PROBABILITY,
    TRANS_BRANCH,
    TRANS_DARK,
    TRANS_MATCH,
    TRANS_STICK,
)

_TINY = 1e-30


def per_base_mean_and_variance(trans: torch.Tensor,
                               eps: float = MISMATCH_PROBABILITY):
    """Per-position (mean, variance) of the log-likelihood contribution.

    trans: (..., L, 4) natural-scale transition tracks.  Returns (mean,
    var), each (..., L); all-zero (padded/sentinel) rows give 0."""
    p_m = trans[..., TRANS_MATCH]
    p_b = trans[..., TRANS_BRANCH]
    p_s = trans[..., TRANS_STICK]
    p_d = trans[..., TRANS_DARK]

    l_m = torch.log(torch.clamp(p_m, min=_TINY))
    l_b = torch.log(torch.clamp(p_b, min=_TINY))
    l_s = torch.log(torch.clamp(p_s, min=_TINY))
    l_d = torch.log(torch.clamp(p_d, min=_TINY))

    lg3 = -float(torch.log(torch.tensor(3.0)))
    e_m, e2_m = eps * lg3, eps * lg3 * lg3
    e_d = e2_d = 0.0
    e_b = e2_b = 0.0
    e_s, e2_s = lg3, lg3 * lg3

    def enn(lm, ld, lb, ls, EM, ED, EB, ES):
        md = (lm + EM) * p_m / (p_m + p_d + _TINY) \
            + (ld + ED) * p_d / (p_m + p_d + _TINY)
        ei = (lb + EB) * p_b / (p_b + p_s + _TINY) \
            + (ls + ES) * p_s / (p_b + p_s + _TINY)
        bs = ei * (p_s + p_b) / (p_m + p_d + _TINY)
        return md + bs

    mean = enn(l_m, l_d, l_b, l_s, e_m, e_d, e_b, e_s)
    var = enn(l_m ** 2, l_d ** 2, l_b ** 2, l_s ** 2,
              e2_m, e2_d, e2_b, e2_s) - mean * mean

    live = trans.sum(-1) > 0
    return torch.where(live, mean, 0.0), torch.where(live, var, 0.0)

