"""Per-read windows, alpha/beta fills and read statistics of the polish stage.

Port of the pieces of pbccs_tpu.models.arrow.scorer that the lockstep
batch polisher runs: the oriented template window of each read, the
batched alpha/beta fills (ops.fwdbwd_cuda, optionally re-centered by
argmax-guided refills), the alpha/beta mating test and the closed-form
log-likelihood moments behind the Z-score read gate (reference
ArrowMultiReadMutationScorer, MultiReadMutationScorer.cpp).  All
functions work on tensors with leading (Z, R) or flat read axes."""

from __future__ import annotations

from typing import NamedTuple

import torch

from pbccs_tpu_torch.models.arrow.expectations import \
    per_base_mean_and_variance
from pbccs_tpu_torch.models.arrow.params import transition_lookup
from pbccs_tpu_torch.ops.fwdbwd import (MAX_BAND_ADVANCE, BandedMatrix,
                                        guided_band_offsets)
from pbccs_tpu_torch.ops.fwdbwd_cuda import (backward_batch,
                                             backward_loglik_batch,
                                             forward_batch,
                                             forward_loglik_batch)
from pbccs_tpu_torch.ops.mutation_score import scale_prefix, scale_suffix

# AddRead outcome codes (reference Arrow/MultiReadMutationScorer.hpp:60-61).
ADD_SUCCESS, ADD_ALPHABETAMISMATCH, ADD_MEM_FAIL, ADD_POOR_ZSCORE, ADD_OTHER = range(5)

_AB_MISMATCH_TOL = 1e-3  # reference SimpleRecursor.cpp:53
_MAX_BAND_SHIFT = MAX_BAND_ADVANCE


def mated_mask(ll_a, ll_b, rlens, tstarts, tends) -> torch.Tensor:
    """Reads whose alpha/beta fills mate: |1 - LL_a/LL_b| within
    tolerance, both finite, and the read no longer than
    MAX_BAND_ADVANCE times its template window (insert-junk the
    reference also sheds, SimpleRecursor.cpp:683-688).  Tensors of
    matching shape, on the device (the JAX package's host mated_mask
    and batch._mated_mask_dev in one)."""
    ratio = ll_a / torch.where(ll_b == 0, 1.0, ll_b)
    mated = (1.0 - ratio).abs() <= _AB_MISMATCH_TOL
    mated &= torch.isfinite(ll_a) & torch.isfinite(ll_b)
    mated &= rlens <= _MAX_BAND_SHIFT * (tends - tstarts).clamp(min=1)
    return mated


def oriented_window(strand, ts, te, tpl_f, tpl_r, L, table):
    """Each read's oriented template window (bases, transitions, length).

    strand, ts, te (Z, R); tpl_f, tpl_r (Z, Jmax) forward and
    reverse-complement templates; L (Z,); table (Z, 8, 4).  Returns
    win_tpl (Z, R, Jmax) int8, win_trans (Z, R, Jmax, 4), wlen (Z, R).
    The transition track is recomputed from the window itself (equal to
    the full-template track inside the window)."""
    Z, R = strand.shape
    Jmax = tpl_f.shape[1]
    ws = torch.where(strand == 0, ts, L[:, None] - te)
    wlen = te - ts
    idx = torch.arange(Jmax, device=tpl_f.device)
    src = (ws[..., None] + idx).clamp(0, Jmax - 1)              # (Z, R, Jmax)
    both = torch.cat([tpl_f, tpl_r], dim=1).to(torch.int64)    # (Z, 2*Jmax)
    pick = torch.where(strand[..., None] == 0, src, src + Jmax)
    base = torch.gather(both, 1, pick.reshape(Z, -1)).reshape(Z, R, Jmax)
    win_tpl = torch.where(idx < wlen[..., None], base, 4)
    nxt = torch.roll(win_tpl, -1, dims=-1)
    params = transition_lookup(win_tpl.reshape(Z, -1), nxt.reshape(Z, -1),
                               table).reshape(Z, R, Jmax, 4)
    win_trans = torch.where((idx < wlen[..., None] - 1)[..., None], params,
                            0.0)
    return win_tpl.to(torch.int8), win_trans, wlen


def guided_fill_passes(jmax: int) -> int:
    """Argmax-guided refill ("flip-flop") passes after the diagonal-band
    fill at this template bucket: none up to 3 kb (the path drifts well
    inside W/2), one up to 8 kb, three beyond (the JAX package's
    schedule, from its drift model std ~ sqrt(2 p_indel L) rows)."""
    if jmax <= 3072:
        return 0
    return 1 if jmax <= 8192 else 3


class FillState(NamedTuple):
    """Banded alpha/beta fills of a read batch with their log-likelihoods
    and scale prefix (alpha) / suffix (beta), leaves (R, ...)."""

    alpha: BandedMatrix
    beta: BandedMatrix
    ll_a: torch.Tensor
    ll_b: torch.Tensor
    apre: torch.Tensor
    bsuf: torch.Tensor


def _fill_alpha(reads, rlens, win_tpl, win_trans, wlens, width, offsets):
    alpha = forward_batch(reads, rlens, win_tpl, win_trans, wlens, width,
                          offsets=offsets)
    return alpha, forward_loglik_batch(alpha, rlens, wlens)


def fill_alpha_beta_batch(reads, rlens, win_tpl, win_trans, wlens,
                          width: int, guided_passes: int = 0) -> FillState:
    """Batched alpha/beta fills + log-likelihoods + scale prefixes over a
    flat read batch (leading axis R), on the diagonal band layout.

    `guided_passes` > 0 re-centers the band on the alpha argmax path
    (fwdbwd.guided_band_offsets) and refills that many times, keeping per
    read whichever alpha has the better log-likelihood (never trade down:
    the first fill may have locked onto the right ridge).  Beta then runs
    on alpha's band."""
    alpha, ll_a = _fill_alpha(reads, rlens, win_tpl, win_trans, wlens,
                              width, None)
    for _ in range(guided_passes):
        g_off = guided_band_offsets(alpha.vals, alpha.offsets, rlens, wlens,
                                    width)
        alpha_g, ll_g = _fill_alpha(reads, rlens, win_tpl, win_trans, wlens,
                                    width, g_off)
        keep = ll_g >= ll_a
        alpha = BandedMatrix(
            torch.where(keep[:, None, None], alpha_g.vals, alpha.vals),
            torch.where(keep[:, None], alpha_g.offsets, alpha.offsets),
            torch.where(keep[:, None], alpha_g.log_scales, alpha.log_scales))
        ll_a = torch.where(keep, ll_g, ll_a)
    beta = backward_batch(reads, rlens, win_tpl, win_trans, wlens, width,
                          offsets=alpha.offsets if guided_passes else None)
    ll_b = backward_loglik_batch(beta, wlens)
    return FillState(alpha, beta, ll_a, ll_b, scale_prefix(alpha.log_scales),
                     scale_suffix(beta.log_scales))


def fill_alpha_beta_batch_zr(reads, rlens, win_tpl, win_trans, wlens,
                             width: int, guided_passes: int = 0) -> FillState:
    """(Z, R)-leading fills: flattens to the (Z*R,) read batch so each
    fill runs as one kernel launch, then restores the (Z, R) axes."""
    Z, R = reads.shape[:2]
    flat = lambda a: a.reshape((Z * R,) + a.shape[2:])  # noqa: E731
    out = fill_alpha_beta_batch(flat(reads), flat(rlens), flat(win_tpl),
                                flat(win_trans), flat(wlens), width,
                                guided_passes=guided_passes)
    unflat = lambda a: a.reshape((Z, R) + a.shape[1:])  # noqa: E731
    return FillState(BandedMatrix(*map(unflat, out.alpha)),
                     BandedMatrix(*map(unflat, out.beta)),
                     unflat(out.ll_a), unflat(out.ll_b), unflat(out.apre),
                     unflat(out.bsuf))


def window_moments(strand, ts, te, mean_f, var_f, mean_r, var_r, L):
    """(mu, var) of E[log-lik] over each read's window of the oriented
    template (closed-form HMM moments, Expectations.hpp:45).  strand, ts,
    te (Z, R); mean_*/var_* (Z, Jmax); L (Z,).  Uses the read's window on
    the oriented template, as the JAX package does (a documented
    deviation from the reference's forward-frame indexing,
    MultiReadMutationScorer.cpp:299-317)."""
    Lc = L[:, None]
    s = torch.where(strand == 0, ts, Lc - te)[..., None]
    e = torch.where(strand == 0, te, Lc - ts)[..., None]
    pos = torch.arange(mean_f.shape[1], device=mean_f.device)
    m = (pos >= s) & (pos < e - 1)
    fwd = (strand == 0)[..., None]
    mu = torch.where(m, torch.where(fwd, mean_f[:, None], mean_r[:, None]),
                     0.0).sum(-1)
    v = torch.where(m, torch.where(fwd, var_f[:, None], var_r[:, None]),
                    0.0).sum(-1)
    return mu, v


def _read_moments(strands, tstarts, tends, trans_f, trans_r, L):
    """Per-read (mu, var) over each read's oriented window."""
    mean_f, var_f = per_base_mean_and_variance(trans_f)
    mean_r, var_r = per_base_mean_and_variance(trans_r)
    return window_moments(strands, tstarts, tends, mean_f, var_f, mean_r,
                          var_r, L)
