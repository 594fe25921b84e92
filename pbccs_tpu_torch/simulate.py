"""Synthetic data generation: sample subreads from the Arrow generative model.

The reference validates its kernels with hundreds of random template/read
pairs (reference ConsensusCore/src/Tests/Random.hpp:63-96 and
TestRecursors.cpp:291-440); this module plays the same role and additionally
samples *from the model itself* so that likelihood-based tests have known
statistics and consensus tests have a known ground-truth template.
"""

from __future__ import annotations

import numpy as np

from pbccs_tpu_torch.models.arrow.params import (
    CONTEXT_COEFF,
    MISMATCH_PROBABILITY,
    TRANS_BRANCH,
    TRANS_DARK,
    TRANS_MATCH,
    TRANS_STICK,
    revcomp,
)


def random_template(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length).astype(np.int8)


def random_snr(rng: np.random.Generator, lo: float = 6.0, hi: float = 12.0) -> np.ndarray:
    return rng.uniform(lo, hi, size=4)


def sample_read(rng: np.random.Generator, tpl: np.ndarray, trans: np.ndarray,
                pr_miscall: float = MISMATCH_PROBABILITY) -> np.ndarray:
    """Sample one read from the pair-HMM given a template and its transition
    track.  The read is pinned to start and end with a Match on the template
    endpoints, mirroring the model's edge conditions."""
    J = len(tpl)
    out = []

    def emit_match(t):
        if rng.random() < pr_miscall:
            return (t + rng.integers(1, 4)) % 4
        return t

    out.append(emit_match(tpl[0]))
    j = 0  # current template position (last matched/consumed)
    while j < J - 1:
        p = trans[j]  # moves leaving position j
        mv = rng.choice(4, p=np.asarray(p) / np.asarray(p).sum())
        if mv == TRANS_MATCH:
            j += 1
            out.append(emit_match(tpl[j]))
        elif mv == TRANS_BRANCH:
            out.append(tpl[j + 1] if j + 1 < J else tpl[j])
        elif mv == TRANS_STICK:
            nxt = tpl[j + 1] if j + 1 < J else tpl[j]
            out.append((nxt + rng.integers(1, 4)) % 4)
        else:  # dark: deletion
            j += 1
            if j == J - 1:
                # cannot delete the pinned last base; force the final match
                out.append(emit_match(tpl[j]))
    return np.asarray(out, dtype=np.int8)


def make_transition_track(tpl: np.ndarray, snr: np.ndarray) -> np.ndarray:
    """NumPy mirror of models.arrow.params.template_transition_params, used
    host-side by the simulator and tests (float64)."""
    J = len(tpl)
    trans = np.zeros((J, 4), dtype=np.float64)
    for i in range(J - 1):
        cur, nxt = int(tpl[i]), int(tpl[i + 1])
        ctx = nxt + 4 * (cur != nxt)
        snr_c = snr[ctx % 4]
        powers = snr_c ** np.arange(4)
        xb = np.exp(CONTEXT_COEFF[ctx] @ powers)  # [dark, match, stick]
        denom = 1.0 + xb.sum()
        trans[i, TRANS_MATCH] = xb[1] / denom
        trans[i, TRANS_BRANCH] = 1.0 / denom
        trans[i, TRANS_STICK] = xb[2] / denom
        trans[i, TRANS_DARK] = xb[0] / denom
    return trans


def simulate_zmw(rng: np.random.Generator, tpl_len: int, n_passes: int,
                 snr: np.ndarray | None = None):
    """A full synthetic ZMW: template + n subreads (alternating strands like
    real SMRTbell passes) + SNR.  Returns (tpl, reads, strands, snr)."""
    tpl = random_template(rng, tpl_len)
    snr = random_snr(rng) if snr is None else snr
    trans_fwd = make_transition_track(tpl, snr)
    rc = revcomp(tpl)
    trans_rev = make_transition_track(rc, snr)
    reads, strands = [], []
    for k in range(n_passes):
        if k % 2 == 0:
            reads.append(sample_read(rng, tpl, trans_fwd))
            strands.append(0)
        else:
            reads.append(sample_read(rng, rc, trans_rev))
            strands.append(1)
    return tpl, reads, strands, snr


# --------------------------------------------------------------------------
# bulk sampling: the same generative model without a per-base Python loop
# --------------------------------------------------------------------------


def transition_track(tpl: np.ndarray, snr: np.ndarray) -> np.ndarray:
    """make_transition_track over all positions at once (float64; equal to
    it within rounding of the exponent's dot product)."""
    tpl = np.asarray(tpl, np.int64)
    trans = np.zeros((len(tpl), 4), dtype=np.float64)
    if len(tpl) < 2:
        return trans
    cur, nxt = tpl[:-1], tpl[1:]
    ctx = nxt + 4 * (cur != nxt)
    powers = np.asarray(snr, np.float64)[ctx % 4, None] ** np.arange(4)
    xb = np.exp(np.einsum("jkp,jp->jk", CONTEXT_COEFF[ctx], powers))
    denom = 1.0 + xb.sum(axis=1)
    trans[:-1, TRANS_MATCH] = xb[:, 1] / denom
    trans[:-1, TRANS_BRANCH] = 1.0 / denom
    trans[:-1, TRANS_STICK] = xb[:, 2] / denom
    trans[:-1, TRANS_DARK] = xb[:, 0] / denom
    return trans


def _miscall(rng: np.random.Generator, bases: np.ndarray,
             pr_miscall: float) -> np.ndarray:
    flip = rng.random(len(bases)) < pr_miscall
    return np.where(flip, (bases + rng.integers(1, 4, len(bases))) % 4,
                    bases)


def sample_read_bulk(rng: np.random.Generator, tpl: np.ndarray,
                     trans: np.ndarray,
                     pr_miscall: float = MISMATCH_PROBABILITY) -> np.ndarray:
    """One read from sample_read's distribution, drawn position-wise in
    bulk.  Leaving template position j, the walk emits a geometric number
    of insertions (Branch or Stick, in the proportion of their
    probabilities) before the move that advances it (Match, which emits
    the next base, or Dark); the last base is always emitted, as
    sample_read pins it.  The draws differ from sample_read's for one
    seed: use it where the distribution matters, not the stream."""
    tpl = np.asarray(tpl, np.int64)
    J = len(tpl)
    first = _miscall(rng, tpl[:1], pr_miscall)
    if J < 2:
        return first.astype(np.int8)
    p = np.asarray(trans, np.float64)[: J - 1]
    p = p / p.sum(axis=1, keepdims=True)
    advance = p[:, TRANS_MATCH] + p[:, TRANS_DARK]
    n_ins = rng.geometric(advance) - 1                     # per position j
    match = rng.random(J - 1) < p[:, TRANS_MATCH] / advance
    match[-1] = True
    owner = np.repeat(np.arange(J - 1), n_ins)
    branch = rng.random(len(owner)) < p[owner, TRANS_BRANCH] / (
        p[owner, TRANS_BRANCH] + p[owner, TRANS_STICK])
    nxt = tpl[owner + 1]
    ins = np.where(branch, nxt, (nxt + rng.integers(1, 4, len(owner))) % 4)
    # position j's segment: its insertions, then its match emission
    seg = n_ins + match
    start = 1 + np.cumsum(seg) - seg
    out = np.empty(1 + int(seg.sum()), np.int64)
    out[0] = first[0]
    rank = np.arange(len(owner)) - (np.cumsum(n_ins) - n_ins)[owner]
    out[start[owner] + rank] = ins
    j = np.flatnonzero(match)
    out[start[j] + n_ins[j]] = _miscall(rng, tpl[j + 1], pr_miscall)
    return out.astype(np.int8)


def simulate_zmw_bulk(rng: np.random.Generator, tpl_len: int, n_passes: int,
                      snr: np.ndarray | None = None):
    """simulate_zmw with its reads drawn by sample_read_bulk: the same
    model and return value, fast enough for thousands of ZMWs or 15 kb
    templates (a different stream of draws for one seed)."""
    tpl = random_template(rng, tpl_len)
    snr = random_snr(rng) if snr is None else snr
    rc = revcomp(tpl)
    tracks = (transition_track(tpl, snr), transition_track(rc, snr))
    reads = [sample_read_bulk(rng, (tpl, rc)[k % 2], tracks[k % 2])
             for k in range(n_passes)]
    return tpl, reads, [k % 2 for k in range(n_passes)], snr
