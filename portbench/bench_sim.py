"""The benchmark's traffic generator: simulated ZMWs drawn from the Arrow
generative model, from a seed.

A frozen copy of the port's bulk sampler (`simulate.simulate_zmw_bulk`:
random template, reads drawn position-wise from the pair-HMM, passes on
alternating strands), so the yardstick does not move when the program
does.  One change of use: a pool is drawn from its traffic's fixed
content seed, with pass counts in equal shares and SNRs at stratified
quantiles, and the run's seed shuffles it (make_pool); the pool of the
check batch is drawn from the run's seed itself (check_pool)."""

from __future__ import annotations

import dataclasses

import numpy as np

import arrow_ref as ar

_TR = ar.MATCH, ar.BRANCH, ar.STICK, ar.DARK


@dataclasses.dataclass
class Zmw:
    """One simulated ZMW: its id, truth template, native subreads, the
    strand each runs along the truth (0 forward), and channel SNRs."""

    id: str
    truth: np.ndarray
    reads: list
    strands: list
    snr: np.ndarray


def _miscall(rng, bases, pr_miscall):
    flip = rng.random(len(bases)) < pr_miscall
    return np.where(flip, (bases + rng.integers(1, 4, len(bases))) % 4, bases)


def sample_read(rng, tpl: np.ndarray, trans: np.ndarray,
                pr_miscall: float = ar.MISMATCH_PROBABILITY) -> np.ndarray:
    """One read pinned to the template's first and last bases: leaving
    position j the walk emits a geometric number of insertions (Branch or
    Stick, in proportion) before it advances by Match (emitting the next
    base) or Dark."""
    M, B, S, D = _TR
    tpl = np.asarray(tpl, np.int64)
    J = len(tpl)
    first = _miscall(rng, tpl[:1], pr_miscall)
    if J < 2:
        return first.astype(np.int8)
    p = np.asarray(trans, np.float64)[: J - 1]
    p = p / p.sum(axis=1, keepdims=True)
    advance = p[:, M] + p[:, D]
    n_ins = rng.geometric(advance) - 1
    match = rng.random(J - 1) < p[:, M] / advance
    match[-1] = True
    owner = np.repeat(np.arange(J - 1), n_ins)
    branch = rng.random(len(owner)) < p[owner, B] / (p[owner, B]
                                                     + p[owner, S])
    nxt = tpl[owner + 1]
    ins = np.where(branch, nxt, (nxt + rng.integers(1, 4, len(owner))) % 4)
    seg = n_ins + match
    start = 1 + np.cumsum(seg) - seg
    out = np.empty(1 + int(seg.sum()), np.int64)
    out[0] = first[0]
    rank = np.arange(len(owner)) - (np.cumsum(n_ins) - n_ins)[owner]
    out[start[owner] + rank] = ins
    j = np.flatnonzero(match)
    out[start[j] + n_ins[j]] = _miscall(rng, tpl[j + 1], pr_miscall)
    return out.astype(np.int8)


def simulate_zmw(rng, zid: str, tpl_len: int, n_passes: int,
                 snr: np.ndarray) -> Zmw:
    tpl = rng.integers(0, 4, size=tpl_len).astype(np.int8)
    table = ar.transition_table(snr)
    rc = ar.COMPLEMENT[tpl[::-1].astype(np.int64)].astype(np.int8)
    tracks = (ar.track(tpl, table), ar.track(rc, table))
    reads = [sample_read(rng, (tpl, rc)[k % 2], tracks[k % 2])
             for k in range(n_passes)]
    return Zmw(zid, tpl, reads, [k % 2 for k in range(n_passes)],
               np.asarray(snr, np.float64))


def make_pool(cfg: dict, n: int, seed: int, content_seed,
              prefix: str = "pb/") -> list[Zmw]:
    """`n` ZMWs of configuration `cfg` (insert_length, passes [lo, hi],
    snr [lo, hi]), in an order drawn from `seed`.  The ZMWs themselves
    come from `content_seed`, the traffic's: pass counts lo..hi in equal
    shares, each channel's SNR at the n stratified quantiles of its
    range, templates and subreads from the model.  A pool's polish time
    follows its slowest ZMWs, so pools drawn anew per seed differ in
    work by a quarter; every seed gets the same ZMWs, in another order,
    and draws its own sample for the correctness check.  `content_seed`
    is anything numpy's default_rng takes."""
    rng = np.random.default_rng(content_seed)
    lo, hi = cfg["passes"]
    passes = np.resize(np.arange(lo, hi + 1), n)
    rng.shuffle(passes)
    s_lo, s_hi = cfg["snr"]
    snr = np.stack([(rng.permutation(n) + rng.random(n)) / n
                    for _ in range(4)], 1) * (s_hi - s_lo) + s_lo
    zmws = [simulate_zmw(rng, "", int(cfg["insert_length"]),
                         int(passes[z]), snr[z]) for z in range(n)]
    order = np.random.default_rng(seed).permutation(n)
    return [dataclasses.replace(zmws[k], id=f"{prefix}{z}")
            for z, k in enumerate(order)]


def check_pool(cfg: dict, n: int, seed: int) -> list[Zmw]:
    """`n` ZMWs of `cfg` whose content the run's seed draws, for the
    check batch polished after the window: the same sizes and SNRs as a
    traffic pool, other templates and subreads on every seed."""
    s = seed % (1 << 63)
    return make_pool(cfg, n, s, [s, 0x636865636B], prefix="check/")
