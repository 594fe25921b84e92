"""k-mer seed finding + sparse dynamic programming (SDP) seed chaining.

Behavior parity: reference include/pacbio/ccs/SparseAlignment.h (FindSeeds
over a q-gram index with homopolymer-seed masking, SparseAlign<K>) and
src/ChainSeeds.cpp (LinkScore with matches/mismatches/indels accounting,
positive-gain chaining, traceback of the best chain).

Vectorized re-design: the reference walks a SeqAn q-gram index k-mer by
k-mer and keeps sweep-line visibility sets to bound candidate predecessors
(an O(n log n) CPU trick).  Here k-mer hashes for both sequences are
computed as one polynomial matmul, matched via argsort + searchsorted, and
the chain DP runs row-group by row-group with numpy-broadcast LinkScore
over all previous seeds — simpler, cache-friendly, and exact (it searches
a superset of the reference's candidate lists, so chains are never worse).

Seed convention matches the reference: a seed is (pos1, pos2) = start of a
shared k-mer in seq1 ("H", the target/consensus) and seq2 ("V", the
query/read).
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEED_SIZE = 10  # reference FindSeedsConfig<TSize = 10>


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Base-4 polynomial hash of every k-mer; windows containing non-ACGT
    codes hash to -1."""
    codes = np.asarray(codes, np.int64)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    powers = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    h = win @ powers
    return np.where((win >= 0).all(axis=1) & (win < 4).all(axis=1), h, -1)


def _homopolymer_hashes(k: int) -> np.ndarray:
    """Hashes of AAAA.., CCCC.., GGGG.., TTTT.. (reference HpHasher)."""
    powers = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    return np.array([powers.sum() * b for b in range(4)], np.int64)


def find_seeds(seq1: np.ndarray, seq2: np.ndarray,
               k: int = DEFAULT_SEED_SIZE,
               max_occ: int | None = None) -> np.ndarray:
    """(N, 2) int32 array of (pos1, pos2) shared-k-mer seeds, homopolymer
    k-mers masked (reference FindSeeds, SparseAlignment.h:100-137).
    `max_occ` additionally masks k-mers occurring more than that many times
    in seq1 (the reference FilterSeeds quota intent) -- used by the POA
    banding to bound seed growth on repetitive long inserts."""
    h1 = kmer_hashes(seq1, k)
    h2 = kmer_hashes(seq2, k)
    if not len(h1) or not len(h2):
        return np.zeros((0, 2), np.int32)
    hp = _homopolymer_hashes(k)
    ok2 = (h2 >= 0) & ~np.isin(h2, hp)

    order = np.argsort(h1, kind="stable")
    sorted_h1 = h1[order]
    lo = np.searchsorted(sorted_h1, h2, side="left")
    hi = np.searchsorted(sorted_h1, h2, side="right")
    counts = np.where(ok2, hi - lo, 0)
    if max_occ is not None:
        counts = np.where(counts > max_occ, 0, counts)
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0, 2), np.int32)
    j_idx = np.repeat(np.arange(len(h2), dtype=np.int32), counts)
    # occurrence offsets within each j's [lo, hi) run
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    i_idx = order[np.repeat(lo, counts) + offs].astype(np.int32)
    return np.stack([i_idx, j_idx], axis=1)


def chain_seeds(seeds: np.ndarray, k: int,
                match_reward: int = 3) -> np.ndarray:
    """Best positive-gain chain through the seeds (reference ChainSeeds,
    ChainSeeds.cpp:203-361; LinkScore at :104-122).  Returns the chained
    subset of `seeds`, in chain order.  Dispatches to the native C++
    implementation (native/pbccs_native.cpp) when built; the numpy path
    below is the reference implementation.

    Seeds in the same row (equal pos2) never link to each other; a link's
    gain is matchReward*matches - indels - mismatches over the implied
    extension and must leave the running score positive."""
    n = len(seeds)
    if n == 0:
        return np.zeros((0, 2), np.int32)
    from pbccs_tpu_torch import native
    nat = native.chain_seeds(seeds, k, match_reward)
    if nat is not None:
        return nat
    s = seeds[np.lexsort((seeds[:, 0], seeds[:, 1]))].astype(np.int64)
    H, V = s[:, 0], s[:, 1]
    diag = H - V
    scores = np.full(n, k, np.int64)
    pred = np.full(n, -1, np.int64)

    # row groups (equal V): link each group against all earlier rows at once
    row_starts = np.flatnonzero(np.r_[True, V[1:] != V[:-1]])
    row_ends = np.r_[row_starts[1:], n]
    for lo, hi in zip(row_starts, row_ends):
        if lo == 0:
            continue
        aH, aV, aD = H[lo:hi, None], V[lo:hi, None], diag[lo:hi, None]
        bH, bV, bD = H[None, :lo], V[None, :lo], diag[None, :lo]
        fwd = np.minimum(aH - bH, aV - bV)
        matches = k - np.maximum(0, k - fwd)
        link = (match_reward * matches - np.abs(aD - bD) - (fwd - matches))
        # links must advance in seq1 too: every reference candidate list
        # (colSet / sweep-above / visible-left) has bH < aH, which keeps
        # chain anchors strictly increasing in both coordinates
        link = np.where(bH < aH, link, np.int64(-(2 ** 40)))
        cand = scores[None, :lo] + link
        # prefer the nearest predecessor on ties (the reference's sweep
        # structure links adjacent overlapping seeds, keeping anchors dense)
        best = lo - 1 - cand[:, ::-1].argmax(axis=1)
        best_score = cand[np.arange(hi - lo), best]
        take = best_score > 0
        scores[lo:hi] = np.where(take, best_score, k)
        pred[lo:hi] = np.where(take, best, -1)

    linked = pred >= 0
    if not linked.any():
        # no positive-gain link anywhere -> no chain (reference ChainSeeds
        # only tracks chain ends that were linked, ChainSeeds.cpp:296-305)
        return np.zeros((0, 2), np.int32)
    end = int(np.where(linked, scores, np.int64(-1)).argmax())
    chain = []
    while end >= 0:
        chain.append(end)
        end = int(pred[end])
    chain.reverse()
    return s[chain].astype(np.int32)


def sparse_align(seq1: np.ndarray, seq2: np.ndarray,
                 k: int = DEFAULT_SEED_SIZE,
                 max_occ: int | None = None) -> np.ndarray:
    """Find + chain seeds between two int8 base vectors (reference
    SparseAlign<TSize>, SparseAlignment.h:294-313); (N, 2) (pos1, pos2)."""
    return chain_seeds(find_seeds(seq1, seq2, k, max_occ), k)


def anchor_bands(chain: np.ndarray, len1: int, len2: int,
                 width: int = 30) -> np.ndarray:
    """(len1, 2) per-seq1-position [begin, end) alignable ranges on seq2,
    from chain anchors +- width, monotonically closed.

    This is the banding product of the reference's SdpRangeFinder
    (ConsensusCore/src/C++/Poa/RangeFinder.cpp:72-167): direct ranges
    around anchors, then forward/reverse closure so every position has a
    nonempty, monotone range."""
    lo = np.full(len1, np.int64(len2))
    hi = np.zeros(len1, np.int64)
    if len(chain):
        i, j = chain[:, 0].astype(np.int64), chain[:, 1].astype(np.int64)
        np.minimum.at(lo, i, np.maximum(j - width, 0))
        np.maximum.at(hi, i, np.minimum(j + width, len2))
    # forward closure: ranges never shrink backwards; fill gaps from
    # predecessors, then reverse closure from successors
    have = hi > 0
    if not have.any():
        return np.stack([np.zeros(len1, np.int64),
                         np.full(len1, len2, np.int64)], axis=1)
    lo = np.where(have, lo, np.int64(0))
    np.maximum.accumulate(lo, out=lo)
    hi = np.where(have, hi, np.int64(len2))
    hi = hi[::-1]
    np.minimum.accumulate(hi, out=hi)
    hi = hi[::-1]
    hi = np.maximum(hi, lo + 1)
    return np.stack([lo, np.minimum(hi, len2)], axis=1)
