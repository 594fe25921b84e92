"""Consensus accuracy against the simulated truth: exact global edit
distance (Myers' bit-parallel algorithm over Python integers) and its
Phred-scaled error rate."""

from __future__ import annotations

import math

import numpy as np

_COMP = str.maketrans("ACGT", "TGCA")


def edit_distance(a: str, b: str) -> int:
    """Global Levenshtein distance between a and b (Myers 1999, Hyyro's
    global form)."""
    m = len(a)
    if m == 0:
        return len(b)
    peq: dict[str, int] = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    mask = (1 << m) - 1
    high = 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score


def best_end(pattern: str, text: str) -> int:
    """The end (exclusive) in `text` of the substring that `pattern`
    aligns to with the fewest edits, the whole pattern against a
    substring of the text (Myers' search form: free start and end in
    the text); the leftmost of equal ends."""
    m = len(pattern)
    if m == 0:
        return 0
    peq: dict[str, int] = {}
    for i, c in enumerate(pattern):
        peq[c] = peq.get(c, 0) | (1 << i)
    mask = (1 << m) - 1
    high = 1 << (m - 1)
    pv, mv, score = mask, 0, m
    best, end = m, 0
    for j, c in enumerate(text):
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        ph = (ph << 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
        if score < best:
            best, end = score, j + 1
    return end


def window(pattern: str, text: str) -> tuple[int, int]:
    """[start, end) of the substring of `text` that the whole `pattern`
    aligns to with the fewest edits."""
    end = best_end(pattern, text)
    return end - best_end(pattern[::-1], text[:end][::-1]), end


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def decode(codes) -> str:
    return "".join("ACGT"[c] for c in np.asarray(codes) if 0 <= c < 4)


def kmers(seq: str, k: int = 12) -> set[str]:
    return {seq[i:i + k] for i in range(len(seq) - k + 1)}


def same_strand(seq: str, ref_kmers: set[str], rc_kmers: set[str],
                k: int = 12) -> bool:
    """Whether seq runs along the sequence of ref_kmers rather than its
    reverse complement (rc_kmers), by the k-mers they share."""
    mine = kmers(seq, k)
    return len(mine & ref_kmers) >= len(mine & rc_kmers)


def errors_against_truth(seq: str, truth: str) -> int:
    """Edits between a consensus and its truth, on the strand it follows
    (a consensus is oriented by its draft's first read)."""
    rc = revcomp(truth)
    ref = truth if same_strand(seq, kmers(truth), kmers(rc)) else rc
    return edit_distance(seq, ref)


def phred(errors: int, bases: int) -> float:
    """-10 log10 of the error rate, with one pseudo-error in one
    pseudo-base so that a run without errors reads finite."""
    return -10.0 * math.log10((errors + 1) / (bases + 1))
