"""Needleman-Wunsch style pairwise alignment with vectorized row sweeps.

Behavior parity: reference ConsensusCore Align/PairwiseAlignment.{hpp,cpp}
(transcript conventions per Gusfield: M/R/I/D with I = gap in target,
D = gap in query; move preference diagonal > insert > delete) and
Align/AlignConfig.{hpp,cpp} (edit-distance defaults 0/-1/-1/-1, GLOBAL).

The reference fills the DP cell-by-cell; here each row is one numpy sweep:
the horizontal (delete) move's in-row recurrence
``S[i,j] = max(V[j], S[i,j-1] + d)`` is a prefix max of ``V[j] - j*d``,
so the whole row vectorizes.  The reference's ``Align`` supports GLOBAL
only (PairwiseAlignment.cpp:137 throws otherwise); SEMIGLOBAL and LOCAL
here are a documented extension matching the AlignMode enum.

A copy of pbccs_tpu.align.pairwise (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

GLOBAL, SEMIGLOBAL, LOCAL = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class AlignParams:
    """Linear-gap scoring; defaults are edit distance
    (reference AlignConfig.cpp:59-62)."""

    match: int = 0
    mismatch: int = -1
    insert: int = -1   # gap in target (consumes query)
    delete: int = -1   # gap in query (consumes target)


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    params: AlignParams = dataclasses.field(default_factory=AlignParams)
    mode: int = GLOBAL


class PairwiseAlignment:
    """A gapped alignment: target/query strings of equal length with '-'
    gaps, and the Gusfield transcript (M match, R mismatch, I insertion,
    D deletion).  Reference PairwiseAlignment.hpp:64-96."""

    def __init__(self, target: str, query: str,
                 target_begin: int = 0, query_begin: int = 0):
        if len(target) != len(query):
            raise ValueError("gapped strings must have equal length")
        tr = []
        for t, q in zip(target, query):
            if t == "-" and q == "-":
                raise ValueError("column with two gaps")
            tr.append("M" if t == q else "I" if t == "-" else
                      "D" if q == "-" else "R")
        self.target = target
        self.query = query
        self.transcript = "".join(tr)
        # start offsets of the aligned region (LOCAL/SEMIGLOBAL extension)
        self.target_begin = target_begin
        self.query_begin = query_begin

    @classmethod
    def from_transcript(cls, transcript: str, target: str, query: str
                        ) -> "PairwiseAlignment":
        """Reconstruct the gapped strings from a transcript over the
        unaligned sequences (reference PairwiseAlignment::FromTranscript)."""
        gt, gq = [], []
        ti = qi = 0
        for c in transcript:
            if c in "MR":
                gt.append(target[ti]); gq.append(query[qi]); ti += 1; qi += 1
            elif c == "D":
                gt.append(target[ti]); gq.append("-"); ti += 1
            elif c == "I":
                gt.append("-"); gq.append(query[qi]); qi += 1
            else:
                raise ValueError(f"bad transcript op {c!r}")
        if ti != len(target) or qi != len(query):
            raise ValueError("transcript does not span the sequences")
        return cls("".join(gt), "".join(gq))

    @property
    def length(self) -> int:
        return len(self.target)

    @property
    def matches(self) -> int:
        return self.transcript.count("M")

    @property
    def mismatches(self) -> int:
        return self.transcript.count("R")

    @property
    def insertions(self) -> int:
        return self.transcript.count("I")

    @property
    def deletions(self) -> int:
        return self.transcript.count("D")

    @property
    def errors(self) -> int:
        return self.length - self.matches

    @property
    def accuracy(self) -> float:
        return self.matches / self.length if self.length else 0.0

    def __repr__(self):
        return f"PairwiseAlignment({self.target!r}, {self.query!r})"


def _fill(query: str, target: str, p: AlignParams, mode: int) -> np.ndarray:
    """(I+1, J+1) int32 score matrix; rows sweep the query."""
    I, J = len(query), len(target)
    q = np.frombuffer(query.encode(), np.uint8)
    t = np.frombuffer(target.encode(), np.uint8)
    S = np.empty((I + 1, J + 1), np.int32)
    j = np.arange(1, J + 1, dtype=np.int32)
    if mode == GLOBAL:
        S[0, 0] = 0
        S[0, 1:] = j * p.delete
    else:  # SEMIGLOBAL / LOCAL: leading target overhang is free
        S[0] = 0
    dj = np.arange(J + 1, dtype=np.int64) * p.delete
    for i in range(1, I + 1):
        sub = np.where(t == q[i - 1], p.match, p.mismatch).astype(np.int64)
        v = np.empty(J + 1, np.int64)
        if mode == GLOBAL or mode == SEMIGLOBAL:
            v[0] = i * p.insert
        else:
            v[0] = 0
        v[1:] = np.maximum(S[i - 1, :-1] + sub, S[i - 1, 1:] + p.insert)
        if mode == LOCAL:
            v = np.maximum(v, 0)
        # horizontal move as prefix max: S[i,j] = max_{k<=j} v[k] + (j-k)*d
        S[i] = np.maximum.accumulate(v - dj) + dj
        if mode == LOCAL:
            S[i] = np.maximum(S[i], 0)
    return S


def align(target: str, query: str, config: AlignConfig | None = None,
          ) -> PairwiseAlignment:
    """Align query against target; returns the gapped alignment.

    GLOBAL output matches the reference's Align (PairwiseAlignment.cpp:
    124-215) including traceback preference.  SEMIGLOBAL keeps the full
    target, padding the overhang with deletions; LOCAL returns the aligned
    region with `target_begin`/`query_begin` offsets."""
    cfg = config or AlignConfig()
    p, mode = cfg.params, cfg.mode
    I, J = len(query), len(target)
    S = _fill(query, target, p, mode)

    if mode == GLOBAL:
        i, j = I, J
        stop = lambda i, j: i == 0 and j == 0
    elif mode == SEMIGLOBAL:
        i, j = I, int(np.argmax(S[I]))
        stop = lambda i, j: i == 0
    else:
        i, j = np.unravel_index(int(np.argmax(S)), S.shape)
        i, j = int(i), int(j)
        stop = lambda i, j: S[i, j] == 0

    end_i, end_j = i, j
    gt, gq = [], []
    while not stop(i, j):
        if i == 0:
            move = 2
        elif j == 0:
            move = 1
        else:
            sub = p.match if query[i - 1] == target[j - 1] else p.mismatch
            cand = (S[i - 1, j - 1] + sub, S[i - 1, j] + p.insert,
                    S[i, j - 1] + p.delete)
            # diagonal > insert > delete on ties (reference ArgMax3)
            move = 0 if cand[0] >= cand[1] and cand[0] >= cand[2] else \
                1 if cand[1] >= cand[2] else 2
        if move == 0:
            i -= 1; j -= 1
            gt.append(target[j]); gq.append(query[i])
        elif move == 1:
            i -= 1
            gt.append("-"); gq.append(query[i])
        else:
            j -= 1
            gt.append(target[j]); gq.append("-")

    gt.reverse(); gq.reverse()
    if mode == SEMIGLOBAL:
        # pad free target overhangs back in as deletions
        gt = list(target[:j]) + gt + list(target[end_j:])
        gq = ["-"] * j + gq + ["-"] * (J - end_j)
        j = 0
    return PairwiseAlignment("".join(gt), "".join(gq),
                             target_begin=j, query_begin=i)


def align_score(target: str, query: str, config: AlignConfig | None = None
                ) -> int:
    """The optimal alignment score alone (no traceback)."""
    cfg = config or AlignConfig()
    S = _fill(query, target, cfg.params, cfg.mode)
    if cfg.mode == GLOBAL:
        return int(S[-1, -1])
    if cfg.mode == SEMIGLOBAL:
        return int(S[-1].max())
    return int(S.max())


def target_to_query_positions(transcript: str) -> np.ndarray:
    """len(target)+1 indices into the query, per transcript op
    (reference PairwiseAlignment.cpp TargetToQueryPositions)."""
    out = [0]
    pos = 0
    for c in transcript:
        if c in "MR":
            pos += 1
            out.append(pos)
        elif c == "I":
            pos += 1
            out[-1] = pos
        elif c == "D":
            out.append(pos)
        else:
            raise ValueError(f"bad transcript op {c!r}")
    return np.asarray(out, np.int32)
