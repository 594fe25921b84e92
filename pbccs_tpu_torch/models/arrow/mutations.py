"""Mutation algebra (host side): single-base template edits, enumeration,
application, coordinate remapping, selection, and the slot-grid tables.

Port of pbccs_tpu.models.arrow.mutations, the parts the port runs: the
Mutation record and the host algebra the generic refinement loop
(models.arrow.refine.refine_consensus, the Quiver polish) drives --
enumerate_unique, unique_nearby_mutations, apply_mutations,
target_to_query_positions, best_subset, qvs_from_neg_sums -- the
serial scorer's strand and slot helpers (reverse_complement_mutation,
mutation_slot), and the per-position slot order of the device-resident loop (subs A/C/G/T, ins
A/C/G/T, del: the enumeration order of UniqueSingleBaseMutationEnumerator,
reference MutationEnumerator.cpp:111-147).  Plain numpy and Python:
mutation lists are small and data dependent.

Parity targets:
  Mutation / ApplyMutations / TargetToQueryPositions
      reference ConsensusCore/src/C++/Mutation.cpp:116-197
  enumerators
      reference ConsensusCore/src/C++/Arrow/MutationEnumerator.cpp:81-215
  BestSubset
      reference Consensus-inl.hpp:90-118"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

SUBSTITUTION, INSERTION, DELETION = 0, 1, 2

_SLOT_BASES = np.array([0, 1, 2, 3, 0, 1, 2, 3, -1], np.int32)
_SLOT_TYPES = np.array([SUBSTITUTION] * 4 + [INSERTION] * 4 + [DELETION],
                       np.int32)
_SLOT_ENDOFF = np.array([1, 1, 1, 1, 0, 0, 0, 0, 1], np.int32)


@dataclasses.dataclass(frozen=True, order=True)
class Mutation:
    """A single edit of the template.

    start/end follow the reference convention: substitution replaces
    [start, end); deletion removes [start, end); insertion inserts
    new_base *before* position start (start == end)."""

    start: int
    end: int
    mtype: int
    new_base: int = -1  # int8 base code; -1 for deletion
    score: float = 0.0  # filled by scoring (ScoredMutation)

    @property
    def length_diff(self) -> int:
        if self.mtype == INSERTION:
            return 1
        if self.mtype == DELETION:
            return -(self.end - self.start)
        return 0

    def with_score(self, s: float) -> "Mutation":
        return dataclasses.replace(self, score=float(s))


def substitution(pos: int, base: int) -> Mutation:
    return Mutation(pos, pos + 1, SUBSTITUTION, base)


def insertion(pos: int, base: int) -> Mutation:
    return Mutation(pos, pos, INSERTION, base)


def deletion(pos: int) -> Mutation:
    return Mutation(pos, pos + 1, DELETION)


def enumerate_unique(tpl: np.ndarray, begin: int = 0,
                     end: int | None = None) -> list[Mutation]:
    """Homopolymer-deduplicated enumeration: insertions/deletions only at
    the start of a homopolymer run, per position subs by base, ins by
    base, then del (UniqueSingleBaseMutationEnumerator)."""
    end = len(tpl) if end is None else min(end, len(tpl))
    begin = max(begin, 0)
    out: list[Mutation] = []
    for pos in range(begin, end):
        prev = tpl[pos - 1] if pos > 0 else -1
        for b in range(4):
            if b != tpl[pos]:
                out.append(substitution(pos, b))
        for b in range(4):
            if b != prev:
                out.append(insertion(pos, b))
        if tpl[pos] != prev:
            out.append(deletion(pos))
    return out


def unique_nearby_mutations(tpl: np.ndarray, centers: Iterable[Mutation],
                            neighborhood: int) -> list[Mutation]:
    """Unique mutations within +-neighborhood of prior mutations,
    deduplicated in first-seen order (UniqueNearbyMutations)."""
    seen = set()
    out: list[Mutation] = []
    for m in centers:
        for cand in enumerate_unique(tpl, m.start - neighborhood,
                                     m.end + neighborhood):
            key = (cand.start, cand.end, cand.mtype, cand.new_base)
            if key not in seen:
                seen.add(key)
                out.append(cand)
    return out


def _sorted(muts: Sequence[Mutation]) -> list[Mutation]:
    return sorted(muts, key=lambda m: (m.start, m.end, m.mtype, m.new_base))


def apply_mutations(tpl: np.ndarray, muts: Sequence[Mutation]) -> np.ndarray:
    """Apply sorted mutations left-to-right with a running length offset
    (ApplyMutations, Mutation.cpp:116-128)."""
    out = list(tpl)
    diff = 0
    for m in _sorted(muts):
        s = m.start + diff
        if m.mtype == SUBSTITUTION:
            out[s:s + (m.end - m.start)] = [m.new_base]
        elif m.mtype == INSERTION:
            out[s:s] = [m.new_base]
        else:
            del out[s:s + (m.end - m.start)]
        diff += m.length_diff
    return np.asarray(out, dtype=np.int8)


def mutations_to_transcript(muts: Sequence[Mutation], tpl_len: int) -> str:
    """MIDR transcript of sorted mutations (Mutation.cpp:130-171)."""
    tpos = 0
    t = []
    for m in _sorted(muts):
        t.append("M" * (m.start - tpos))
        tpos = m.start
        n = m.end - m.start
        if m.mtype == INSERTION:
            t.append("I")
        else:
            t.append(("D" if m.mtype == DELETION else "R") * n)
            tpos += n
    t.append("M" * (tpl_len - tpos))
    return "".join(t)


def target_to_query_positions(muts: Sequence[Mutation],
                              tpl_len: int) -> np.ndarray:
    """Old-template position -> new-template position map, length
    tpl_len + 1 (TargetToQueryPositions, Mutation.cpp:173-197)."""
    mtp = np.zeros(tpl_len + 1, dtype=np.int64)
    tpos, qpos = 0, 0
    for c in mutations_to_transcript(muts, tpl_len):
        if c in "MR":
            mtp[tpos] = qpos
            tpos += 1
            qpos += 1
        elif c == "I":
            qpos += 1
        else:                                    # D
            mtp[tpos] = qpos
            tpos += 1
    mtp[tpos] = qpos
    return mtp


def best_subset(scored: list[Mutation], separation: int) -> list[Mutation]:
    """Greedy top-scoring well-separated subset (BestSubset,
    Consensus-inl.hpp:90-118): take the best, drop every mutation whose
    start lies within [best.start - sep, best.start + sep], repeat; ties
    go to the earlier mutation of the list."""
    if separation == 0:
        return list(scored)
    pool = list(scored)
    out: list[Mutation] = []
    while pool:
        best = max(pool, key=lambda m: m.score)
        out.append(best)
        lo, hi = best.start - separation, best.start + separation
        pool = [m for m in pool if not (lo <= m.start <= hi)]
    return out


_COMPLEMENT_BASE = {-1: -1, 0: 3, 1: 2, 2: 1, 3: 0}


def reverse_complement_mutation(m: Mutation, tpl_len: int) -> Mutation:
    """The same edit expressed on the reverse-complement template
    (MultiReadMutationScorer.cpp:343-348)."""
    return Mutation(tpl_len - m.end, tpl_len - m.start, m.mtype,
                    _COMPLEMENT_BASE[m.new_base], m.score)


def mutation_slot(mtype: np.ndarray, new_base: np.ndarray) -> np.ndarray:
    """Each mutation's slot in the 9-slot grid of its start position
    (sub b -> b, ins b -> 4 + b, del -> 8)."""
    mtype = np.asarray(mtype)
    new_base = np.asarray(new_base)
    return np.where(mtype == SUBSTITUTION, new_base,
                    np.where(mtype == INSERTION, 4 + new_base, 8))


# ---------------------------------------------------------------------- QVs

_LN10 = float(np.log(10.0))
# Value the direct f64 aggregation yields when no negative-scoring mutation
# exists at a position (prob clamps to float64 tiny):
# round(-10*log10(2.225e-308)) == 3077.
QV_SATURATED = int(np.round(-10.0 * np.log10(np.finfo(np.float64).tiny)))


def qvs_from_neg_sums(ssum: np.ndarray) -> np.ndarray:
    """Per-position consensus QVs from the summed exp(score) of the
    negative-scoring single-base mutations (reference ConsensusQVs,
    Consensus-inl.hpp:277-297), in the stable log-space form
    QV = -10 (log s - softplus(log s)) / ln 10; positions with no
    negative mutation saturate to QV_SATURATED."""
    ssum = np.asarray(ssum, np.float64)
    with np.errstate(divide="ignore"):
        t = np.log(ssum)
    qv = -10.0 * (t - np.logaddexp(0.0, t)) / _LN10
    return np.where(ssum > 0.0, np.round(qv), QV_SATURATED).astype(np.int32)
