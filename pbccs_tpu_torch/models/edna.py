"""Edna: channel-space pulse evaluator (experimental basecaller-adjacent
model; reference ConsensusCore/include/ConsensusCore/Edna/EdnaEvaluator.hpp,
EdnaConfig.hpp:46-67).  Not used by the CCS pipeline; exported for API
parity with the reference's SWIG surface.

The model works on channel observations (1..4; 0 = dark/deletion) against a
channel-space template: per template base a stay probability pStay, a merge
probability pMerge (when the next template channel matches), and move/stay
emission distributions over the 5 observation symbols.  Move scores are
log-space, matching QvEvaluator's interface so the Quiver recursor
machinery applies.

A copy of pbccs_tpu.models.edna (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _log(x: float) -> float:
    """log with an exact -inf at zero (a zero-probability move is a legal
    score, not a RuntimeWarning)."""
    return float(np.log(x)) if x > 0.0 else float("-inf")


@dataclasses.dataclass(frozen=True)
class EdnaModelParams:
    """pStay/pMerge per template base (4,), move/stay emission tables
    (4, 5) over observations {0=dark, 1..4=channels}
    (reference EdnaConfig.hpp:46-67)."""

    p_stay: tuple
    p_merge: tuple
    move_dists: tuple     # flattened (4, 5) row-major, as in the reference
    stay_dists: tuple

    def move_dist(self, tpl_base: int, obs: int) -> float:
        return self.move_dists[(tpl_base - 1) * 5 + obs]

    def stay_dist(self, tpl_base: int, obs: int) -> float:
        return self.stay_dists[(tpl_base - 1) * 5 + obs]


class EdnaEvaluator:
    """Move scores for one (channel read, channel template) pair
    (reference EdnaEvaluator.hpp:70-262)."""

    def __init__(self, channels: np.ndarray, channel_tpl: np.ndarray,
                 params: EdnaModelParams, pin_start: bool = True,
                 pin_end: bool = True):
        self.channels = np.asarray(channels, np.int32)
        self.tpl = np.asarray(channel_tpl, np.int32)
        self.params = params
        self.pin_start = pin_start
        self.pin_end = pin_end

    def read_length(self) -> int:
        return len(self.channels)

    def template_length(self) -> int:
        return len(self.tpl)

    def _tpl_base(self, j: int) -> int:
        return int(self.tpl[j]) if j < len(self.tpl) else 1

    def _p_stay(self, j: int) -> float:
        return self.params.p_stay[self._tpl_base(j) - 1]

    def _p_merge(self, j: int) -> float:
        if j < len(self.tpl) - 1 and self.tpl[j] == self.tpl[j + 1]:
            return self.params.p_merge[self._tpl_base(j) - 1]
        return 0.0

    def is_match(self, i: int, j: int) -> bool:
        return bool(self.channels[i] == self.tpl[j])

    def inc(self, i: int, j: int) -> float:
        ps = self._p_stay(j)
        pm = (1.0 - ps) * self._p_merge(j)
        trans = 1.0 - ps - pm
        em = self.params.move_dist(self._tpl_base(j), int(self.channels[i]))
        return _log(trans * em)

    def delete(self, i: int, j: int) -> float:
        if (not self.pin_start and i == 0) or \
                (not self.pin_end and i == self.read_length()):
            return 0.0
        ps = self._p_stay(j)
        pm = (1.0 - ps) * self._p_merge(j)
        trans = 1.0 - ps - pm
        em = self.params.move_dist(self._tpl_base(j), 0)
        return _log(trans * em)

    def extra(self, i: int, j: int) -> float:
        trans = self._p_stay(j)
        em = self.params.stay_dist(self._tpl_base(j), int(self.channels[i]))
        return _log(trans * em)

    def merge(self, i: int, j: int) -> float:
        """Merge move score, *including* the pulse emission so merge() and
        score_move(j, j+2, obs) agree.  (Documented deviation: the
        reference's Edna Merge() drops the emission term,
        EdnaEvaluator.hpp:222-237, which disagrees with its own ScoreMove
        and leaves the forward probability unnormalized; Edna is flagged
        experimental there.)"""
        if not (j < len(self.tpl) - 1 and self.channels[i] == self.tpl[j]
                and self.channels[i] == self.tpl[j + 1]):
            return -np.inf
        ps = self._p_stay(j)
        pm = (1.0 - ps) * self._p_merge(j)
        em = self.params.move_dist(self._tpl_base(j + 1), int(self.channels[i]))
        return _log(pm * em)

    def score_move(self, j1: int, j2: int, obs: int) -> float:
        """Transition+emission log score for moving template j1 -> j2 while
        observing `obs` (reference EdnaEvaluator.hpp:239-262)."""
        ps = self._p_stay(j1)
        pm = (1.0 - ps) * self._p_merge(j1)
        if j1 == j2:
            return _log(ps * self.params.stay_dist(self._tpl_base(j1), obs))
        if j1 + 1 == j2:
            trans = 1.0 - ps - pm
            return _log(trans * self.params.move_dist(self._tpl_base(j1), obs))
        if j1 + 2 == j2:
            return _log(pm * self.params.move_dist(self._tpl_base(j1 + 1), obs))
        raise ValueError("moves advance the template by 0, 1 or 2")

    def loglik(self) -> float:
        """Dense forward log-likelihood over the full move set (the Edna
        counterpart of the Quiver dense oracle); shares the edna_fill
        recursion so the oracle and the counts machinery cannot drift."""
        alpha, _ = edna_fill(self)
        return float(alpha[self.read_length(), self.template_length()])


def _transition(ev: EdnaEvaluator, i: int, j1: int, j2: int,
                obs: int) -> float:
    """Log score of the model transition from (i*, j1) to j2 observing
    `obs` (0 = dark, consuming no pulse; else consuming pulse i).  The ONE
    definition of the move set, shared by edna_fill and edna_counts so the
    posterior counts always partition the fill's total:

      j1 -> j1+1 pulse: move (score_move);  dark: delete() (pin-aware)
      j1 -> j1   pulse: stay (final column clamps params); dark: no move
      j1 -> j1+2 pulse: merge() (match-gated);             dark: no move
    """
    J = ev.template_length()
    if j2 == j1 + 1:
        return ev.score_move(j1, j2, obs) if obs else ev.delete(i, j1)
    if j2 == j1:
        jj = min(j1, J - 1)
        return ev.score_move(jj, jj, obs) if obs else -np.inf
    if j2 == j1 + 2:
        return ev.merge(i, j1) if obs else -np.inf
    raise ValueError("moves advance the template by 0, 1 or 2")


def edna_fill(ev: EdnaEvaluator) -> tuple[np.ndarray, np.ndarray]:
    """Dense log-space alpha/beta for the Edna pair-HMM.

    alpha[i, j] = log P(first i pulses consumed, positioned at template
    column j); transitions INTO a column carry their emission (score_move
    semantics), so beta[i, j] = log P(remaining pulses | at (i, j)) with
    the arrival emission excluded -- exactly the decomposition
    EdnaCounts.DoCount sums over (alpha(i,j1) + ScoreMove(j1,j2,obs) +
    beta(i',j2))."""
    I, J = ev.read_length(), ev.template_length()
    obs = ev.channels
    alpha = np.full((I + 1, J + 1), -np.inf)
    alpha[0, 0] = 0.0
    for j in range(J + 1):
        for i in range(I + 1):
            if i == 0 and j == 0:
                continue
            acc = -np.inf
            if j >= 1 and i >= 1:          # move consuming a pulse
                acc = np.logaddexp(acc, alpha[i - 1, j - 1]
                                   + _transition(ev, i - 1, j - 1, j,
                                                 int(obs[i - 1])))
            if j >= 1:                     # move consuming a dark
                acc = np.logaddexp(acc, alpha[i, j - 1]
                                   + _transition(ev, i, j - 1, j, 0))
            if i >= 1:                     # stay emitting a pulse
                acc = np.logaddexp(acc, alpha[i - 1, j]
                                   + _transition(ev, i - 1, j, j,
                                                 int(obs[i - 1])))
            if j >= 2 and i >= 1:          # merge (2-column move)
                acc = np.logaddexp(acc, alpha[i - 1, j - 2]
                                   + _transition(ev, i - 1, j - 2, j,
                                                 int(obs[i - 1])))
            alpha[i, j] = acc

    beta = np.full((I + 1, J + 1), -np.inf)
    beta[I, J] = 0.0
    for j in range(J, -1, -1):
        for i in range(I, -1, -1):
            if i == I and j == J:
                continue
            acc = -np.inf
            if j < J and i < I:
                acc = np.logaddexp(acc, beta[i + 1, j + 1]
                                   + _transition(ev, i, j, j + 1, int(obs[i])))
            if j < J:
                acc = np.logaddexp(acc, beta[i, j + 1]
                                   + _transition(ev, i, j, j + 1, 0))
            if i < I:
                acc = np.logaddexp(acc, beta[i + 1, j]
                                   + _transition(ev, i, j, j, int(obs[i])))
            if j + 2 <= J and i < I:
                acc = np.logaddexp(acc, beta[i + 1, j + 2]
                                   + _transition(ev, i, j, j + 2, int(obs[i])))
            beta[i, j] = acc
    return alpha, beta


def edna_counts(ev: EdnaEvaluator, alpha: np.ndarray, beta: np.ndarray,
                j1: int, j2: int) -> np.ndarray:
    """(5,) log-space posterior transition masses from template column j1 to
    j2, split by observed channel (0 = dark) -- the training statistic of
    the reference's EdnaCounts::DoCount (EdnaCounts.cpp:68-105):

      results[0]    = logsum_i alpha(i, j1) + ScoreMove(j1, j2, 0)
                                            + beta(i, j2)
      results[base] = logsum_i alpha(i, j1) + ScoreMove(j1, j2, base)
                                            + beta(i+1, j2)
    """
    I = ev.read_length()
    results = np.full(5, -np.inf)
    for i in range(I + 1):
        results[0] = np.logaddexp(
            results[0], alpha[i, j1] + _transition(ev, i, j1, j2, 0)
            + beta[i, j2])
    for i in range(I):
        base = int(ev.channels[i])
        results[base] = np.logaddexp(
            results[base], alpha[i, j1] + _transition(ev, i, j1, j2, base)
            + beta[i + 1, j2])
    return results

