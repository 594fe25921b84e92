"""Consensus refinement: options, results, the favorability rule, and
the generic host-driven refine loop and QV sweep.

Port of pbccs_tpu.models.arrow.refine (reference AbstractRefineConsensus
and ConsensusQVs, Consensus-inl.hpp:160-297).  The lockstep device loop
(parallel.device_refine) uses the options and the favorability rule;
refine_consensus and consensus_qvs are generic over a scorer that offers
`tpl`, `baselines`, `active`, `score_mutations` and `apply_mutations`
(the Quiver scorer, models.quiver.scorer), as the reference templates
them over both scorer families (Consensus.hpp:64-79).

Favorable = score above a noise floor that scales with the summed
|baseline| log-likelihood (the f32 rounding on a mutation delta grows
with it) -- a documented deviation from the reference's fixed +0.04-nat
threshold (MultiReadMutationScorer.cpp:56), kept identical to the JAX
package so both select the same mutations."""

from __future__ import annotations

import dataclasses

import numpy as np

from pbccs_tpu_torch.models.arrow import mutations as mutlib


@dataclasses.dataclass(frozen=True)
class RefineOptions:
    """Defaults: reference Consensus.hpp:55-61."""

    max_iterations: int = 40
    mutation_separation: int = 10
    mutation_neighborhood: int = 20


@dataclasses.dataclass
class RefineResult:
    converged: bool
    n_tested: int = 0
    n_applied: int = 0
    iterations: int = 0


#: Relative f32 score-noise floor for favorability (pbccs_tpu's value).
FAVORABILITY_NOISE_FLOOR = 2.5e-6


def favorability_threshold(abs_baseline_sum):
    """Minimum score a mutation must beat to count as favorable (works on
    floats, numpy arrays and tensors alike)."""
    return FAVORABILITY_NOISE_FLOOR * abs_baseline_sum


def refine_consensus(scorer, opts: RefineOptions | None = None
                     ) -> RefineResult:
    """Iteratively apply favorable mutations until none remain
    (converged) or the iteration budget runs out (non-convergent).

    Round 0 scores every unique single-base mutation, later rounds the
    neighbourhood of the previous round's favorable ones; the greedy
    well-separated best subset is applied, and a multi-mutation subset
    whose result was already visited is trimmed to its best single
    mutation (cycle avoidance, Consensus-inl.hpp:229-241; a repeated
    template does not end the loop)."""
    opts = opts or RefineOptions()
    res = RefineResult(converged=False)
    tpl_history: set[bytes] = set()
    favorable: list[mutlib.Mutation] = []

    for it in range(opts.max_iterations):
        res.iterations = it + 1
        if it == 0:
            muts = mutlib.enumerate_unique(scorer.tpl)
        else:
            muts = mutlib.unique_nearby_mutations(scorer.tpl, favorable,
                                                  opts.mutation_neighborhood)
        res.n_tested += len(muts)
        scores = scorer.score_mutations(muts)
        eps = favorability_threshold(
            float(np.abs(scorer.baselines[scorer.active]).sum()))
        favorable = [m.with_score(s) for m, s in zip(muts, scores) if s > eps]
        if not favorable:
            res.converged = True
            break

        best = mutlib.best_subset(favorable, opts.mutation_separation)
        if len(best) > 1:
            nxt = mutlib.apply_mutations(scorer.tpl, best)
            if nxt.tobytes() in tpl_history:
                best = [max(best, key=lambda m: m.score)]

        res.n_applied += len(best)
        tpl_history.add(scorer.tpl.tobytes())
        scorer.apply_mutations(best)

    return res


def consensus_qvs(scorer) -> np.ndarray:
    """Per-position consensus QVs from a full single-mutation sweep
    against the scorer's current template: per position the summed
    exp(score) of its negative-scoring mutations, through
    mutations.qvs_from_neg_sums (reference ConsensusQVs,
    Consensus-inl.hpp:277-297)."""
    muts = mutlib.enumerate_unique(scorer.tpl)
    scores = np.asarray(scorer.score_mutations(muts), np.float64)
    ssum = np.zeros(len(scorer.tpl))
    neg = scores < 0.0
    starts = np.asarray([m.start for m in muts], np.int64)
    np.add.at(ssum, starts[neg], np.exp(scores[neg]))
    return mutlib.qvs_from_neg_sums(ssum)


def predicted_accuracy(qvs: np.ndarray) -> float:
    """1 - mean per-base error probability, in float64 on the host
    (reference Consensus.h:506-512)."""
    if len(qvs) == 0:
        return 0.0
    return float(1.0 - np.power(10.0, np.asarray(qvs) / -10.0).mean())
