"""Refinement options, results and the favorability rule.

Port of the pieces of pbccs_tpu.models.arrow.refine the lockstep device
loop uses (reference AbstractRefineConsensus, Consensus-inl.hpp:160-245).
Favorable = score above a noise floor that scales with the summed
|baseline| log-likelihood (the f32 rounding on a mutation delta grows
with it) -- a documented deviation from the reference's fixed +0.04-nat
threshold (MultiReadMutationScorer.cpp:56), kept identical to the JAX
package so both select the same mutations."""

from __future__ import annotations

import dataclasses

import numpy as np


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


def predicted_accuracy(qvs: np.ndarray) -> float:
    """1 - mean per-base error probability, in float64 on the host
    (reference Consensus.h:506-512)."""
    if len(qvs) == 0:
        return 0.0
    return float(1.0 - np.power(10.0, np.asarray(qvs) / -10.0).mean())
