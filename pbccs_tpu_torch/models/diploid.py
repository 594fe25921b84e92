"""Heterozygous site detection from per-read mutation score matrices.

Parity: Arrow/Quiver Diploid (reference ConsensusCore/src/C++/Arrow/
Diploid.cpp:95-238; the Quiver-namespace copy is identical math): given a
(reads x genotypes) site score matrix whose first column is the no-op
allele, compare Pr(R | hom) = logsumexp_g sum_i S[i,g] against
Pr(R | het) = logsumexp over same-length-diff genotype pairs of
sum_i logaddexp(S[i,g0], S[i,g1]) - I*log2, and call the site heterozygous
when the log Bayes factor beats the prior ratio.

Vectorized over sites as array ops so batches of candidate sites evaluate
in one call (the reference evaluates one site at a time through SWIG).

A copy of pbccs_tpu.models.diploid (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# per-genotype template length deltas for the standard 9-mutation site
# basis: 4 substitutions, 4 insertions, 1 deletion
# (reference Diploid.cpp:97)
LENGTH_DIFFS = np.array([0, 0, 0, 0, 1, 1, 1, 1, -1])


@dataclasses.dataclass
class DiploidSite:
    allele0: int
    allele1: int
    log_bayes_factor: float
    allele_for_read: np.ndarray


def homozygous_loglik(site_scores: np.ndarray) -> float:
    """logsumexp over genotypes of the summed per-read scores
    (Diploid.cpp:122-133)."""
    g_scores = site_scores.sum(axis=0)
    return float(_logsumexp(g_scores))


def heterozygous_loglik(site_scores: np.ndarray,
                        length_diffs: np.ndarray | None = None):
    """logsumexp over valid genotype pairs; returns (ll, allele0, allele1)
    (Diploid.cpp:138-176).  Pairs must have equal template length deltas so
    the het hypothesis compares alleles of the same coordinate frame."""
    ld = LENGTH_DIFFS if length_diffs is None else np.asarray(length_diffs)
    I, G = site_scores.shape
    pair_scores = []
    pairs = []
    for g0 in range(G):
        for g1 in range(g0 + 1, G):
            if ld[g0] != ld[g1]:
                continue
            total = -I * np.log(2.0) + np.logaddexp(
                site_scores[:, g0], site_scores[:, g1]).sum()
            pair_scores.append(total)
            pairs.append((g0, g1))
    if not pairs:
        return -np.inf, -1, -1
    pair_scores = np.asarray(pair_scores)
    best = int(np.argmax(pair_scores))
    return float(_logsumexp(pair_scores)), pairs[best][0], pairs[best][1]


def assign_reads_to_alleles(site_scores: np.ndarray, allele0: int,
                            allele1: int) -> np.ndarray:
    """Per-read hard assignment to the likelier allele (Diploid.cpp:203-212)."""
    return np.where(site_scores[:, allele0] > site_scores[:, allele1], 0, 1)


def is_site_heterozygous(site_scores: np.ndarray, log_prior_ratio: float = 0.0,
                         length_diffs: np.ndarray | None = None) -> DiploidSite | None:
    """Bayes-factor het test (Diploid.cpp:218-238); None if homozygous.

    site_scores: (reads, genotypes) log-likelihood deltas with column 0 the
    no-op allele; log_prior_ratio = log Pr(hom)/Pr(het) >= 0."""
    site_scores = np.asarray(site_scores, np.float64)
    hom = homozygous_loglik(site_scores)
    het, a0, a1 = heterozygous_loglik(site_scores, length_diffs)
    log_bf = het - hom
    if log_bf - log_prior_ratio > 0:
        return DiploidSite(a0, a1, float(log_bf),
                           assign_reads_to_alleles(site_scores, a0, a1))
    return None


def _logsumexp(x: np.ndarray) -> float:
    m = np.max(x)
    if not np.isfinite(m):
        return m
    return m + np.log(np.exp(x - m).sum())
