"""The port's off-path models and aligners against pbccs_tpu's, on the
same seeded numpy inputs (tests/test_align.py and
tests/test_aux_models.py are the JAX package's own tests of them).

Tolerances: the numpy copies (utils.statistics, utils.coverage, align.*,
ops.fwdbwd_ref, models.diploid, models.edna, the Quiver recursor's host
DPs viterbi_alignment and dense_loglik) are held EXACT -- the same
arithmetic on the same inputs.  score_read (K1's plain version on the
CPU) and score_read_quiver (K2's plain version) are held to the fills'
contract, 1e-4 absolute on the log-likelihood (fwdbwd_pallas.py:45-47),
against pbccs_tpu's pure-JAX forward fills."""

import numpy as np
import pytest
import torch

import pbccs_tpu.align as jalign
import pbccs_tpu.models.diploid as jdip
import pbccs_tpu.models.edna as jedna
import pbccs_tpu.ops.fwdbwd_ref as jref
import pbccs_tpu.utils.coverage as jcov
import pbccs_tpu.utils.statistics as jstat
from pbccs_tpu.align.linear import align_linear_score as j_lin_score
from pbccs_tpu.align.pairwise import align_score as j_score
from pbccs_tpu.models.quiver.features import QvSequenceFeatures as JFeat
from pbccs_tpu.models.quiver.params import QvModelParams as JQvParams
from pbccs_tpu.models.quiver.recursor import (dense_loglik as j_dense,
                                              viterbi_alignment as j_viterbi)
from pbccs_tpu.models.readscorer import (score_read as j_score_read,
                                         score_read_quiver as j_score_quiver)

import pbccs_tpu_torch.align as talign
import pbccs_tpu_torch.models.diploid as tdip
import pbccs_tpu_torch.models.edna as tedna
import pbccs_tpu_torch.ops.fwdbwd_ref as tref
import pbccs_tpu_torch.utils.coverage as tcov
import pbccs_tpu_torch.utils.statistics as tstat
from pbccs_tpu_torch.align.linear import align_linear_score as t_lin_score
from pbccs_tpu_torch.align.pairwise import align_score as t_score
from pbccs_tpu_torch.models.arrow.params import (decode_bases,
                                                 snr_to_transition_table_host,
                                                 template_transition_params)
from pbccs_tpu_torch.models.quiver.features import QvSequenceFeatures as TFeat
from pbccs_tpu_torch.models.quiver.params import QvModelParams as TQvParams
from pbccs_tpu_torch.models.quiver.recursor import (dense_loglik as t_dense,
                                                    viterbi_alignment as
                                                    t_viterbi)
from pbccs_tpu_torch.models.readscorer import (score_read as t_score_read,
                                               score_read_quiver as
                                               t_score_quiver)
from pbccs_tpu_torch.ops.fwdbwd_cuda import (forward_batch,
                                             forward_loglik_batch)
from pbccs_tpu_torch.simulate import simulate_zmw

torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3]
LL_ATOL = 1e-4
BASES = np.array(list("ACGT"))


def _seq(rng, n):
    return "".join(rng.choice(BASES, n))


def _mutated(rng, s, n_edits):
    """s with n_edits random substitutions, insertions and deletions."""
    out = list(s)
    for _ in range(n_edits):
        p = int(rng.integers(0, max(len(out), 1)))
        op = rng.integers(0, 3)
        if op == 0 and out:
            out[p] = str(rng.choice(BASES))
        elif op == 1:
            out.insert(p, str(rng.choice(BASES)))
        elif out:
            del out[p]
    return "".join(out)


def _pair(rng):
    t = _seq(rng, int(rng.integers(5, 60)))
    return t, _mutated(rng, t, int(rng.integers(0, 6)))


def _same_alignment(a, b):
    assert (b.target, b.query) == (a.target, a.query)
    assert b.transcript == a.transcript
    assert b.accuracy == a.accuracy


# ------------------------------------------------------------ utils


@pytest.mark.parametrize("seed", SEEDS)
def test_binomial_survival_matches_jax(seed):
    """Exact: every (q, size, prob) of a seeded grid, as probability and
    as phred."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        size = int(rng.integers(0, 40))
        q = int(rng.integers(-2, size + 2))
        prob = float(rng.random())
        for phred in (False, True):
            assert tstat.binomial_survival(q, size, prob, phred) == \
                jstat.binomial_survival(q, size, prob, phred)
    with pytest.raises(ValueError):
        tstat.binomial_survival(1, -1, 0.5)


@pytest.mark.parametrize("seed", SEEDS)
def test_coverage_matches_jax(seed):
    """Exact: per-position depth and minimum-coverage intervals of random
    read spans in a random window."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 30))
    ts = rng.integers(0, 200, n)
    te = ts + rng.integers(1, 120, n)
    start, length = int(rng.integers(0, 50)), int(rng.integers(1, 250))
    assert np.array_equal(tcov.coverage_in_window(ts, te, start, length),
                          jcov.coverage_in_window(ts, te, start, length))
    for min_cov in (1, 2, 4):
        got = tcov.covered_intervals(min_cov, ts, te, start, length)
        want = jcov.covered_intervals(min_cov, ts, te, start, length)
        assert [(i.left, i.right) for i in got] == \
            [(i.left, i.right) for i in want]


# ------------------------------------------------------------ aligners


@pytest.mark.parametrize("mode", ["GLOBAL", "SEMIGLOBAL", "LOCAL"])
@pytest.mark.parametrize("seed", SEEDS)
def test_pairwise_align_matches_jax(seed, mode):
    """Exact: alignment strings, transcript, accuracy, begin offsets and
    score in each align mode; target_to_query_positions of the
    transcript."""
    rng = np.random.default_rng(seed)
    jcfg = jalign.AlignConfig(jalign.AlignParams(), getattr(jalign, mode))
    tcfg = talign.AlignConfig(talign.AlignParams(), getattr(talign, mode))
    for _ in range(6):
        t, q = _pair(rng)
        a, b = jalign.align(t, q, jcfg), talign.align(t, q, tcfg)
        _same_alignment(a, b)
        assert (b.target_begin, b.query_begin) == (a.target_begin,
                                                   a.query_begin)
        assert t_score(t, q, tcfg) == j_score(t, q, jcfg)
        if mode == "GLOBAL":
            assert np.array_equal(
                talign.target_to_query_positions(b.transcript),
                jalign.target_to_query_positions(a.transcript))


@pytest.mark.parametrize("seed", SEEDS)
def test_affine_align_matches_jax(seed):
    """Exact: affine-gap and IUPAC affine alignments."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        t, q = _pair(rng)
        _same_alignment(jalign.align_affine(t, q), talign.align_affine(t, q))
        iupac = "".join(c if rng.random() > 0.2 else str(rng.choice(
            list("MRWSYKN"))) for c in t)
        _same_alignment(jalign.align_affine_iupac(iupac, q),
                        talign.align_affine_iupac(iupac, q))


@pytest.mark.parametrize("seed", SEEDS)
def test_linear_align_matches_jax(seed):
    """Exact: the linear-memory (Hirschberg) alignment and its score."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        t = _seq(rng, int(rng.integers(1, 150)))
        q = _mutated(rng, t, int(rng.integers(0, 12)))
        _same_alignment(jalign.align_linear(t, q), talign.align_linear(t, q))
        assert t_lin_score(t, q) == j_lin_score(t, q)


def test_pairwise_alignment_representation_matches_jax():
    """Exact: the PairwiseAlignment value type (tests/test_align.py's
    representation cases)."""
    for t, q in (("GATC", "GA-C"), ("GATTA-CA", "CA-TAACA")):
        a, b = jalign.PairwiseAlignment(t, q), talign.PairwiseAlignment(t, q)
        for f in ("length", "matches", "mismatches", "insertions",
                  "deletions", "accuracy", "transcript"):
            assert getattr(b, f) == getattr(a, f), f
    rt = talign.PairwiseAlignment.from_transcript("MMDM", "GATC", "GAC")
    assert (rt.target, rt.query) == ("GATC", "GA-C")
    with pytest.raises(ValueError):
        talign.PairwiseAlignment("A-C", "A-C")


# ------------------------------------------------------------ dense oracle


def _oracle_inputs(rng):
    tpl, reads, _, snr = simulate_zmw(rng, int(rng.integers(15, 40)), 2)
    table = snr_to_transition_table_host(np.asarray(snr, np.float64))
    trans = template_transition_params(
        torch.as_tensor(tpl)[None], torch.as_tensor(table)[None],
        torch.tensor([len(tpl)]))[0].double().numpy()
    return reads[0], tpl, trans


@pytest.mark.parametrize("seed", SEEDS)
def test_dense_oracle_matches_jax(seed):
    """Exact: the float64 dense alpha/beta fills (values and log-scales)
    and both log-likelihoods."""
    read, tpl, trans = _oracle_inputs(np.random.default_rng(seed))
    for name in ("fill_alpha_dense", "fill_beta_dense"):
        got = getattr(tref, name)(read, tpl, trans)
        want = getattr(jref, name)(read, tpl, trans)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), name
    for name in ("loglik_dense", "loglik_dense_bwd"):
        assert getattr(tref, name)(read, tpl, trans) == \
            getattr(jref, name)(read, tpl, trans)


@pytest.mark.parametrize("seed", SEEDS)
def test_banded_fill_matches_dense_oracle(seed):
    """The port's banded forward fill (K1's plain version on the CPU)
    against the port's float64 oracle, with a band wider than the read:
    1e-4 absolute on the log-likelihood (the fill contract)."""
    read, tpl, trans = _oracle_inputs(np.random.default_rng(seed))
    jmax = len(tpl)
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)[None]  # noqa: E731
    alpha = forward_batch(t(read, torch.int8), t(len(read), torch.int32)[0:1],
                          t(tpl, torch.int8), t(trans, torch.float32),
                          t(jmax, torch.int32)[0:1], 64)
    ll = float(forward_loglik_batch(alpha, torch.tensor([len(read)]),
                                    torch.tensor([jmax]))[0])
    assert abs(ll - tref.loglik_dense(read, tpl, trans)) <= LL_ATOL


# ------------------------------------------------------------ diploid, Edna


@pytest.mark.parametrize("seed", SEEDS)
def test_diploid_matches_jax(seed):
    """Exact: homozygous and heterozygous site log-likelihoods, the read
    assignment and the het call on seeded site score matrices (half of
    them planted heterozygous)."""
    rng = np.random.default_rng(seed)
    for k in range(6):
        n = int(rng.integers(2, 12))
        s = rng.normal(-20.0, 5.0, (n, 9))
        if k % 2:
            s[: n // 2, 0] = 0.0
            s[n // 2:, int(rng.choice([1, 2, 3]))] = 0.0
        assert tdip.homozygous_loglik(s) == jdip.homozygous_loglik(s)
        assert tdip.heterozygous_loglik(s) == jdip.heterozygous_loglik(s)
        assert np.array_equal(tdip.assign_reads_to_alleles(s, 0, 2),
                              jdip.assign_reads_to_alleles(s, 0, 2))
        for prior in (0.0, -3.0):
            a = jdip.is_site_heterozygous(s, prior)
            b = tdip.is_site_heterozygous(s, prior)
            assert (a is None) == (b is None)
            if a is not None:
                assert (b.allele0, b.allele1, b.log_bayes_factor) == \
                    (a.allele0, a.allele1, a.log_bayes_factor)
                assert np.array_equal(b.allele_for_read, a.allele_for_read)


def _edna_params(mod, rng):
    def dists():
        d = rng.random((4, 5)) + 0.05
        return tuple((d / d.sum(1, keepdims=True)).ravel())
    return mod.EdnaModelParams(
        p_stay=tuple(rng.uniform(0.05, 0.3, 4)),
        p_merge=tuple(rng.uniform(0.0, 0.3, 4)),
        move_dists=dists(), stay_dists=dists())


@pytest.mark.parametrize("seed", SEEDS)
def test_edna_matches_jax(seed):
    """Exact: Edna move scores, its dense alpha/beta, the total
    log-likelihood and the per-channel transition counts."""
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    pj, pt = _edna_params(jedna, rng_j), _edna_params(tedna, rng_t)
    tpl = rng_j.integers(1, 5, int(rng_j.integers(4, 12))).astype(np.int32)
    read = rng_j.integers(0, 5, int(rng_j.integers(3, 12))).astype(np.int32)
    ej, et = jedna.EdnaEvaluator(read, tpl, pj), tedna.EdnaEvaluator(read, tpl,
                                                                     pt)
    assert et.loglik() == ej.loglik()
    aj, bj = jedna.edna_fill(ej)
    at, bt = tedna.edna_fill(et)
    assert np.array_equal(at, aj) and np.array_equal(bt, bj)
    for j in range(len(tpl) - 1):
        assert np.array_equal(tedna.edna_counts(et, at, bt, j, j + 1),
                              jedna.edna_counts(ej, aj, bj, j, j + 1))
    for i in range(len(read)):
        for j in range(len(tpl)):
            assert et.merge(i, j) == ej.merge(i, j)
            for obs in range(5):
                assert et.score_move(j, min(j + 1, len(tpl) - 1), obs) == \
                    ej.score_move(j, min(j + 1, len(tpl) - 1), obs)


# ------------------------------------------------------------ Quiver DPs


def _features(rng, tpl, noisy: bool):
    """(JAX, port) QvSequenceFeatures of one read: the template with a
    few edits and random QV tracks (flat tracks when not noisy)."""
    read = np.asarray(list(tpl), np.int8)
    if noisy:
        for _ in range(3):
            p = int(rng.integers(0, len(read)))
            read = np.delete(read, p) if rng.random() < 0.5 else np.insert(
                read, p, rng.integers(0, 4))
    n = len(read)
    qv = (lambda: rng.uniform(0, 20, n).astype(np.float32)) if noisy else \
        (lambda: np.zeros(n, np.float32))
    tracks = [read, qv(), qv(), qv(),
              rng.integers(0, 5, n).astype(np.float32) if noisy
              else np.full(n, 4, np.float32), qv()]
    return JFeat(*tracks), TFeat(*[t.copy() for t in tracks])


@pytest.mark.parametrize("use_merge", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_quiver_host_dps_match_jax(seed, use_merge):
    """Exact: the viterbi alignment's strings and the dense log-space
    log-likelihood, pinned and with free ends."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, int(rng.integers(8, 30))).astype(np.int8)
    fj, ft = _features(rng, tpl, noisy=seed % 2 == 1)
    pj, pt = JQvParams(), TQvParams()
    for pins in ((True, True), (False, True), (True, False)):
        a = j_viterbi(fj, tpl, pj, use_merge, *pins)
        b = t_viterbi(ft, tpl, pt, use_merge, *pins)
        assert (b.target, b.query) == (a.target, a.query)
        assert b.query.replace("-", "") == decode_bases(ft.seq)
        assert t_dense(ft, tpl, pt, use_merge, *pins) == \
            j_dense(fj, tpl, pj, use_merge, *pins)


# ------------------------------------------------------------ ReadScorer


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_read_matches_jax(seed):
    """score_read on the CPU (K1's plain version) against pbccs_tpu's
    (the pure-JAX banded forward): 1e-4 absolute on the log-likelihood,
    for a read of the template and for an unrelated template."""
    rng = np.random.default_rng(seed)
    tpl, reads, _, snr = simulate_zmw(rng, 60, 2)
    other = rng.integers(0, 4, 60).astype(np.int8)
    for t in (tpl, other):
        got = t_score_read(reads[0], t, snr, device="cpu")
        want = j_score_read(reads[0], t, snr)
        assert abs(got - want) <= LL_ATOL, (got, want)
    assert t_score_read(reads[0], tpl, snr, device="cpu") > \
        t_score_read(reads[0], other, snr, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_read_quiver_matches_jax(seed):
    """score_read_quiver on the CPU (K2's plain version) against
    pbccs_tpu's (the pure-JAX quiver_forward): 1e-4 absolute on the
    log-likelihood, with flat (even seeds) and random (odd) QV tracks."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, 50).astype(np.int8)
    other = rng.integers(0, 4, 50).astype(np.int8)
    fj, ft = _features(rng, tpl, noisy=seed % 2 == 1)
    for t in (tpl, other):
        got = t_score_quiver(ft, t, device="cpu")
        want = j_score_quiver(fj, t)
        assert abs(got - want) <= LL_ATOL, (got, want)
