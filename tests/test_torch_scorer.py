"""The port's serial ArrowMultiReadScorer against the JAX package's.

The same numpy-seeded ZMWs (true template, reads sampled from full and
clipped windows on both strands) go to both scorers on the CPU: the
JAX one scores interior pairs by extend+link and edge pairs by full
refills; the port's reads K3's slot grid (plain version here) for the
interior and refills the edges through K1's plain version.

Tolerances: AddRead statuses, active masks and the band retry equal;
z-scores within 1e-6 relative where |z| >= 1, and within 1e-6
relative or 1e-5 absolute below that, where a relative bound means
little (the fills' 1e-4 log-likelihood contract over sqrt(var) >= 10);
mutation scores
within rtol 1e-4, atol 2e-3 (the dense kernel's contract,
tests/test_dense_score.py); refine_consensus gives the same template,
QVs within 1."""

import numpy as np
import pytest
import torch

from pbccs_tpu.models.arrow import mutations as jmut
from pbccs_tpu.models.arrow.refine import refine_consensus as jrefine
from pbccs_tpu.models.arrow.scorer import ArrowMultiReadScorer as JScorer

from pbccs_tpu_torch.models.arrow import mutations as tmut
from pbccs_tpu_torch.models.arrow.params import revcomp
from pbccs_tpu_torch.models.arrow.refine import refine_consensus
from pbccs_tpu_torch.models.arrow.scorer import ArrowMultiReadScorer
from pbccs_tpu_torch.ops import dense_score_cuda as dsc
from pbccs_tpu_torch.simulate import (make_transition_track, sample_read,
                                      simulate_zmw)

torch.set_num_threads(1)

SCORE_RTOL, SCORE_ATOL = 1e-4, 2e-3
Z_RTOL, Z_ATOL = 1e-6, 1e-5
QV_ATOL = 1

#: (seed, template length, full passes): 100-150 bp, 4-6 passes
DRAWS = [(11, 120, 4), (12, 150, 5), (13, 100, 6)]


def _zmw(seed, L, passes):
    """A ZMW whose reads cover the full template on alternating strands,
    plus one forward read of the window [7, L-5) and one reverse read of
    [4, L-9): their windows put insertions and edits at window ends that
    are not template ends."""
    rng = np.random.default_rng(seed)
    tpl, reads, strands, snr = simulate_zmw(rng, L, passes)
    reads, strands = list(reads), list(strands)
    ts, te = [0] * len(reads), [L] * len(reads)
    for strand, (a, b) in ((0, (7, L - 5)), (1, (4, L - 9))):
        win = tpl[a:b] if strand == 0 else revcomp(tpl)[L - b:L - a]
        reads.append(sample_read(rng, win, make_transition_track(win, snr)))
        strands.append(strand)
        ts.append(a)
        te.append(b)
    return tpl, snr, reads, strands, ts, te


@pytest.fixture(scope="module", params=DRAWS, ids=lambda d: f"seed{d[0]}")
def pair(request):
    tpl, snr, reads, strands, ts, te = _zmw(*request.param)
    args = (tpl, snr, reads, strands, ts, te)
    return (JScorer(*args, min_zscore=-5.0),
            ArrowMultiReadScorer(*args, min_zscore=-5.0, device="cpu"))


def _assert_gates(ref, mine):
    np.testing.assert_array_equal(mine.statuses, ref.statuses)
    np.testing.assert_array_equal(mine.active, ref.active)
    assert mine.band_retried == ref.band_retried
    assert mine.n_band_retries == ref.n_band_retries
    assert mine._W == ref._W
    _assert_z(mine.zscores, ref.zscores)
    _assert_z(mine.global_zscore(), ref.global_zscore())


def _assert_z(got, want):
    """z within Z_RTOL relative at |z| >= 1; the absolute term only
    below that."""
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    big = np.abs(want) >= 1
    np.testing.assert_allclose(got[big], want[big], rtol=Z_RTOL, atol=0)
    np.testing.assert_allclose(got[~big], want[~big], rtol=Z_RTOL,
                               atol=Z_ATOL)


def test_gates_match_jax(pair):
    ref, mine = pair
    _assert_gates(ref, mine)
    assert mine.active[: mine.n_reads].sum() >= 4


def test_score_mutations_match_jax(pair):
    """Every unique single-base mutation: both strands, the clipped
    windows' ends included."""
    ref, mine = pair
    tpl = ref.tpl
    want = ref.score_mutations(jmut.enumerate_unique(tpl))
    got = mine.score_mutations(tmut.enumerate_unique(tpl))
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_window_end_mutations_match_jax(pair):
    """Insertions at and next to each read's window ends (the edge
    path's geometry) and edits of the first and last window bases."""
    ref, mine = pair
    L = len(ref.tpl)
    muts = set()
    for a, b in zip(ref._tstarts[: ref.n_reads], ref._tends[: ref.n_reads]):
        for q in (a - 1, a, a + 1, a + 2, a + 3, b - 3, b - 2, b - 1, b,
                  b + 1):
            if 0 <= q <= L:
                muts.update(tmut.insertion(int(q), base) for base in range(4))
            if 0 <= q < L:
                muts.add(tmut.deletion(int(q)))
                muts.update(tmut.substitution(int(q), base)
                            for base in range(4) if base != ref.tpl[q])
    muts = sorted(muts)
    jm = [jmut.Mutation(m.start, m.end, m.mtype, m.new_base) for m in muts]
    np.testing.assert_allclose(mine.score_mutations(muts),
                               ref.score_mutations(jm), rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)


def test_interior_and_edge_pairs_partition(pair, monkeypatch):
    """Every active overlapping (read, mutation) pair goes to exactly one
    of the two paths, and every interior pair sits on a window row K3
    scores (not one of the rows {0, 1, 2, J-2 but its insertions, J-1,
    J} that splice_edge_rows hands to the edge programs)."""
    _, mine = pair
    seen = {}

    def interior(int_mask, p_w, pos, slot):
        seen["int"] = int_mask.copy()
        seen["p_w"] = p_w
        return np.zeros(int(int_mask.sum()))

    def edge(er, em, pp, muts):
        seen["edge"] = set(zip(er.tolist(), em.tolist()))
        return np.zeros(len(er))

    monkeypatch.setattr(mine, "_interior_scores", interior)
    monkeypatch.setattr(mine, "_edge_scores", edge)
    muts = tmut.enumerate_unique(mine.tpl)
    mine.score_mutations(muts)
    inter = set(zip(*map(np.ndarray.tolist, np.nonzero(seen["int"]))))
    assert not inter & seen["edge"]
    want = {(r, m) for r in range(mine.n_reads) if mine.active[r]
            for m, mu in enumerate(muts)
            if jmut.read_scores_mutation(mu, mine._tstarts[r],
                                         mine._tends[r])}
    assert inter | seen["edge"] == want
    J = mine._tends - mine._tstarts
    for r, m in inter:
        p, ins = seen["p_w"][r, m], muts[m].mtype == tmut.INSERTION
        assert 3 <= p <= J[r] - 3 or (ins and p == J[r] - 2)
    # the window rows splice_edge_rows keeps from K3 are exactly these
    grid = torch.zeros(1, 40, 9)
    kept = dsc.splice_edge_rows(grid + 1.0, torch.zeros(1, 6, 9),
                                torch.tensor([30]))[0]
    rows = {(p, k) for p in range(31) for k in range(9) if kept[p, k] == 1}
    assert rows == {(p, k) for p in range(31) for k in range(9)
                    if 3 <= p <= 27 or (p == 28 and 4 <= k < 8)}


def test_refine_matches_jax(pair):
    ref, mine = pair
    a = jrefine(ref)
    b = refine_consensus(mine)
    assert a.converged and b.converged
    assert (b.n_applied, b.iterations) == (a.n_applied, a.iterations)
    np.testing.assert_array_equal(mine.tpl, ref.tpl)
    qa, qb = ref.consensus_qvs(), mine.consensus_qvs()
    assert len(qa) == len(qb)
    assert np.abs(qa.astype(int) - qb.astype(int)).max() <= QV_ATOL


def _drifted(rng, read, n_blocks, block):
    r = list(read)
    pos = sorted(rng.choice(np.arange(20, len(r) // 2), n_blocks,
                            replace=False))[::-1]
    for p in pos:
        r[p:p] = list(rng.integers(0, 4, block))
    return np.array(r, np.int8)


def test_band_retry_matches_jax():
    """A read with 40 two-base insertions in its first half fails the
    mating test at W = 64 and mates at the 2x band, in both scorers
    (300 bp: no 100-150 bp draw tried gave a retry that mates more);
    then every mutation of a slice of the template scores alike."""
    rng = np.random.default_rng(1)
    tpl, reads, strands, snr = simulate_zmw(rng, 300, 5)
    reads = list(reads)
    reads[0] = _drifted(rng, reads[0], 40, 2)
    L = len(tpl)
    args = (tpl, snr, reads, strands, [0] * 5, [L] * 5)
    ref = JScorer(*args, min_zscore=-5.0)
    mine = ArrowMultiReadScorer(*args, min_zscore=-5.0, device="cpu")
    assert ref.band_retried and ref._W == 128
    _assert_gates(ref, mine)
    muts = [m for m in tmut.enumerate_unique(tpl) if m.start % 5 == 0
            or m.start > L - 6]
    jm = [jmut.Mutation(m.start, m.end, m.mtype, m.new_base) for m in muts]
    np.testing.assert_allclose(mine.score_mutations(muts),
                               ref.score_mutations(jm), rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)


def test_mutation_helpers_match_jax():
    rng = np.random.default_rng(3)
    tpl = rng.integers(0, 4, 40).astype(np.int8)
    L = len(tpl)
    for m in tmut.enumerate_unique(tpl):
        jm = jmut.Mutation(m.start, m.end, m.mtype, m.new_base)
        rc, jrc = (tmut.reverse_complement_mutation(m, L),
                   jmut.reverse_complement_mutation(jm, L))
        assert (rc.start, rc.end, rc.mtype, rc.new_base) == \
            (jrc.start, jrc.end, jrc.mtype, jrc.new_base)
        assert tmut.mutation_slot(m.mtype, m.new_base) == (
            m.new_base if m.mtype == tmut.SUBSTITUTION
            else 4 + m.new_base if m.mtype == tmut.INSERTION else 8)


def test_make_patches_match_jax():
    """The template-frame patches equal make_patches_fast's, the
    template ends included."""
    import jax.numpy as jnp

    from pbccs_tpu.models.arrow.params import \
        snr_to_transition_table_host as jtable
    from pbccs_tpu.models.arrow.params import template_transition_params
    from pbccs_tpu.ops.mutation_score import make_patches_fast

    from pbccs_tpu_torch.ops.mutation_score import make_patches

    rng = np.random.default_rng(4)
    L, Lm = 50, 64
    tpl = np.full(Lm, 4, np.int8)
    tpl[:L] = rng.integers(0, 4, L)
    table = jtable(np.array([7.0, 9.0, 5.5, 8.0])).astype(np.float32)
    trans = np.array(template_transition_params(
        jnp.asarray(tpl), jnp.asarray(table), L))
    muts = tmut.enumerate_unique(tpl[:L])
    pos = np.array([m.start for m in muts], np.int32)
    mtype = np.array([m.mtype for m in muts], np.int32)
    base = np.array([max(m.new_base, 0) for m in muts], np.int32)
    want = make_patches_fast(jnp.asarray(tpl, jnp.int32), jnp.asarray(trans),
                             jnp.asarray(table), L, jnp.asarray(pos),
                             jnp.asarray(mtype), jnp.asarray(base))
    got = make_patches(torch.as_tensor(tpl), torch.as_tensor(trans),
                       torch.as_tensor(table), L, torch.as_tensor(pos),
                       torch.as_tensor(mtype), torch.as_tensor(base))
    np.testing.assert_array_equal(got.bases.numpy(), np.asarray(want.bases))
    np.testing.assert_array_equal(got.shift.numpy(), np.asarray(want.shift))
    np.testing.assert_array_equal(got.trans.numpy(), np.asarray(want.trans))
