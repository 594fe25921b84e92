"""The PyTorch port's Quiver path against the JAX package, on the CPU.

The same numpy-seeded inputs go through both packages: the K2 fills'
coefficient precompute + plain scan against the JAX Pallas fills
(interpret mode, as tests/test_quiver_pallas.py runs them) and the JAX
banded recursor; the host mutation algebra; QuiverMultiReadScorer and
the generic refine loop over it (process_chunks end to end is in
test_torch_quiver_pipeline.py).

Tolerances: fill cells rtol 2e-4 / atol 2e-5 and log-likelihoods within
1e-4 of the Pallas fills (same recurrence and association; exp() and
the reductions round differently); against the recursor the
test_quiver_pallas tolerances (cells as above, LL 1e-2: another scan
association); mutation scores within 2e-3 (sums over reads of
differences of ~1e2-nat LLs); refinement results equal, QVs within 1."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbccs_tpu.models.arrow import mutations as jmut
from pbccs_tpu.models.quiver import ALL_MOVES, BASIC_MOVES
from pbccs_tpu.models.quiver.params import BandingOptions, QuiverConfig
from pbccs_tpu.models.quiver.pallas_fill import (pallas_quiver_backward_batch,
                                                 pallas_quiver_forward_batch,
                                                 quiver_loglik_batch)
from pbccs_tpu.models.quiver.recursor import (QuiverFeatureArrays,
                                              feature_arrays, quiver_backward,
                                              quiver_forward, quiver_loglik,
                                              quiver_loglik_backward)
from pbccs_tpu.models.quiver.scorer import QuiverMultiReadScorer

from pbccs_tpu_torch import convert
from pbccs_tpu_torch.models.arrow import mutations as tmut
from pbccs_tpu_torch.models.arrow import refine as trefine
from pbccs_tpu_torch.models.quiver import fill as tfill
from pbccs_tpu_torch.models.quiver import params as tparams
from pbccs_tpu_torch.models.quiver.features import QvSequenceFeatures
from pbccs_tpu_torch.models.quiver.scorer import \
    QuiverMultiReadScorer as TScorer
from pbccs_tpu_torch.ops import fwdbwd_cuda as fc

from test_quiver import _random_features

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

QV_ATOL = 1


def _fixture(rng, n=6, Imax=128, Jmax=64):
    """test_quiver_pallas's draw: n random templates of 8..59 bases with
    noisy QV-feature reads, padded to (Imax, Jmax)."""
    fas, feats, tpls, tlens, rlens = [], [], [], [], []
    for _ in range(n):
        J = int(rng.integers(8, 60))
        tpl = rng.integers(0, 4, J).astype(np.int8)
        feat = _random_features(rng, tpl)
        feats.append(feat)
        fas.append(feature_arrays(feat, Imax))
        wpad = np.full(Jmax, 4, np.int8)
        wpad[:J] = tpl
        tpls.append(wpad)
        tlens.append(J)
        rlens.append(len(feat))
    stacked = QuiverFeatureArrays(*(np.stack([np.asarray(getattr(f, k))
                                              for f in fas])
                                    for k in QuiverFeatureArrays._fields))
    return fas, stacked, np.stack(tpls), np.asarray(tlens, np.int32), \
        np.asarray(rlens, np.int32)


def _port_fills(stacked, tpls, tlens, rlens, cfg, W):
    tcfg = convert.quiver_config_from_jax(cfg)
    feat = convert.quiver_features_from_numpy(stacked)
    t = torch.as_tensor
    a = tfill.forward_batch(feat, t(rlens), t(tpls), t(tlens), tcfg, W)
    b = tfill.backward_batch(feat, t(rlens), t(tpls), t(tlens), tcfg, W)
    return (a, b, tfill.quiver_loglik_batch(a, t(rlens), t(tlens)).numpy(),
            tfill.quiver_loglik_backward_batch(b, t(tlens)).numpy())


def _jax_ll_b(beta, r, J):
    return float(np.log(max(beta.vals[r, 0, 0], 1e-30))
                 + np.where(np.arange(beta.log_scales.shape[1]) <= J,
                            np.asarray(beta.log_scales[r]), 0.0).sum())


@pytest.mark.parametrize("moves", [BASIC_MOVES, ALL_MOVES])
def test_fills_match_jax_pallas_and_recursor(moves):
    rng = np.random.default_rng(20260731)
    W = 48
    cfg = QuiverConfig(moves_available=moves,
                       banding=BandingOptions(band_width=W))
    fas, stacked, tpls, tlens, rlens = _fixture(rng)
    jfeat = QuiverFeatureArrays(*(jnp.asarray(x) for x in stacked))
    ja = pallas_quiver_forward_batch(jfeat, jnp.asarray(rlens),
                                     jnp.asarray(tpls), jnp.asarray(tlens),
                                     cfg, W)
    jb = pallas_quiver_backward_batch(jfeat, jnp.asarray(rlens),
                                      jnp.asarray(tpls), jnp.asarray(tlens),
                                      cfg, W)
    jll_a = np.asarray(quiver_loglik_batch(ja, jnp.asarray(rlens),
                                           jnp.asarray(tlens)))
    a, b, ll_a, ll_b = _port_fills(stacked, tpls, tlens, rlens, cfg, W)
    np.testing.assert_array_equal(a.offsets.numpy(), np.asarray(ja.offsets))
    for r in range(len(fas)):
        J = int(tlens[r])
        for got, want in ((a, ja), (b, jb)):
            np.testing.assert_allclose(got.vals[r, : J + 1].numpy(),
                                       np.asarray(want.vals[r, : J + 1]),
                                       rtol=2e-4, atol=2e-5)
        assert abs(ll_a[r] - jll_a[r]) < 1e-4
        assert abs(ll_b[r] - _jax_ll_b(jb, r, J)) < 1e-4

        # the JAX banded recursor: another scan association
        args = (fas[r], jnp.int32(rlens[r]), jnp.asarray(tpls[r]),
                jnp.int32(J), cfg, W)
        ra, rb = quiver_forward(*args), quiver_backward(*args)
        np.testing.assert_allclose(a.vals[r, : J + 1].numpy(),
                                   np.asarray(ra.vals[: J + 1]),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(b.vals[r, : J + 1].numpy(),
                                   np.asarray(rb.vals[: J + 1]),
                                   rtol=2e-4, atol=2e-5)
        assert abs(ll_a[r] - float(quiver_loglik(ra, rlens[r], J))) < 1e-2
        assert abs(ll_b[r] - float(quiver_loglik_backward(rb, J))) < 1e-2


def test_fills_do_not_depend_on_padding():
    """The port sizes a fill batch to its longest window: the same reads
    padded to other Jmax / Imax give the same LLs."""
    rng = np.random.default_rng(5)
    W = 48
    cfg = QuiverConfig(banding=BandingOptions(band_width=W))
    _, stacked, tpls, tlens, rlens = _fixture(rng, n=4)
    jt = int(tlens.max())
    it = int(rlens.max())
    tight = QuiverFeatureArrays(*(x[:, :it] for x in stacked))
    wide = _port_fills(stacked, tpls, tlens, rlens, cfg, W)
    cut = _port_fills(tight, tpls[:, :jt], tlens, rlens, cfg, W)
    for r, J in enumerate(tlens):
        for k in (0, 1):      # alpha, beta cells of the live columns
            assert torch.equal(wide[k].vals[r, : J + 1],
                               cut[k].vals[r, : J + 1])
    # the LLs sum the same column scales, padded with other zero counts
    np.testing.assert_allclose(wide[2], cut[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(wide[3], cut[3], rtol=0, atol=1e-5)


@pytest.mark.parametrize("backward", [False, True])
def test_merge_scan_without_merge_terms_is_the_k1_scan(backward):
    """With cg = 0 the K2 plain scan reduces to the K1 plain scan."""
    rng = np.random.default_rng(11)
    R, nc, W = 3, 20, 16
    cm, cd, cc = (torch.as_tensor(rng.random((R, nc, W)), dtype=torch.float32)
                  for _ in range(3))
    mask = torch.ones(R, nc)
    seed = torch.zeros(R, W)
    seed[:, 0] = 1.0
    col = torch.zeros(R, dtype=torch.int32)
    k1 = fc.fill_scan_plain(cm, cd, cc * 0.1, mask, seed, col, backward)
    k2 = fc.fill_scan_merge_plain(cm, cd, cc * 0.1, torch.zeros_like(cm),
                                  mask, seed, col, backward)
    for x, y in zip(k1, k2):
        assert torch.equal(x, y)


def test_mutation_algebra_matches_jax():
    rng = np.random.default_rng(3)
    for trial in range(5):
        L = int(rng.integers(20, 60))
        tpl = rng.integers(0, 4, L).astype(np.int8)
        tpl[5:9] = tpl[5]
        key = lambda m: (m.start, m.end, m.mtype, m.new_base)  # noqa: E731
        jm = jmut.enumerate_unique(tpl)
        tm = tmut.enumerate_unique(tpl)
        assert [key(m) for m in jm] == [key(m) for m in tm]
        scores = rng.normal(size=len(jm))
        centers = [i for i in rng.choice(len(jm), 4, replace=False)]
        jn = jmut.unique_nearby_mutations(tpl, [jm[i] for i in centers], 6)
        tn = tmut.unique_nearby_mutations(tpl, [tm[i] for i in centers], 6)
        assert [key(m) for m in jn] == [key(m) for m in tn]
        jbest = jmut.best_subset([m.with_score(s) for m, s in zip(jm, scores)],
                                 3 + trial)
        tbest = tmut.best_subset([m.with_score(s) for m, s in zip(tm, scores)],
                                 3 + trial)
        assert [key(m) for m in jbest] == [key(m) for m in tbest]
        np.testing.assert_array_equal(jmut.apply_mutations(tpl, jbest),
                                      tmut.apply_mutations(tpl, tbest))
        np.testing.assert_array_equal(
            jmut.target_to_query_positions(jbest, L),
            tmut.target_to_query_positions(tbest, L))
        ssum = np.where(rng.random(L) < 0.2, 0.0,
                        np.exp(rng.normal(-20, 10, L)))
        np.testing.assert_array_equal(jmut.qvs_from_neg_sums(ssum),
                                      tmut.qvs_from_neg_sums(ssum))


def _scorer_case(seed):
    """A 40-base template with two forward and two reverse reads (one
    clipped to a sub-window) and one junk read that fails the mating
    gate."""
    from pbccs_tpu.models.arrow.params import revcomp

    rng = np.random.default_rng(seed)
    J = 40
    tpl = rng.integers(0, 4, J).astype(np.int8)
    feats = [_random_features(rng, tpl), _random_features(rng, tpl[5:33]),
             _random_features(rng, revcomp(tpl)),
             _random_features(rng, revcomp(tpl)),
             _random_features(rng, rng.integers(0, 4, 90).astype(np.int8))]
    geo = ([0, 0, 1, 1, 0], [0, 5, 0, 0, 0], [J, 33, J, J, J])
    return tpl, feats, geo


def _port_feats(feats):
    return [QvSequenceFeatures(*(np.asarray(getattr(f, k)) for k in
                                 ("seq", "ins_qv", "subs_qv", "del_qv",
                                  "del_tag", "merge_qv"))) for f in feats]


def test_scorer_matches_jax():
    tpl, feats, geo = _scorer_case(8)
    cfg = QuiverConfig(banding=BandingOptions(band_width=48))
    ref = QuiverMultiReadScorer(tpl, feats, *geo, config=cfg)
    mine = TScorer(tpl, _port_feats(feats), *geo,
                   config=convert.quiver_config_from_jax(cfg), device="cpu")
    np.testing.assert_array_equal(mine.statuses, ref.statuses)
    np.testing.assert_array_equal(mine.active, ref.active)
    assert ref.active.sum() >= 3 and not ref.active.all()
    np.testing.assert_allclose(mine.baselines, ref.baselines, atol=1e-4)
    muts = jmut.enumerate_unique(tpl)
    tmuts = tmut.enumerate_unique(tpl)
    np.testing.assert_allclose(mine.score_mutations(tmuts),
                               ref.score_mutations(muts), atol=2e-3)

    # apply + remap: the same windows and the same rebuilt baselines
    best = [jmut.substitution(20, (int(tpl[20]) + 1) % 4),
            jmut.insertion(8, 2), jmut.deletion(30)]
    ref.apply_mutations(best)
    mine.apply_mutations([tmut.Mutation(m.start, m.end, m.mtype, m.new_base)
                          for m in best])
    np.testing.assert_array_equal(mine.tpl, ref.tpl)
    np.testing.assert_array_equal(mine._tstarts, ref._tstarts)
    np.testing.assert_array_equal(mine._tends, ref._tends)
    np.testing.assert_allclose(mine.baselines, ref.baselines, atol=1e-4)
    np.testing.assert_array_equal(mine.active, ref.active)


def test_refine_and_qvs_match_jax():
    """The generic refine loop and QV sweep over both scorers, from a
    draft with a substitution and a deletion."""
    from pbccs_tpu.models.arrow.refine import RefineOptions
    from pbccs_tpu.models.arrow.refine import consensus_qvs as jqvs
    from pbccs_tpu.models.arrow.refine import refine_consensus as jrefine

    tpl, feats, geo = _scorer_case(9)
    draft = tpl.copy()
    draft[12] = (draft[12] + 1) % 4
    draft = np.delete(draft, 25)
    geo = (geo[0], geo[1], [min(e, len(draft)) for e in geo[2]])
    cfg = QuiverConfig(banding=BandingOptions(band_width=48))
    ref = QuiverMultiReadScorer(draft, feats, *geo, config=cfg)
    mine = TScorer(draft, _port_feats(feats), *geo,
                   config=convert.quiver_config_from_jax(cfg), device="cpu")
    rr = jrefine(ref, RefineOptions(max_iterations=8))
    rm = trefine.refine_consensus(mine, trefine.RefineOptions(max_iterations=8))
    assert dataclasses.asdict(rr) == dataclasses.asdict(rm)
    np.testing.assert_array_equal(mine.tpl, ref.tpl)
    assert np.abs(trefine.consensus_qvs(mine).astype(int)
                  - jqvs(ref).astype(int)).max() <= QV_ATOL


def test_config_table_and_features():
    table = tparams.default_quiver_config_table()
    c2 = tparams.QuiverConfig(qv_params=tparams.QvModelParams(chemistry="C2"))
    assert table.insert(c2) and not table.insert(c2)
    assert table.insert_as("XL-C2", c2)
    assert table.at("XL-C2").qv_params.chemistry == "C2"
    assert table.at("P6-C4") == tparams.QuiverConfig()
    assert convert.quiver_config_from_jax(QuiverConfig()) \
        == tparams.QuiverConfig()
    f = QvSequenceFeatures.from_str("ACGTN", ins_qv=[1, 2, 3, 4, 5])
    assert f.seq.tolist() == [0, 1, 2, 3, 4] and len(f) == 5
    assert f.del_tag.tolist() == [4.0] * 5
    with pytest.raises(ValueError):
        QvSequenceFeatures(f.seq, f.ins_qv[:2], f.subs_qv, f.del_qv,
                           f.del_tag, f.merge_qv)
