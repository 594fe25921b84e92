"""The repository's configurations (BASELINE.json "configs" 2-4, bench.py's
SWEEP_CONFIGS) in the port against the JAX package on the CPU.

chip_smoke.py phase 19 runs them on the card at full geometry: 4 ZMWs of
15 kb x 3 passes in one batch (cfg3), 64 ZMWs of 500 bp x 30 passes in
batches of 32 (cfg4), one batch of 1,024 ZMWs of 2 kb x 3-10 passes
(config 2).  Here, inputs made from a numpy seed:

* the shapes each geometry polishes at (the pure bucket, band-width and
  guided-pass functions) equal pbccs_tpu's, and are the ones the card
  runs (Jmax past 8 kb with three guided passes; R = 32; Z = 1,024);
* one ZMW at cfg4's geometry through both packages' process_chunks: the
  same tally and sequence, QVs within 1, the port at R = 32;
* PBCCS_GUIDED=3, cfg3's count of guided refills, on a drifted 300 bp
  ZMW at a band of 32 (the full 15 kb polish is too slow for the CPU):
  statuses, baselines within 1e-4, consensus and QVs within 1 of
  pbccs_tpu's.

Also: the port's Quiver package re-exports pbccs_tpu's names but the
per-read recursors, and its bulk read sampler draws from the same model
as the per-base one."""

import numpy as np
import pytest
import torch

import pbccs_tpu.models.arrow.params as jparams
import pbccs_tpu.models.arrow.scorer as jscorer
import pbccs_tpu.parallel.batch as jbatch
import pbccs_tpu.pipeline as jpipe

import pbccs_tpu_torch.models.arrow.params as tparams
import pbccs_tpu_torch.models.arrow.scorer as tscorer
import pbccs_tpu_torch.parallel.batch as tbatch
import pbccs_tpu_torch.pipeline as tpipe
from pbccs_tpu_torch import simulate as tsim

torch.set_num_threads(1)

QV_ATOL = 1

#: (ZMWs, template length, (min, max) passes) of bench.py's cfg3_15kb_3p,
#: cfg4_30px500bp (one batch of 32) and cfg2_2kb_3-10p (one batch of 1,024)
GEOMETRIES = {"cfg3": (4, 15_000, (3, 3)), "cfg4": (32, 500, (30, 30)),
              "cfg2": (1024, 2000, (3, 10))}


def _geometry(n, tpl_len, passes, seed=11):
    """(max reads, max read length, max template length) of a draw."""
    rng = np.random.default_rng(seed)
    reads, tpls = 0, 0
    rlen = 0
    for _ in range(n):
        npass = int(rng.integers(passes[0], passes[1] + 1))
        tpl, rs, _, _ = tsim.simulate_zmw_bulk(rng, tpl_len, npass)
        reads = max(reads, len(rs))
        rlen = max(rlen, max(len(r) for r in rs))
        tpls = max(tpls, len(tpl))
    return reads, rlen, tpls


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_config_shapes_match_jax(monkeypatch, name):
    for var in ("PBCCS_GUIDED", "PBCCS_BAND_W"):
        monkeypatch.delenv(var, raising=False)
    n, tpl_len, passes = GEOMETRIES[name]
    reads, rlen, tlen = _geometry(n, tpl_len, passes)
    # a 3-pass POA draft of a 15 kb template ran 8% long (16,203 bp)
    drafts = (tlen, int(tlen * 1.08)) if name == "cfg3" else (tlen,)
    for draft in drafts:
        mine = tbatch.effective_shapes(n, reads, rlen, draft)
        ref = jbatch.effective_shapes(n, reads, rlen, draft)
        assert mine == ref
        assert tbatch.length_bucket(draft, rlen) == \
            jbatch.length_bucket(draft, rlen)
        imax, jmax, R, Z = mine
        W = tparams.effective_band_width(tparams.BandingOptions(), jmax)
        assert W == jparams.effective_band_width(jparams.BandingOptions(),
                                                 jmax)
        # the 2x band retry's width
        assert tparams.effective_band_width(
            tparams.BandingOptions(band_width=2 * W), jmax) == \
            jparams.effective_band_width(
                jparams.BandingOptions(band_width=2 * W), jmax) == 2 * W
        assert tscorer.guided_fill_passes(jmax) == \
            jscorer.guided_fill_passes(jmax)
        # a capacity split's half, pinned to the parent's (Imax, Jmax, R)
        half = n // 2 or 1
        assert tbatch.effective_shapes(
            half, reads, rlen, draft, buckets=(imax, jmax, R, half)) == \
            jbatch.effective_shapes(half, reads, rlen, draft,
                                    buckets=(imax, jmax, R), min_z=half)
        # the shapes phase 19 requires of the card's run
        assert Z == n
        if name == "cfg3":
            assert jmax > 8192 and tscorer.guided_fill_passes(jmax) == 3
            assert (W, R) == (96, 4)
        elif name == "cfg4":
            assert (W, R) == (64, 32)
        else:
            assert (W, R) == (96, 12)


def _chunk_pair(seed, tpl_len, passes):
    rng = np.random.default_rng(seed)
    _, reads, _, snr = tsim.simulate_zmw(rng, tpl_len, passes)
    ids = [f"m/0/{i}" for i in range(len(reads))]
    return (jpipe.Chunk("m/0", [jpipe.Subread(i, r)
                                for i, r in zip(ids, reads)], snr),
            tpipe.Chunk("m/0", [tpipe.Subread(i, r)
                                for i, r in zip(ids, reads)], snr))


def test_thirty_pass_zmw_matches_jax(monkeypatch):
    jc, tc = _chunk_pair(4, 500, 30)
    rows = []
    setup = tbatch.BatchPolisher._setup

    def note(pol):
        rows.append(pol._R)
        return setup(pol)

    monkeypatch.setattr(tbatch.BatchPolisher, "_setup", note)
    ref = jpipe.process_chunks([jc])
    mine = tpipe.process_chunks([tc], device="cpu")
    assert rows and set(rows) == {32}
    assert {f.value: c for f, c in ref.counts.items()} == \
        {f.value: c for f, c in mine.counts.items()}
    assert mine.counts[tpipe.Failure.SUCCESS] == 1
    a, b = ref.results[0], mine.results[0]
    assert a.sequence == b.sequence
    assert a.num_passes == b.num_passes == 30
    assert len(a.qvs) == len(b.qvs)
    assert np.abs(a.qvs.astype(int) - b.qvs.astype(int)).max() <= QV_ATOL


def test_three_guided_passes_match_jax(monkeypatch):
    from test_torch_guided import _drifted_task

    from pbccs_tpu.models.arrow.params import ArrowConfig as JConfig
    from pbccs_tpu.models.arrow.params import BandingOptions as JBanding
    from pbccs_tpu.models.arrow.refine import RefineOptions as JOptions

    from pbccs_tpu_torch.models.arrow.params import ArrowConfig, \
        BandingOptions
    from pbccs_tpu_torch.models.arrow.refine import RefineOptions

    monkeypatch.setenv("PBCCS_GUIDED", "3")
    assert tscorer.guided_fill_passes(2048) == 3
    task = _drifted_task(1)
    ref = jbatch.BatchPolisher([jbatch.ZmwTask(*task)],
                               config=JConfig(banding=JBanding(band_width=32)))
    mine = tbatch.BatchPolisher([tbatch.ZmwTask(*task)], device="cpu",
                                config=ArrowConfig(banding=BandingOptions(
                                    band_width=32)))
    np.testing.assert_array_equal(mine.statuses[0, :5], ref.statuses[0, :5])
    np.testing.assert_allclose(mine.baselines[0, :5], ref.baselines[0, :5],
                               atol=1e-4)
    rr, rm = ref.refine(JOptions()), mine.refine(RefineOptions())
    assert [vars(r) for r in rr] == [vars(r) for r in rm]
    np.testing.assert_array_equal(mine.tpls[0], ref.tpls[0])
    qr, qm = ref.consensus_qvs()[0], mine.consensus_qvs()[0]
    assert len(qr) == len(qm)
    assert np.abs(qr.astype(int) - qm.astype(int)).max() <= QV_ATOL


def test_quiver_package_names_match_jax():
    import pbccs_tpu.models.quiver as jq

    import pbccs_tpu_torch.models.quiver as tq

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not type(getattr(mod, n)).__name__ == "module"}

    per_read = {"quiver_forward", "quiver_backward", "quiver_loglik",
                "quiver_loglik_backward"}
    assert public(tq) == public(jq) - per_read
    from pbccs_tpu_torch.models.quiver import fill
    for name in ("forward_batch", "backward_batch", "quiver_loglik_batch",
                 "quiver_loglik_backward_batch"):
        assert callable(getattr(fill, name))


def test_transition_track_matches_loop():
    rng = np.random.default_rng(3)
    for L in (1, 2, 300):
        tpl, snr = tsim.random_template(rng, L), tsim.random_snr(rng)
        np.testing.assert_allclose(tsim.transition_track(tpl, snr),
                                   tsim.make_transition_track(tpl, snr),
                                   rtol=1e-12, atol=0)


def _read_stats(reads):
    """Per read: length and the count of each emitted base."""
    return np.array([[len(r)] + [int((r == b).sum()) for b in range(4)]
                     for r in reads], float)


@pytest.mark.parametrize("L", [2, 200])
def test_bulk_sampler_matches_per_base_sampler(L):
    """sample_read_bulk draws from sample_read's distribution: the mean
    read length and base counts of 1,000 reads each agree within five
    standard errors, and both pin the read's first and last bases to
    emissions of the template's."""
    rng = np.random.default_rng(L)
    tpl, snr = tsim.random_template(rng, L), tsim.random_snr(rng)
    trans = tsim.make_transition_track(tpl, snr)
    a = _read_stats([tsim.sample_read(rng, tpl, trans)
                     for _ in range(1000)])
    b = _read_stats([tsim.sample_read_bulk(rng, tpl, trans)
                     for _ in range(1000)])
    se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b))
    assert (np.abs(a.mean(0) - b.mean(0)) <= 5 * se + 1e-9).all()
    r = tsim.sample_read_bulk(rng, tpl, trans, pr_miscall=0.0)
    assert r.dtype == np.int8 and r[0] == tpl[0] and r[-1] == tpl[-1]


def test_bulk_zmw_polishes_to_its_template():
    """A simulate_zmw_bulk ZMW through the port's process_chunks on the
    CPU: one Success whose consensus is the template (either strand)."""
    from pbccs_tpu_torch.models.arrow.params import decode_bases, revcomp

    rng = np.random.default_rng(8)
    tpl, reads, strands, snr = tsim.simulate_zmw_bulk(rng, 150, 8)
    assert strands == [k % 2 for k in range(8)]
    chunk = tpipe.Chunk("b/0", [tpipe.Subread(f"b/0/{i}", r)
                                for i, r in enumerate(reads)], snr)
    tally = tpipe.process_chunks([chunk], device="cpu")
    assert tally.counts[tpipe.Failure.SUCCESS] == 1
    assert tally.results[0].sequence in (decode_bases(tpl),
                                         decode_bases(revcomp(tpl)))
