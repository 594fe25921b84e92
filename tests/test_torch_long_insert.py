"""The guided long-template fills against the benchmark's plain Arrow
reference (portbench/arrow_ref.py, float64, plain PyTorch, no JAX).

Past 8 kb every fill of the port is a diagonal-band forward fill, three
argmax-guided forward refills and a backward fill on the kept alpha's
band (scorer.guided_fill_passes).  Here the same schedule runs at a
narrow band (PBCCS_GUIDED=3, W = 32) on 400 bp reads of which two carry
24 inserted bases in their first half, so their alignment paths drift
off the band's diagonal: the diagonal fill misses a drifted read's path
by tens of nats and the guided refills find it.

Tolerance: the port's float32 fills against the reference's float64
fill over its 256-row band (which holds these paths whole), relative
LL_RTOL of the log-likelihood.  Each column's band values round to
float32 (2^-24 relative) and the column log-scales sum in float64, so
the log-likelihood carries a few float32 roundings of its own size:
~1e-7 relative here.  The same reference computed in bfloat16 (the
correctness check's control, every value rounded to 8 bits of
mantissa) lands 9-20% off and fails it.

The guided counters (ccs_fill_guided_reads_total, _kept_total) count
real reads x guided passes and the refills kept, on the serial scorer
and in the batch polisher, never the batch's padding reads."""

import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import arrow_ref as ar  # noqa: E402
from pbccs_tpu_torch.models.arrow import scorer as tscorer  # noqa: E402
from pbccs_tpu_torch.models.arrow.params import (  # noqa: E402
    ArrowConfig, BandingOptions)
from pbccs_tpu_torch.obs.metrics import default_registry  # noqa: E402
from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask  # noqa: E402
from pbccs_tpu_torch.simulate import simulate_zmw  # noqa: E402

torch.set_num_threads(1)

W = 32
PASSES = 3
#: relative tolerance of a guided fill's log-likelihood (module doc)
LL_RTOL = 1e-6
#: (seed, reads): draws in which the diagonal band misses a drifted read
#: by over a nat and three guided refills find every read's path
DRAWS = [(6, 3), (2, 4)]


def _draw(seed: int, n_reads: int):
    """A 400 bp ZMW whose reads 0 and 1 carry 12 inserted 2-base blocks
    in their first half."""
    rng = np.random.default_rng(seed)
    tpl, reads, strands, snr = simulate_zmw(rng, 400, n_reads)
    reads = [np.asarray(r, np.int8) for r in reads]
    for k in (0, 1):
        r = list(reads[k])
        for p in sorted(rng.choice(np.arange(20, len(r) // 2), 12,
                                   replace=False))[::-1]:
            r[p:p] = list(rng.integers(0, 4, 2))
        reads[k] = np.array(r, np.int8)
    return tpl, reads, list(strands), snr


def _scorer(draw):
    tpl, reads, strands, snr = draw
    return tscorer.ArrowMultiReadScorer(
        tpl, snr, reads, strands, [0] * len(reads), [len(tpl)] * len(reads),
        config=ArrowConfig(banding=BandingOptions(band_width=W)),
        device="cpu")


def _fill(sc, passes):
    return tscorer.fill_alpha_beta_batch(sc._reads_dev, sc._rlens_dev,
                                         sc.win_tpl, sc.win_trans, sc.wlens,
                                         W, passes)


def _reference(sc, draw, arith):
    """The reference's forward log-likelihood of each read against its
    oriented window of the template."""
    tpl, reads, _, snr = draw
    L = len(tpl)
    wins = [sc.win_tpl[i, :L].numpy().astype(np.int64)
            for i in range(len(reads))]
    pr = ar.Pairs(reads, wins, [ar.transition_table(snr)] * len(reads),
                  "cpu", arith)
    return ar.fill_alpha(pr)[1].double().numpy()


def _delta(scope, name):
    return scope.delta().get((name, ()), 0.0)


@pytest.mark.parametrize("seed,n_reads", DRAWS)
def test_guided_fills_match_the_plain_reference(seed, n_reads, monkeypatch):
    monkeypatch.setenv("PBCCS_GUIDED", str(PASSES))
    draw = _draw(seed, n_reads)
    sc = _scorer(draw)
    n = n_reads
    want = _reference(sc, draw, ar.F64)
    diag = _fill(sc, 0)
    guided = _fill(sc, PASSES)
    # the premise: the diagonal band misses a drifted read's path
    assert (want - diag.ll_a.double().numpy()[:n]).max() > 1.0
    for got in (guided.ll_a, guided.ll_b):
        np.testing.assert_allclose(got.double().numpy()[:n], want,
                                   rtol=LL_RTOL, atol=0)
    # the control: the reference in bfloat16 fails the same tolerance
    bf16 = _reference(sc, draw, ar.Arith("bfloat16"))
    assert not np.allclose(bf16, want, rtol=LL_RTOL, atol=0)
    assert (np.abs(bf16 - want) > LL_RTOL * np.abs(want)).all()


@pytest.mark.parametrize("seed,n_reads", DRAWS)
def test_guided_counters_count_real_reads_and_kept(seed, n_reads,
                                                   monkeypatch):
    monkeypatch.setenv("PBCCS_GUIDED", str(PASSES))
    draw = _draw(seed, n_reads)
    reg = default_registry()

    scope = reg.scope()
    sc = _scorer(draw)
    assert not sc.band_retried and sc.active[:n_reads].all()
    kept = int(_fill(sc, PASSES).kept[:n_reads].sum())
    assert 0 < kept <= n_reads * PASSES
    assert _delta(scope, "ccs_fill_guided_reads_total") == n_reads * PASSES
    assert _delta(scope, "ccs_fill_guided_kept_total") == kept

    # the batch polisher: its setup's refills and the refine's are counted
    # at the refine's end-of-refine fetch, padding reads (R = 4 holds
    # n_reads) never
    tpl, reads, strands, snr = draw
    task = ZmwTask("li/0", tpl, np.asarray(snr), reads, strands,
                   [0] * n_reads, [len(tpl)] * n_reads)
    scope = reg.scope()
    pol = BatchPolisher([task], device="cpu",
                        config=ArrowConfig(banding=BandingOptions(
                            band_width=W)))
    assert pol._R == 4
    assert pol.statuses[0, :n_reads].tolist() == [tscorer.ADD_SUCCESS] * \
        n_reads
    assert _delta(scope, "ccs_fill_guided_reads_total") == 0
    setup = pol._grid[0][0].st.guided[:, 0].tolist()
    assert setup == [n_reads * PASSES, kept]
    pol.refine()
    runs = _delta(scope, "ccs_fill_guided_reads_total")
    assert runs >= n_reads * PASSES and runs % (n_reads * PASSES) == 0
    assert kept <= _delta(scope, "ccs_fill_guided_kept_total") <= runs
    assert all(blk.st.guided is None for row in pol._grid for blk in row)
