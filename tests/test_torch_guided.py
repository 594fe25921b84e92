"""PBCCS_GUIDED, the argmax-guided refill count, in the port against the
JAX package.

Both packages read the variable as an integer pass count clamped at 0,
and without it follow the same schedule by template bucket.  The polish
test drives one ZMW whose first read drifts off the band's diagonal
(24 inserted bases in its first half) at a band of 32, where one guided
refill moves that read's log-likelihood by ~0.02 nats: with the
variable at 1 the port and the JAX package (host loop, as tier-1 runs
it) agree on the statuses, the baselines within 1e-4 absolute, the
refinement, the consensus, and the QVs within 1."""

import numpy as np
import pytest
import torch

from pbccs_tpu.models.arrow import scorer as jscorer

from pbccs_tpu_torch.models.arrow import scorer as tscorer

torch.set_num_threads(1)


@pytest.mark.parametrize("env", [None, "0", "1", "3", "-2"])
@pytest.mark.parametrize("jmax", [2048, 4096, 10240])
def test_guided_fill_passes_matches_jax(monkeypatch, env, jmax):
    if env is None:
        monkeypatch.delenv("PBCCS_GUIDED", raising=False)
    else:
        monkeypatch.setenv("PBCCS_GUIDED", env)
    assert tscorer.guided_fill_passes(jmax) == \
        jscorer.guided_fill_passes(jmax)


def _drifted_task(seed: int):
    from pbccs_tpu_torch.simulate import simulate_zmw

    rng = np.random.default_rng(seed)
    tpl, reads, strands, snr = simulate_zmw(rng, 300, 5)
    reads = list(reads)
    r = list(reads[0])
    for p in sorted(rng.choice(np.arange(20, len(r) // 2), 12,
                               replace=False))[::-1]:
        r[p:p] = list(rng.integers(0, 4, 2))
    reads[0] = np.array(r, np.int8)
    draft = tpl.copy()
    draft[150] = (draft[150] + 1) % 4
    return ("g/0", draft, snr, reads, list(strands), [0] * 5,
            [len(tpl)] * 5)


def test_guided_polish_matches_jax(monkeypatch):
    from pbccs_tpu.models.arrow.params import ArrowConfig as JConfig
    from pbccs_tpu.models.arrow.params import BandingOptions as JBanding
    from pbccs_tpu.models.arrow.refine import RefineOptions as JOptions
    from pbccs_tpu.parallel.batch import BatchPolisher as JPolisher
    from pbccs_tpu.parallel.batch import ZmwTask as JTask

    from pbccs_tpu_torch.models.arrow.params import ArrowConfig, \
        BandingOptions
    from pbccs_tpu_torch.models.arrow.refine import RefineOptions
    from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask

    monkeypatch.setenv("PBCCS_GUIDED", "1")
    task = _drifted_task(1)
    ref = JPolisher([JTask(*task)],
                    config=JConfig(banding=JBanding(band_width=32)))
    mine = BatchPolisher([ZmwTask(*task)], device="cpu",
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
    assert np.abs(qr.astype(int) - qm.astype(int)).max() <= 1
