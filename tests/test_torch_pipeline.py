"""process_chunks of the PyTorch port end to end against the JAX package,
plus the port's device and import contracts.

The same simulated ZMWs (numpy seed) go through both packages on the CPU.
The JAX package runs as tier-1 runs it (its host refinement loop,
tests/conftest.py); one slow test runs it through its device loop with
the TPU arithmetic (dense kernel and Pallas fills, interpret mode).
Contract: identical tallies and consensus sequences, QVs within 1."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pbccs_tpu.pipeline as jpipe

import pbccs_tpu_torch.pipeline as tpipe
from pbccs_tpu_torch.simulate import simulate_zmw

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

QV_ATOL = 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chunks(seed, n, L, passes):
    rng = np.random.default_rng(seed)
    jc, tc = [], []
    for z in range(n):
        _, reads, _, snr = simulate_zmw(rng, L, passes)
        ids = [f"m/{z}/{i}" for i in range(len(reads))]
        jc.append(jpipe.Chunk(f"m/{z}", [jpipe.Subread(i, r)
                                         for i, r in zip(ids, reads)], snr))
        tc.append(tpipe.Chunk(f"m/{z}", [tpipe.Subread(i, r)
                                         for i, r in zip(ids, reads)], snr))
    return jc, tc


def _assert_same(ref, mine):
    assert {f.value: c for f, c in ref.counts.items()} == \
        {f.value: c for f, c in mine.counts.items()}
    a = {r.id: r for r in ref.results}
    b = {r.id: r for r in mine.results}
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert a[k].sequence == b[k].sequence, k
        assert len(a[k].qvs) == len(b[k].qvs)
        assert np.abs(a[k].qvs.astype(int) - b[k].qvs.astype(int)).max() \
            <= QV_ATOL
        assert a[k].num_passes == b[k].num_passes
        assert a[k].status_counts == b[k].status_counts
        np.testing.assert_allclose(b[k].global_zscore, a[k].global_zscore,
                                   atol=1e-3)


@pytest.mark.parametrize("seed,L,passes", [(1234, 150, 5), (99, 200, 4)])
def test_process_chunks_matches_jax_host_loop(seed, L, passes):
    jc, tc = _chunks(seed, 3, L, passes)
    _assert_same(jpipe.process_chunks(jc),
                 tpipe.process_chunks(tc, device="cpu"))


def _drifted(rng, read, n_blocks, block):
    """The read with `n_blocks` random insertions of `block` bases in its
    first half: its alignment path drifts off the band's diagonal."""
    r = list(read)
    pos = sorted(rng.choice(np.arange(20, len(r) // 2), n_blocks,
                            replace=False))[::-1]
    for p in pos:
        r[p:p] = list(rng.integers(0, 4, block))
    return np.array(r, np.int8)


def test_band_retry_matches_jax(caplog):
    """A ZMW whose drifted read fails the mating test at W=64 and mates at
    W=128 is polished in the 2x-band sub-batch, in both packages, with the
    same outcome."""
    import logging

    jc, tc = [], []
    for z in range(2):
        rng = np.random.default_rng(1 + 100 * z)
        _, reads, _, snr = simulate_zmw(rng, 300, 5)
        reads = list(reads)
        if z == 0:
            reads[0] = _drifted(rng, reads[0], 40, 2)
        ids = [f"w/{z}/{i}" for i in range(len(reads))]
        jc.append(jpipe.Chunk(f"w/{z}", [jpipe.Subread(i, r)
                                         for i, r in zip(ids, reads)], snr))
        tc.append(tpipe.Chunk(f"w/{z}", [tpipe.Subread(i, r)
                                         for i, r in zip(ids, reads)], snr))
    with caplog.at_level(logging.DEBUG, logger="pbccs_tpu_torch.pipeline"):
        mine = tpipe.process_chunks(tc, device="cpu")
    assert "1 adopted the 2x band" in caplog.text
    _assert_same(jpipe.process_chunks(jc), mine)


@pytest.mark.parametrize("seed,n_blocks,block", [(0, 6, 10), (1, 6, 10),
                                                 (2, 8, 8), (1, 40, 2)])
def test_mating_gate_matches_jax_on_drifted_reads(seed, n_blocks, block):
    """Reads whose path runs ~87+ nats below the column max: the port's
    flush-to-zero arithmetic gates them exactly as the JAX package does
    (which flushes float32 subnormals), at the narrow and the 2x band."""
    from pbccs_tpu.models.arrow.params import ArrowConfig as JConfig
    from pbccs_tpu.models.arrow.params import BandingOptions as JBanding
    from pbccs_tpu.parallel.batch import BatchPolisher as JPolisher
    from pbccs_tpu.parallel.batch import ZmwTask as JTask

    from pbccs_tpu_torch.models.arrow.params import ArrowConfig, \
        BandingOptions
    from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask

    rng = np.random.default_rng(seed)
    tpl, reads, strands, snr = simulate_zmw(rng, 300, 5)
    reads = list(reads)
    reads[0] = _drifted(rng, reads[0], n_blocks, block)
    L = len(tpl)
    geo = (strands, [0] * 5, [L] * 5)
    for W in (None, 128):
        mine = BatchPolisher([ZmwTask("d", tpl, snr, reads, *geo)],
                             config=ArrowConfig(banding=BandingOptions(
                                 band_width=W)), device="cpu")
        ref = JPolisher([JTask("d", tpl, snr, reads, *geo)],
                        config=JConfig(banding=JBanding(band_width=W)))
        np.testing.assert_array_equal(mine.statuses[0, :5],
                                      ref.statuses[0, :5])


@pytest.mark.slow
def test_process_chunks_matches_jax_device_loop(monkeypatch):
    monkeypatch.setenv("PBCCS_DEVICE_REFINE", "1")
    monkeypatch.setenv("PBCCS_DENSE", "1")
    monkeypatch.setenv("PBCCS_PALLAS", "1")
    jc, tc = _chunks(5, 3, 120, 5)
    _assert_same(jpipe.process_chunks(jc),
                 tpipe.process_chunks(tc, device="cpu"))


def test_gate_failures_and_empty_batches():
    """Host-stage failures tally exactly as in the JAX package, and a
    batch with nothing to polish never touches the device."""
    jc, tc = _chunks(3, 3, 100, 4)
    for c in (jc[0], tc[0]):
        c.snr = np.array([2.0, 9.0, 9.0, 9.0])          # PoorSNR
    for c in (jc[1], tc[1]):
        c.reads = c.reads[:2]                            # TooFewPasses
    _assert_same(jpipe.process_chunks(jc),
                 tpipe.process_chunks(tc, device="cpu"))
    t = tpipe.process_chunks(tc[:1], device="cpu")
    assert t.counts[tpipe.Failure.POOR_SNR] == 1 and t.total == 1


def _result(qvs):
    return tpipe.ConsensusResult(
        id="m/0", sequence="", qvs=qvs, num_passes=0,
        predicted_accuracy=0.0, global_zscore=0.0, avg_zscore=0.0,
        zscores=np.zeros(0), status_counts=[0] * 5, mutations_tested=0,
        mutations_applied=0, snr=np.zeros(4), elapsed_ms=0.0)


def _qv_cases():
    rng = np.random.default_rng(11)
    return [
        pytest.param(rng.integers(0, 94, size=2000).astype(np.int32),
                     id="int32"),
        pytest.param(np.array([-5, 0, 93, 94, 200], np.int32),
                     id="int32-clipped"),
        pytest.param(rng.uniform(-20.0, 120.0, size=500), id="float"),
        pytest.param(np.array([-1.5, -0.5, 0.0, 0.99, 1.0, 92.7, 93.0,
                               93.5, 150.0]), id="float-edges"),
        pytest.param(np.array([], np.float64), id="empty"),
    ]


@pytest.mark.parametrize("qvs", _qv_cases())
def test_qualities_match_per_base_ascii(qvs):
    expected = "".join(chr(min(max(0, int(q)), 93) + 33) for q in qvs)
    assert _result(qvs).qualities == expected


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_qualities_refuse_non_finite_qvs(bad):
    """int() refuses NaN and inf, so the per-base expression raised on
    them; the array form raises too instead of emitting a character."""
    with pytest.raises(ValueError):
        _result(np.array([20.0, bad])).qualities


def test_entry_points_need_a_card_by_default(monkeypatch):
    """Without a CUDA device and without device="cpu" the entry points
    raise instead of running on the CPU."""
    import torch

    from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _chunks(8, 1, 60, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.process_chunks(tc)
    tpl = np.zeros(30, np.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchPolisher([ZmwTask("z", tpl, np.full(4, 8.0), [tpl], [0], [0],
                               [30])])


def test_wrappers_reject_unsupported_devices():
    import torch

    from pbccs_tpu_torch.ops.dense_score_cuda import dense_score
    from pbccs_tpu_torch.ops.fwdbwd_cuda import arrow_fill
    from pbccs_tpu_torch.ops.quiver_fill_cuda import quiver_fill

    x = torch.zeros(1, 2, 4, device="meta")
    i = x[:, 0, 0].int()
    b = x[0].to(torch.int8)
    with pytest.raises(ValueError):
        arrow_fill(b, i, b, x, i, x[:, :, 0].int(), 32, 0.01)
    with pytest.raises(ValueError):
        quiver_fill(x, i, x[0].to(torch.int8), i, i, i, x[:, :, 0].int(),
                    32, True, False)
    with pytest.raises(ValueError):
        dense_score(*([x] * 12))


def test_port_imports_without_jax():
    """pbccs_tpu_torch (every module, the Quiver path's, the CLI's, its
    resilience and observability tiers', the device fleet's, the tuner's,
    the serving tier's with its router, supervisor and console, the
    tuner's referee and the trace merge named, the sharded polish's
    parallel.mesh among them) and chip_smoke.py import with jax and
    pbccs_tpu poisoned."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'pbccs_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import pkgutil, importlib, pbccs_tpu_torch\n"
        "names = {m.name for m in pkgutil.walk_packages(\n"
        "    pbccs_tpu_torch.__path__, 'pbccs_tpu_torch.')}\n"
        "quiver = {'pbccs_tpu_torch.models.quiver.' + n for n in\n"
        "          ('params', 'features', 'recursor', 'fill', 'scorer')}\n"
        "assert quiver <= names, quiver - names\n"
        "cli = {'pbccs_tpu_torch.' + n for n in\n"
        "       ('cli', 'io.bam', 'io.fasta', 'io.pbi', 'io.report',\n"
        "        'io.validate', 'runtime.logging', 'runtime.whitelist',\n"
        "        'runtime.chemistry', 'runtime.workqueue',\n"
        "        'utils.intervals', 'resilience.quarantine')}\n"
        "assert cli <= names, cli - names\n"
        "tiers = {'pbccs_tpu_torch.' + n for n in\n"
        "         ('contract', 'runtime.readid', 'runtime.timing',\n"
        "          'obs.metrics', 'obs.trace', 'obs.profiling',\n"
        "          'resilience.faults', 'resilience.retry',\n"
        "          'resilience.watchdog', 'resilience.resources',\n"
        "          'resilience.checkpoint')}\n"
        "assert tiers <= names, tiers - names\n"
        "fleet = {'pbccs_tpu_torch.' + n for n in\n"
        "         ('sched', 'sched.health', 'sched.pool', 'sched.executor',\n"
        "          'sched.warmup', 'runtime.tuning', 'tune', 'tune.space',\n"
        "          'tune.profile', 'tune.objective', 'tune.driver',\n"
        "          'tune.cli')}\n"
        "assert fleet <= names, fleet - names\n"
        "serve = {'pbccs_tpu_torch.' + n for n in\n"
        "         ('serve', 'serve.protocol', 'serve.batcher',\n"
        "          'serve.engine', 'serve.tenancy', 'serve.server',\n"
        "          'serve.client', 'obs.httpexp', 'serve.router',\n"
        "          'serve.supervisor', 'obs.console')}\n"
        "assert serve <= names, serve - names\n"
        "par = {'pbccs_tpu_torch.parallel.' + n for n in\n"
        "       ('batch', 'device_refine', 'mesh')}\n"
        "assert par <= names, par - names\n"
        "names.add('pbccs_tpu_torch.tools.perf_gate')\n"
        "names.add('pbccs_tpu_torch.tools.trace_merge')\n"
        "for name in sorted(names):\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
