"""The port's device fleet (pbccs_tpu_torch/sched) on the CPU, against
pbccs_tpu's.

Pool legs run stub task functions on CPU workers `cpu:0..3`
(`select_devices(n, device="cpu")`), the names of pbccs_tpu's virtual CPU
devices: routing, health, requeue, bench, close and pinning, with the
`sched.dispatch` fault site keyed by those names.  Pipeline legs run tiny
simulated ZMWs: the port's ScheduledPipeline against the port's
process_chunks (identical results) and against pbccs_tpu's
ScheduledPipeline on the same chunks (same tallies and sequences, QVs
within 1, as in tests/test_torch_pipeline.py); the prebake is host
arrays only.  CLI legs: `ccs --devices 4 --prepareWorkers 2` on a FASTA
writes output and report byte-identical to `--devices 1` and to
pbccs_tpu's CLI, and its ledger record's sched_batches and devices are
pbccs_tpu's; a device error on every card fails the run and journals
nothing (pbccs_tpu tallies the batch Other instead).  `ccs warmup`:
bucket parsing and one tiny bucket.  Every wait on a thread or a future
has a timeout."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from pbccs_tpu_torch import pipeline as tp
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.ops.cuda_lib import LaunchRefused
from pbccs_tpu_torch.resilience import faults, resources
from pbccs_tpu_torch.sched import (DevicePool, DevicePoolConfig,
                                   NoHealthyDevice, PoolClosed,
                                   ScheduledPipeline, select_devices)
from pbccs_tpu_torch.simulate import simulate_zmw

torch.set_num_threads(1)

reg = default_registry()
WAIT_S = 60
QV_ATOL = 1


def make_pool(n=4, **cfg) -> DevicePool:
    return DevicePool(select_devices(n, "cpu"), DevicePoolConfig(**cfg))


def worker_name(pool, i):
    return pool._workers[i].name


# ---------------------------------------------------------------- devices

def test_select_devices_cpu_workers_and_names():
    devs = select_devices(4, "cpu")
    assert [str(d) for d in devs] == ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
    assert select_devices(0, "cpu") == [torch.device("cpu", 0)]
    with pytest.raises(ValueError):
        select_devices(-1, "cpu")


def test_select_devices_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        select_devices(1)
    with pytest.raises(RuntimeError):
        DevicePool()


def test_pool_refuses_a_device_twice():
    with pytest.raises(ValueError, match="twice"):
        DevicePool([torch.device("cpu", 1), torch.device("cpu", 1)])


# ------------------------------------------------------------------ routing

def test_sticky_keeps_bucket_on_home_device():
    with make_pool(4) as pool:
        seen = []
        for _ in range(5):
            pool.submit("bucket-a",
                        lambda d: seen.append(d) or d).result(WAIT_S)
        assert len({d.index for d in seen}) == 1


def test_sticky_spreads_distinct_buckets():
    with make_pool(4) as pool:
        homes = {key: pool.submit(key, lambda d: d).result(WAIT_S).index
                 for key in ("a", "b", "c", "d")}
        assert len(set(homes.values())) == 4


def test_sticky_spills_when_home_busy():
    with make_pool(2) as pool:
        release, started = threading.Event(), threading.Event()

        def slow(d):
            started.set()
            assert release.wait(WAIT_S)
            return d

        f1 = pool.submit("k", slow)
        assert started.wait(WAIT_S)
        d2 = pool.submit("k", lambda d: d).result(WAIT_S)
        release.set()
        d1 = f1.result(WAIT_S)
        assert d1.index != d2.index
        assert len(pool._sticky.homes("k")) == 2


def test_roundrobin_policy_cycles():
    with make_pool(3, policy="roundrobin") as pool:
        devs = [pool.submit("k", lambda d: d).result(WAIT_S).index
                for _ in range(6)]
        assert devs[:3] == devs[3:] and len(set(devs[:3])) == 3


def test_worker_index_pins():
    with make_pool(4) as pool:
        for i in range(4):
            dev = pool.submit("k", lambda d: d,
                              worker_index=i).result(WAIT_S)
            assert dev == pool._workers[i].device


def test_task_runs_in_the_workers_device_scope():
    with make_pool(2) as pool:
        got = pool.submit("k", lambda d: resources.current_device(),
                          worker_index=1).result(WAIT_S)
    assert got == "cpu:1"


# ------------------------------------------------------------------- health

def test_device_failure_requeues_and_benches():
    scope = reg.scope()
    with make_pool(3, bench_after=2) as pool:
        bad = worker_name(pool, 0)
        with faults.active(f"sched.dispatch:error~{bad}"):
            futs = [pool.submit("k", lambda d: d, worker_index=0)
                    for _ in range(2)]
            out = [f.result(WAIT_S) for f in futs]
        assert all(d.index != 0 for d in out)
        assert pool._workers[0].benched
        st = pool.status()
        assert [d["benched"] for d in st["devices"]] == [True, False, False]
    assert scope.counter_value("ccs_sched_device_benched_total",
                               device=bad) == 1
    assert scope.counter_value("ccs_sched_requeues_total") >= 2
    assert scope.counter_value("ccs_sched_task_failures_total",
                               device=bad) >= 2


def test_benched_device_queue_drains_to_healthy():
    with make_pool(2, bench_after=1) as pool:
        bad = worker_name(pool, 0)
        release, started = threading.Event(), threading.Event()

        def slow_ok(d):
            started.set()
            assert release.wait(WAIT_S)
            return "ok"

        with faults.active(f"sched.dispatch:error~{bad}*1"):
            f_slow = pool.submit("other", slow_ok, worker_index=1)
            assert started.wait(WAIT_S)
            f1 = pool.submit("k", lambda d: "a", worker_index=0)
            f2 = pool.submit("k", lambda d: "b", worker_index=0)
            release.set()
            assert f_slow.result(WAIT_S) == "ok"
            assert f1.result(WAIT_S) == "a"
            assert f2.result(WAIT_S) == "b"
        assert pool._workers[0].benched


def test_last_healthy_device_never_benched():
    """On one device a device-shaped failure surfaces (the task excludes
    the device it failed on), never requeues in a loop, never benches."""
    calls = []
    with make_pool(1, bench_after=1) as pool:
        bad = worker_name(pool, 0)
        with faults.active(f"sched.dispatch:error~{bad}"):
            exc = pool.submit("k", lambda d: calls.append(d)).exception(
                WAIT_S)
        assert isinstance(exc, faults.InjectedFault)
        assert not pool._workers[0].benched and calls == []
        assert pool.submit("k", lambda d: "fine").result(WAIT_S) == "fine"


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    ValueError("poison task"),
], ids=["cuda_error", "task_error"])
def test_one_device_failure_surfaces_once(exc):
    """A sticky CUDA error (device-shaped) and a plain exception
    (task-shaped) on a one-device pool: one attempt, then the future
    carries it."""
    attempts = []

    def boom(d):
        attempts.append(d)
        raise exc

    with make_pool(1) as pool:
        assert pool.submit("k", boom).exception(WAIT_S) is exc
    assert len(attempts) == 1


def test_task_exception_propagates_when_all_devices_fail():
    with make_pool(3) as pool:
        def boom(d):
            raise ValueError("poison task")

        assert isinstance(pool.submit("k", boom).exception(WAIT_S),
                          ValueError)


def test_plain_exception_requeues_without_strike():
    with make_pool(3, bench_after=1) as pool:
        def boom(d):
            raise ValueError("poison input")

        assert isinstance(pool.submit("k", boom).exception(WAIT_S),
                          ValueError)
        assert all(not w.benched for w in pool._workers)
        assert all(w.strikes == 0 for w in pool._workers)


def test_task_shaped_failure_retries_once_not_fleet_tour():
    attempts = [0]
    with make_pool(4) as pool:
        def boom(d):
            attempts[0] += 1
            raise ValueError("deterministic bug")

        assert isinstance(pool.submit("k", boom).exception(WAIT_S),
                          ValueError)
    assert attempts[0] == 2


def test_pinned_task_fails_loudly_instead_of_requeueing():
    ran_on = []
    with make_pool(3) as pool:
        def boom(d):
            ran_on.append(d.index)
            raise ValueError("pinned failure")

        exc = pool.submit("k", boom, worker_index=1,
                          pin=True).exception(WAIT_S)
        assert isinstance(exc, ValueError) and ran_on == [1]
        ran_on.clear()
        exc = pool.submit("k2", boom, worker_index=1).exception(WAIT_S)
        assert isinstance(exc, ValueError)
        assert len(ran_on) == 2 and ran_on[0] == 1 and ran_on[1] != 1


def test_submit_rejects_bad_placement():
    with make_pool(3) as pool:
        for kw in ({"worker_index": -1}, {"worker_index": 3},
                   {"pin": True}):
            with pytest.raises(ValueError):
                pool.submit("k", lambda d: d, **kw)
        assert pool.submit("k", lambda d: d,
                           worker_index=2).result(WAIT_S).index == 2


def test_capacity_failure_requeues_to_the_same_device(fresh_governor):
    """An OOM at the sched.dispatch site records a governor ceiling for
    the task's bucket on ITS device and requeues the task there: no
    strike, no bench, one OOM split."""
    bucket = resources.shape_bucket(128, 128, 4)
    scope = reg.scope()
    with make_pool(2) as pool:
        with faults.active("sched.dispatch:oom@1*1"):
            dev = pool.submit("k", lambda d: d, zmws=8, worker_index=1,
                              capacity_bucket=bucket).result(WAIT_S)
        assert dev.index == 1
        assert all(w.strikes == 0 and not w.benched for w in pool._workers)
    assert resources.default_governor().cap(bucket, device="cpu:1") == 4
    assert scope.counter_value("ccs_sched_requeues_total") == 1
    assert scope.counter_value("ccs_resource_oom_splits_total") == 1


def test_submit_after_close_raises():
    pool = make_pool(2)
    pool.close()
    with pytest.raises(PoolClosed):
        pool.submit("k", lambda d: d)


def test_close_without_wait_fails_queued_tasks():
    pool = make_pool(1)
    release, started = threading.Event(), threading.Event()

    def slow(d):
        started.set()
        assert release.wait(WAIT_S)
        return "done"

    f_running = pool.submit("k", slow)
    assert started.wait(WAIT_S)
    f_queued = pool.submit("k", lambda d: "late")
    release.set()
    pool.close(wait=False)
    assert f_running.result(WAIT_S) == "done"
    assert isinstance(f_queued.exception(WAIT_S), PoolClosed) or \
        f_queued.result(0) == "late"


def test_post_close_failure_completes_future():
    pool = make_pool(3)
    started, release = threading.Event(), threading.Event()

    def slow_fail(d):
        started.set()
        assert release.wait(WAIT_S)
        raise RuntimeError("late failure")

    fut = pool.submit("k", slow_fail)
    assert started.wait(WAIT_S)
    closer = threading.Thread(target=lambda: pool.close(join_timeout_s=0.1))
    closer.start()
    closer.join(WAIT_S)
    assert not closer.is_alive()
    release.set()
    assert fut.wait(WAIT_S), "future stranded after post-close failure"
    assert isinstance(fut.exception(0), RuntimeError)


def test_benched_pinned_submit_raises():
    with make_pool(2, bench_after=1) as pool:
        bad = worker_name(pool, 0)
        with faults.active(f"sched.dispatch:error~{bad}*1"):
            assert pool.submit("k", lambda d: d.index,
                               worker_index=0).result(WAIT_S) == 1
        with pytest.raises(NoHealthyDevice):
            pool.submit("k", lambda d: d, worker_index=0)


@pytest.fixture
def fresh_governor():
    gov = resources.default_governor()
    for name in ("cpu:0", "cpu:1", "cpu:2", "cpu:3", "host"):
        gov.reset_device(name)
    yield gov
    for name in ("cpu:0", "cpu:1", "cpu:2", "cpu:3", "host"):
        gov.reset_device(name)


# -------------------------------------------------------- scheduled pipeline

def _draws(n, seed=20260803):
    rng = np.random.default_rng(seed)
    return [simulate_zmw(rng, 60, 5) for _ in range(n)]


def _chunks(mod, draws):
    return [mod.Chunk(f"sched/{i}",
                      [mod.Subread(f"sched/{i}/{k}", r)
                       for k, r in enumerate(reads)], snr)
            for i, (_, reads, _, snr) in enumerate(draws)]


def outputs(tally):
    return {r.id: (r.sequence, r.qualities) for r in tally.results}


def _merged(emitted):
    got, counts, order = {}, {}, []
    for idx, tally in emitted:
        order.append(idx)
        got.update({r.id: r for r in tally.results})
        for f, c in tally.counts.items():
            counts[f.value] = counts.get(f.value, 0) + c
    return got, counts, order


@pytest.fixture(scope="module")
def pipelines():
    """Two batches of four tiny ZMWs through the port's process_chunks,
    the port's ScheduledPipeline on four CPU workers, and pbccs_tpu's
    ScheduledPipeline on one of its virtual CPU devices."""
    import jax

    import pbccs_tpu.pipeline as jp
    from pbccs_tpu.sched import DevicePool as JPool
    from pbccs_tpu.sched import ScheduledPipeline as JPipe

    draws = _draws(8)
    chunks = _chunks(tp, draws)
    batches = [chunks[:4], chunks[4:]]
    settings = tp.ConsensusSettings()
    want = [tp.process_chunks(list(b), settings, device="cpu")
            for b in batches]
    scope = reg.scope()
    with make_pool(4) as pool:
        pipe = ScheduledPipeline(pool, settings, prepare_workers=2)
        got = list(pipe.run((i, list(b), None)
                            for i, b in enumerate(batches)))
        status = pool.status()
    jchunks = _chunks(jp, draws)
    with JPool(jax.devices()[:1]) as jpool:
        jpipe = JPipe(jpool, jp.ConsensusSettings(), prepare_workers=2)
        jgot = list(jpipe.run((i, jchunks[4 * i: 4 * i + 4], None)
                              for i in range(2)))
    return {"want": want, "got": got, "jgot": jgot, "status": status,
            "scope": scope}


def test_scheduled_pipeline_matches_process_chunks(pipelines):
    got, counts, order = _merged(pipelines["got"])
    want, want_counts, _ = _merged(enumerate(pipelines["want"]))
    assert order == [0, 1]
    assert {k: (r.sequence, r.qualities) for k, r in got.items()} == \
        {k: (r.sequence, r.qualities) for k, r in want.items()} and got
    assert counts == want_counts
    assert sum(d["tasks_done"] for d in pipelines["status"]["devices"]) == 2
    assert pipelines["scope"].counter_value("ccs_sched_batches_total") == 2


def test_scheduled_pipeline_matches_jax(pipelines):
    got, counts, order = _merged(pipelines["got"])
    jgot, jcounts, jorder = _merged(pipelines["jgot"])
    assert order == jorder == [0, 1]
    assert counts == jcounts
    assert sorted(got) == sorted(jgot) and got
    for k in got:
        assert got[k].sequence == jgot[k].sequence
        assert len(got[k].qvs) == len(jgot[k].qvs)
        assert np.abs(got[k].qvs.astype(int)
                      - np.asarray(jgot[k].qvs).astype(int)).max() \
            <= QV_ATOL


def test_scheduled_pipeline_stage_histograms(pipelines):
    delta = pipelines["scope"].delta()
    for stage in ("prepare", "dispatch", "polish"):
        _, total, n = delta[("ccs_sched_stage_latency_seconds",
                             (("stage", stage),))]
        assert n == 2 and total >= 0


def test_scheduled_pipeline_precomputed_and_chaos(pipelines):
    """A journal-restored tally passes through at its index untouched,
    and a device benched mid-run loses no ZMW."""
    batches = [_chunks(tp, _draws(8))[:4], _chunks(tp, _draws(8))[4:]]
    restored = pipelines["want"][0]
    scope = reg.scope()
    with make_pool(3, bench_after=1) as pool:
        bad = worker_name(pool, 0)
        pipe = ScheduledPipeline(pool, tp.ConsensusSettings(),
                                 prepare_workers=1)
        with faults.active(f"sched.dispatch:error~{bad}"):
            emitted = dict(pipe.run(iter([(0, None, restored),
                                          (1, batches[1], None)])))
    assert emitted[0] is restored
    assert outputs(emitted[1]) == outputs(pipelines["want"][1])
    assert emitted[1].total == pipelines["want"][1].total
    assert scope.counter_value("ccs_sched_device_benched_total",
                               device=bad) == 1


def test_executor_first_attempt_device_failure_reaches_pool(monkeypatch):
    """A device-shaped failure on a fleet's FIRST attempt escapes to the
    pool (raise_device_shaped=True), which strikes the device and
    requeues the whole batch; the requeued attempt runs with
    raise_device_shaped=False."""
    import types

    from pbccs_tpu_torch.resilience.watchdog import WatchdogTimeout

    chunks = [tp.Chunk(f"m/{i}", [tp.Subread(f"m/{i}/0",
                                             np.zeros(8, np.int8))],
                       np.ones(4)) for i in range(3)]

    def stub_prepare(cs, settings):
        read = types.SimpleNamespace(seq=np.zeros(8, np.int8))
        return tp.ResultTally(), [
            tp.PreparedZmw(c, np.zeros(12, np.int8), [read], 0, 0, 0.0)
            for c in cs]

    flags = []

    def fake_polish(preps, settings, *, device=None, buckets=None,
                    on_error="bisect", raise_device_shaped=False,
                    prebaked=None):
        flags.append(raise_device_shaped)
        if len(flags) == 1:
            raise WatchdogTimeout("polish.dispatch", 1.0)
        return [(tp.Failure.SUCCESS, None) for _ in preps]

    monkeypatch.setattr(tp, "prepare_batch", stub_prepare)
    monkeypatch.setattr(tp, "polish_prepared_batch", fake_polish)
    monkeypatch.setattr(tp, "prebake_polish", lambda preps: None)
    scope = reg.scope()
    with make_pool(3) as pool:
        pipe = ScheduledPipeline(pool, tp.ConsensusSettings(),
                                 prepare_workers=1)
        emitted = dict(pipe.run([(0, chunks, None)]))
        assert sum(w.strikes for w in pool._workers) == 1
    assert flags == [True, False]
    assert emitted[0].counts[tp.Failure.SUCCESS] == 3
    assert scope.counter_value("ccs_sched_requeues_total") == 1


@pytest.mark.parametrize("exc,surfaces", [
    (LaunchRefused("arrow_fill: band width 80 is not one of (64, 96, 128)"),
     True),
    (ValueError("template outgrew bucket"), False),
])
def test_executor_device_error_fails_the_run(monkeypatch, exc, surfaces):
    """A device error the pool gives up on (sticky on the only card)
    fails the run, as on the work queue; any other failure that ran out
    of devices tallies the batch's ZMWs as Other, as in pbccs_tpu."""
    chunks = _chunks(tp, _draws(2))

    def refuse(preps, settings, **kw):
        raise exc

    monkeypatch.setattr(tp, "polish_prepared_batch", refuse)
    with make_pool(2) as pool:
        pipe = ScheduledPipeline(pool, tp.ConsensusSettings(),
                                 prepare_workers=1)
        if surfaces:
            with pytest.raises(type(exc)):
                list(pipe.run([(0, chunks, None)]))
        else:
            ((_, tally),) = list(pipe.run([(0, chunks, None)]))
            assert tally.counts[tp.Failure.OTHER] == 2 and not tally.results


def test_host_budget_throttles_and_output_is_unchanged(pipelines):
    """A --memBudget of one batch's marshalled bytes admits one batch at
    a time: the second prepare throttles, the results are the same."""
    from pbccs_tpu_torch.parallel.batch import premarshal_nbytes

    chunks = _chunks(tp, _draws(8))
    _, preps = tp.prepare_batch(chunks[:4])
    imax, jmax, r = tp._pinned_batch_shapes(preps, None)
    budget = resources.HostBudget(premarshal_nbytes((imax, jmax, r, 4)))
    with make_pool(1) as pool:
        pipe = ScheduledPipeline(pool, tp.ConsensusSettings(),
                                 prepare_workers=2, budget=budget)
        got = list(pipe.run([(0, chunks[:4], None), (1, chunks[4:], None)]))
    assert [outputs(t) for _, t in got] == \
        [outputs(t) for t in pipelines["want"]]
    assert budget.throttle_count() >= 1 and budget.in_use() == 0


def test_prebake_polish_is_host_arrays_only():
    """The prebake a prepare thread builds holds numpy planes and the
    batch's tasks, no tensor (no CUDA tensor is made off the device
    worker), and BatchPolisher adopts it only for its own tasks."""
    from pbccs_tpu_torch.parallel.batch import BatchPolisher

    _, preps = tp.prepare_batch(_chunks(tp, _draws(2)))
    pb = tp.prebake_polish(preps)
    for name, value in vars(pb).items():
        assert not isinstance(value, torch.Tensor), name
        if name not in ("tasks", "shapes"):
            assert isinstance(value, np.ndarray), name
    polisher = BatchPolisher(pb.tasks, device="cpu", prebaked=pb)
    assert polisher._reads is pb.reads
    other = BatchPolisher(tp._polish_tasks(preps), device="cpu",
                          prebaked=pb)
    assert other._reads is not pb.reads
    np.testing.assert_array_equal(other._reads, pb.reads)


# -------------------------------------------------------------------- warmup

def test_warmup_bucket_parsing():
    from pbccs_tpu_torch.sched.warmup import parse_bucket

    assert parse_bucket("64x8x300") == (64, 8, 300)
    for bad in ("64x8", "0x8x300", "ax8x300"):
        with pytest.raises(SystemExit):
            parse_bucket(bad)


def test_warmup_runs_tiny_bucket(capsys):
    from pbccs_tpu_torch.cli import run

    assert run(["warmup", "--bucket", "2x3x40", "--devices", "2",
                "--allDevices", "--logLevel", "WARN"], device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [e["device"] for e in out["warmed"]] == ["cpu:0", "cpu:1"]
    entry = out["warmed"][0]
    assert entry["bucket"] == "2x3x40" and entry["shapes"]["Z"] == 2
    assert entry["cost_card"]["flops"] > 0
    assert "kernels" not in out       # nothing to build on the CPU


# ---------------------------------------------------------- CLI integration

def _write_fasta(path, n_zmws):
    """n_zmws simulated ZMWs as a subread FASTA (movie `m`)."""
    from pbccs_tpu_torch.models.arrow.params import decode_bases

    with open(path, "w") as f:
        for z, (_, reads, _, _) in enumerate(_draws(n_zmws)):
            start = 0
            for r in reads:
                seq = decode_bases(r)
                f.write(f">m/{z}/{start}_{start + len(seq)}\n{seq}\n")
                start += len(seq) + 20
    return path


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One FASTA of six tiny ZMWs through the port's CLI at --devices 1
    and --devices 4 --prepareWorkers 2, and pbccs_tpu's CLI at the
    latter, with --chunkSize 3 (two batches)."""
    from pbccs_tpu.cli import run as jrun

    from pbccs_tpu_torch.cli import run

    d = tmp_path_factory.mktemp("fleet_cli")
    fasta = _write_fasta(d / "subreads.fasta", 6)
    out = {}
    for name, fn, devices, kw in (
            ("one", run, "1", {"device": "cpu"}),
            ("fleet", run, "4", {"device": "cpu"}),
            ("jax", jrun, "4", {})):
        fa, rep = d / f"{name}.fasta", d / f"{name}.csv"
        ledger = d / f"{name}.ndjson"
        argv = [str(fa), str(fasta), "--skipChemistryCheck", "--chunkSize",
                "3", "--reportFile", str(rep), "--devices", devices,
                "--perfLedger", str(ledger), "--logLevel", "WARN"]
        if devices != "1":
            argv += ["--prepareWorkers", "2"]
        assert fn(argv, **kw) == 0
        (rec,) = [json.loads(line) for line in open(ledger)]
        out[name] = (fa.read_bytes(), rep.read_bytes(), rec)
    return out


def test_cli_multi_device_output_byte_identical(cli_runs):
    one, fleet = cli_runs["one"], cli_runs["fleet"]
    assert fleet[0] == one[0] and fleet[0].count(b">") >= 4
    assert fleet[1] == one[1]


def test_cli_fleet_matches_jax_cli(cli_runs):
    fleet, jax_ = cli_runs["fleet"], cli_runs["jax"]
    assert fleet[0] == jax_[0]
    assert fleet[1] == jax_[1]


def test_cli_fleet_ledger_fields_match_jax(cli_runs):
    (_, _, one), (_, _, mine), (_, _, ref) = (
        cli_runs["one"], cli_runs["fleet"], cli_runs["jax"])
    assert mine["sched_batches"] == ref["sched_batches"] == 2
    assert mine["workload"]["devices"] == ref["workload"]["devices"] == 4
    assert one["sched_batches"] == 0 and one["workload"]["devices"] == 1
    assert mine["tuned_profile"] == ref["tuned_profile"] == "none"


def test_cli_fleet_device_error_fails_and_journals_nothing(tmp_path,
                                                          monkeypatch):
    """A kernel refusal on every card of a fleet run fails the run (the
    work queue's rule): no output, no chunk journaled, so --resume redoes
    every chunk."""
    from pbccs_tpu_torch.cli import run

    fasta = _write_fasta(tmp_path / "subreads.fasta", 4)

    def refuse(preps, settings, device, *, buckets=None):
        raise LaunchRefused("arrow_fill: band width 80 is not one of "
                            "(64, 96, 128)")

    monkeypatch.setattr(tp, "_polish_batch_arrow", refuse)
    out, ckpt = tmp_path / "o.fasta", tmp_path / "c.ckpt"
    scope = reg.scope()
    with pytest.raises(LaunchRefused):
        run([str(out), str(fasta), "--skipChemistryCheck", "--chunkSize",
             "2", "--devices", "2", "--checkpoint", str(ckpt),
             "--logLevel", "ERROR"], device="cpu")
    assert not out.exists()
    assert scope.counter_value("ccs_checkpoint_records_total",
                               kind="written") == 0
    assert scope.counter_value("ccs_sched_batches_total") >= 1


def test_cli_fleet_usage_errors_exit_2(tmp_path):
    from pbccs_tpu_torch.cli import run

    argv = [str(tmp_path / "o.fasta"), str(tmp_path / "missing.fasta"),
            "--devices", "2"]
    assert run(argv[:2] + ["--devices", "-1"], device="cpu") == 2
    assert run(argv + ["--memBudget", "0.5"], device="cpu") == 2
    assert run(argv, device="cpu") == 2          # the missing input
