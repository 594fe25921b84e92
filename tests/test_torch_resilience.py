"""The port's resilience tier against pbccs_tpu's on the CPU: fault
injection, retry, watchdog, checkpoint journal, capacity classification,
the memory governor, the host budget, disk-full-safe writers and the
OOM-adaptive dispatch (the classes of tests/test_resilience.py), each
held against pbccs_tpu on the same inputs where both packages compute
the same thing.

Both packages are imported into this process, and each has its own
metrics registry, fault injector, watchdog default and memory governor:
a test installs injectors in both (each package's faults.active), reads
each package's own counters, and never sets PBCCS_FAULTS or
PBCCS_WATCHDOG_S, which would arm both at once.

The end-to-end cases run a 4-ZMW batch (70 bp, 4 passes) through both
packages' process_chunks under one fault spec each: the tallies and the
quarantine, retry, watchdog, split and checkpoint counters must be
equal, and the port's survivors byte-equal to its fault-free run
(sequence, QVs, z-scores).  The bisection-dispatch counter is not
compared: the port dispatches a split-off singleton before rescuing it
serially, pbccs_tpu rescues it at once.  The CLI case kills a
--checkpoint run with a workqueue.task fault, resumes it, and requires
the BAM, .pbi and report byte-identical to an uninterrupted run."""

import dataclasses
import errno
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import pbccs_tpu.pipeline as jp
from pbccs_tpu.obs.metrics import default_registry as jregistry
from pbccs_tpu.resilience import checkpoint as jck
from pbccs_tpu.resilience import faults as jfaults
from pbccs_tpu.resilience import resources as jres
from pbccs_tpu.resilience import retry as jretry
from pbccs_tpu.resilience import watchdog as jwd

import pbccs_tpu_torch.pipeline as tp
from pbccs_tpu_torch.cli import run
from pbccs_tpu_torch.io.bam import (BamHeader, BamRecord, BamWriter,
                                    ReadGroupInfo)
from pbccs_tpu_torch.io.fasta import write_fasta
from pbccs_tpu_torch.models.arrow.params import decode_bases
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.ops.cuda_lib import KernelError, LaunchRefused
from pbccs_tpu_torch.resilience import (checkpoint, faults, quarantine,
                                        resources, retry, watchdog)
from pbccs_tpu_torch.resilience.faults import FaultSpecError, InjectedFault
from pbccs_tpu_torch.resilience.resources import (HostBudget, MemoryGovernor,
                                                  OutputWriteError,
                                                  parse_size, shape_bucket,
                                                  split_sizes)
from pbccs_tpu_torch.runtime.logging import Logger, LogLevel
from pbccs_tpu_torch.simulate import simulate_zmw

torch.set_num_threads(1)

# ----------------------------------------------------------------- helpers


def make_prep(zmw_id="m/1", tpl_len=24, n_reads=3, mod=tp):
    seq = np.arange(tpl_len, dtype=np.int8) % 4
    chunk = mod.Chunk(zmw_id, [mod.Subread(f"{zmw_id}/{i}", seq.copy())
                               for i in range(n_reads)], np.full(4, 8.0))
    mapped = [mod.MappedRead(r.id, r.seq, 0, 0, tpl_len, True)
              for r in chunk.reads]
    return mod.PreparedZmw(chunk, seq.copy(), mapped, n_reads, 0, 1.5)


#: one ConsensusResult's fields, built in either package
RESULT = dict(id="m/1", sequence="ACGTA", qvs=[40.0, 39.5, 12.25, 7.0, 93.0],
              num_passes=4, predicted_accuracy=0.999, global_zscore=0.1,
              avg_zscore=0.2, zscores=[0.5, float("nan")],
              status_counts=[2, 0, 1, 0, 0], mutations_tested=7,
              mutations_applied=3, snr=[8.0, 7.5, 6.25, 9.0],
              elapsed_ms=1.25, draft_only=False)


def make_result(mod=tp, **kw):
    d = {**RESULT, **kw}
    for k in ("qvs", "zscores", "snr"):
        d[k] = np.asarray(d[k], np.float64)
    return mod.ConsensusResult(**d)


def make_tally(ids, mod=tp):
    tally = mod.ResultTally()
    for zid in ids:
        tally.tally(mod.Failure.SUCCESS)
        tally.results.append(make_result(mod, id=zid))
    tally.tally(mod.Failure.POOR_SNR)
    return tally


def fire_pattern(fmod, spec, seed, site="s", n=20, keys=()):
    inj = fmod.FaultInjector(spec, seed=seed)
    pat = []
    for _ in range(n):
        try:
            inj.maybe_fail(site, keys=keys)
            pat.append(0)
        except fmod.InjectedFault:
            pat.append(1)
    return pat


def join_watchdog_threads(timeout=120.0):
    """Wait for abandoned watchdog workers (both packages name them
    pbccs-watchdog-*) so none outlives its test."""
    for t in threading.enumerate():
        if t.name.startswith("pbccs-watchdog-"):
            t.join(timeout)
            assert not t.is_alive(), t.name


@pytest.fixture
def fresh_governors(monkeypatch):
    monkeypatch.setattr(resources, "_default_governor", MemoryGovernor())
    monkeypatch.setattr(jres, "_default_governor", jres.MemoryGovernor())


# ------------------------------------------------------------------- faults

SPECS = ["polish.dispatch:error~m/3,prep.zmw:delay=0.5@2*1,"
         "checkpoint.record:corrupt%0.25",
         "sched.dispatch:oom@1*1,output.write:enospc~bam@2",
         "serve.start:crashloop=3~1", "polish.dispatch:error=transient@1*1"]


class TestFaults:
    @pytest.mark.parametrize("spec", SPECS)
    def test_parse_grammar_matches(self, spec):
        mine = [dataclasses.asdict(s) for s in faults.parse_faults(spec)]
        ref = [dataclasses.asdict(s) for s in jfaults.parse_faults(spec)]
        assert mine == ref and mine
        assert faults.FAULT_KINDS == jfaults.FAULT_KINDS

    @pytest.mark.parametrize("bad", ["nosite", "site:frobnicate",
                                     "site:error@x", "site:eNoSpC"])
    def test_parse_rejects(self, bad):
        with pytest.raises(FaultSpecError):
            faults.parse_faults(bad)
        with pytest.raises(jfaults.FaultSpecError):
            jfaults.parse_faults(bad)

    def test_key_selects_poison(self):
        inj = faults.FaultInjector("polish.dispatch:error~m/2")
        inj.maybe_fail("polish.dispatch", keys=["m/1", "m/3"])  # no match
        inj.maybe_fail("other.site", keys=["m/2"])              # other site
        with pytest.raises(InjectedFault):
            inj.maybe_fail("polish.dispatch", keys=["m/1", "m/2"])
        assert inj.fired("polish.dispatch") == 1

    @pytest.mark.parametrize("spec,seed", [("s:error@2*1", 0),
                                           ("s:error%0.5", 7),
                                           ("s:error%0.5", 8),
                                           ("s:error%0.3*4", 3),
                                           ("s:error~k%0.5", 1)])
    def test_fire_sequence_matches(self, spec, seed):
        """The same spec and seed fire on the same calls in both."""
        mine = fire_pattern(faults, spec, seed, keys=["k"])
        assert mine == fire_pattern(jfaults, spec, seed, keys=["k"])
        if "%" in spec:
            assert 0 < sum(mine) < 20

    def test_corrupt_bytes_and_array_match(self):
        data = b"0123456789"
        arr = np.zeros(8, np.int8)
        mine = faults.FaultInjector("c:corrupt")
        ref = jfaults.FaultInjector("c:corrupt")
        assert mine.corrupt("c", data) == ref.corrupt("c", data) != data
        np.testing.assert_array_equal(mine.corrupt("c", arr),
                                      ref.corrupt("c", arr))
        assert (arr == 0).all()
        assert mine.corrupt("other", data) is data

    def test_module_level_noop_and_active_scope(self):
        faults.maybe_fail("anywhere", keys=["x"])  # no injector: no-op
        with faults.active("s:error"):
            with pytest.raises(InjectedFault):
                faults.maybe_fail("s")
            jfaults.maybe_fail("s")   # the other package is not armed
        faults.maybe_fail("s")  # restored

    def test_injected_fault_metric(self):
        scope = default_registry().scope()
        jscope = jregistry().scope()
        with faults.active("s:error*2"):
            for _ in range(3):
                try:
                    faults.maybe_fail("s")
                except InjectedFault:
                    pass
        assert scope.counter_value("ccs_faults_injected_total",
                                   site="s", kind="error") == 2
        assert jscope.counter_value("ccs_faults_injected_total",
                                    site="s", kind="error") == 0


# -------------------------------------------------------------------- retry


class TestRetry:
    @pytest.mark.parametrize("kw", [
        dict(max_attempts=5, base_delay_s=0.1, max_delay_s=0.3,
             multiplier=2.0, jitter=0.0),
        dict(max_attempts=4, jitter=0.5), dict(max_attempts=3)])
    def test_delays_match(self, kw):
        mine = list(retry.RetryPolicy(**kw).delays(
            np.random.default_rng(3)))
        assert mine == list(jretry.RetryPolicy(**kw).delays(
            np.random.default_rng(3)))
        assert len(mine) == kw["max_attempts"] - 1
        assert retry.DEVICE_RETRY == retry.RetryPolicy(
            **dataclasses.asdict(jretry.DEVICE_RETRY))

    def test_run_retries_then_succeeds(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("transient blip")
            return "ok"

        scope = default_registry().scope()
        pol = retry.RetryPolicy(max_attempts=4, base_delay_s=0.0)
        assert pol.run(flaky, retry_on=lambda e: "transient" in str(e),
                       site="test.retry") == "ok"
        assert len(calls) == 3
        assert scope.counter_value("ccs_retries_total",
                                   site="test.retry") == 2

    def test_run_propagates_non_retryable(self):
        pol = retry.RetryPolicy(max_attempts=5, base_delay_s=0.0)
        with pytest.raises(ValueError):
            pol.run(lambda: (_ for _ in ()).throw(ValueError("poison")),
                    retry_on=lambda e: False)

    def test_run_exhausts_with_cause(self):
        pol = retry.RetryPolicy(max_attempts=2, base_delay_s=0.0)
        with pytest.raises(retry.RetriesExhausted) as ei:
            pol.run(lambda: (_ for _ in ()).throw(RuntimeError("always")),
                    retry_on=lambda e: True)
        assert isinstance(ei.value.__cause__, RuntimeError)

    def test_deadline_bounds_total_wall(self):
        slept = []
        pol = retry.RetryPolicy(max_attempts=10, base_delay_s=5.0,
                                jitter=0.0, deadline_s=1.0)
        with pytest.raises(retry.RetriesExhausted):
            pol.run(lambda: (_ for _ in ()).throw(RuntimeError("x")),
                    retry_on=lambda e: True, sleep=slept.append)
        assert slept == []

    @pytest.mark.parametrize("make", [
        lambda m: RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
        lambda m: RuntimeError("UNAVAILABLE: device preempted"),
        lambda m: RuntimeError("ABORTED: collective"),
        lambda m: m.InjectedFault("polish.dispatch", "transient"),
        lambda m: m.InjectedFault("polish.dispatch", "RESOURCE_EXHAUSTED"),
        lambda m: ValueError("bad template"),
    ])
    def test_transient_classifier_matches(self, make):
        assert retry.is_transient_device_error(make(faults)) == \
            jretry.is_transient_device_error(make(jfaults))

    def test_transient_excludes_timeouts(self):
        assert not retry.is_transient_device_error(
            watchdog.WatchdogTimeout("polish.dispatch", 3.0))

    @pytest.mark.parametrize("exc", [
        RuntimeError("CUDA error: an illegal memory access was "
                     "encountered (UNAVAILABLE)"),
        RuntimeError("CUDA error: unspecified launch failure transient"),
        KernelError("dense_score: CUDA launch failed (ABORTED)"),
        LaunchRefused("arrow_fill: band width 224 (transient)"),
        torch.cuda.OutOfMemoryError("CUDA out of memory (transient)"),
    ])
    def test_no_cuda_error_is_transient(self, exc):
        """CUDA errors are sticky: none is retried, whatever its text."""
        assert not retry.is_transient_device_error(exc)


# ----------------------------------------------------------------- watchdog


class TestWatchdog:
    def test_disabled_runs_inline(self):
        tid = threading.get_ident()
        assert watchdog.run_with_deadline(threading.get_ident, 0) == tid

    def test_result_and_exception_pass_through(self):
        assert watchdog.run_with_deadline(lambda: 42, 5.0) == 42
        with pytest.raises(ValueError):
            watchdog.run_with_deadline(
                lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0)

    def test_timeout_raises_structured(self):
        scope = default_registry().scope()
        jscope = jregistry().scope()
        release = threading.Event()
        with pytest.raises(watchdog.WatchdogTimeout) as ei:
            watchdog.run_with_deadline(lambda: release.wait(30.0), 0.1,
                                       site="test.hang")
        release.set()  # unblock the abandoned thread
        join_watchdog_threads()
        assert ei.value.site == "test.hang"
        assert str(ei.value) == str(jwd.WatchdogTimeout("test.hang", 0.1))
        assert scope.counter_value("ccs_watchdog_timeouts_total",
                                   site="test.hang") == 1
        assert jscope.counter_value("ccs_watchdog_timeouts_total",
                                    site="test.hang") == 0

    def test_configure_overrides_env(self):
        watchdog.configure(1.5)
        try:
            assert watchdog.default_deadline_s() == 1.5
            assert jwd.default_deadline_s() != 1.5   # its own default
        finally:
            watchdog.configure(None)

    def test_worker_sees_the_callers_device(self):
        """The guarded callable runs on another thread under the caller's
        device scope (on the card also its CUDA device and stream, see
        tests/test_torch_gpu.py); a thread of its own sees "host"."""
        with resources.device_scope("cuda:1"):
            seen = watchdog.run_with_deadline(
                lambda: (threading.current_thread().name,
                         resources.current_device()), 5.0, site="dev")
        assert seen == ("pbccs-watchdog-dev", "cuda:1")
        other = []
        t = threading.Thread(
            target=lambda: other.append(resources.current_device()))
        t.start()
        t.join(10.0)
        assert other == ["host"]


# --------------------------------------------------------------- checkpoint


class TestCheckpoint:
    def test_result_to_json_matches(self):
        mine = checkpoint.result_to_json(make_result(tp))
        ref = jck.result_to_json(make_result(jp))
        assert json.dumps(mine) == json.dumps(ref)
        assert json.dumps(checkpoint.tally_to_json(make_tally(["a"], tp))) \
            == json.dumps(jck.tally_to_json(make_tally(["a"], jp)))

    def test_result_round_trip(self):
        r = make_result(tp, draft_only=True)
        back = checkpoint.result_from_json(
            json.loads(json.dumps(checkpoint.result_to_json(r))))
        assert back.id == r.id and back.sequence == r.sequence
        assert back.qualities == r.qualities
        np.testing.assert_array_equal(back.qvs, r.qvs)
        assert back.qvs.dtype == np.float64
        np.testing.assert_array_equal(back.status_counts, r.status_counts)
        assert np.isnan(back.zscores[1]) and back.zscores[0] == 0.5
        assert back.draft_only

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_records_load_across_packages(self, direction):
        src, dst, smod, dmod = ((jck, checkpoint, jp, tp)
                                if direction == "jax_to_port"
                                else (checkpoint, jck, tp, jp))
        rec = json.loads(json.dumps(src.result_to_json(make_result(smod))))
        back = dst.result_from_json(rec)
        assert isinstance(back, dmod.ConsensusResult)
        assert json.dumps(dst.result_to_json(back)) == json.dumps(rec)
        tally = dst.tally_from_json(json.loads(json.dumps(
            src.tally_to_json(make_tally(["m/0", "m/1"], smod)))))
        assert [r.id for r in tally.results] == ["m/0", "m/1"]
        assert tally.counts[dmod.Failure.POOR_SNR] == 1

    def test_journal_round_trip(self, tmp_path):
        path = str(tmp_path / "j.ckpt")
        fp = {"version": 1, "inputs": [["a", 10]], "chunk_size": 2}
        j = checkpoint.CheckpointJournal(path)
        j.start(fp, resume=False)
        j.record_chunk(0, make_tally(["m/0", "m/1"]))
        j.record_chunk(1, make_tally(["m/2"]))
        j.close()
        restored = checkpoint.CheckpointJournal(path).load(fp)
        assert sorted(restored) == [0, 1]
        assert [r.id for r in restored[0].results] == ["m/0", "m/1"]
        assert restored[1].counts[tp.Failure.SUCCESS] == 1
        assert restored[1].counts[tp.Failure.POOR_SNR] == 1

    def test_fingerprint_mismatch_refuses(self, tmp_path):
        path = str(tmp_path / "j.ckpt")
        j = checkpoint.CheckpointJournal(path)
        j.start({"chunk_size": 2}, resume=False)
        j.record_chunk(0, make_tally(["m/0"]))
        j.close()
        assert checkpoint.CheckpointJournal(path).load(
            {"chunk_size": 4}) == {}

    def test_journal_of_the_other_package_is_refused(self, tmp_path):
        """Same inputs, chunk size and settings: the fingerprints differ
        only in the implementation, and each package refuses the other's
        journal (the port with a logged note) and starts fresh."""
        f = tmp_path / "in.fasta"
        f.write_text(">a/1/0_4\nACGT\n")
        ref_fp = jck.run_fingerprint([str(f)], 2, jp.ConsensusSettings())
        my_fp = checkpoint.run_fingerprint([str(f)], 2,
                                           tp.ConsensusSettings())
        assert {k: v for k, v in my_fp.items()
                if k != "implementation"} == ref_fp
        assert my_fp["implementation"] == "pbccs_tpu_torch"
        ref_path = str(tmp_path / "ref.ckpt")
        j = jck.CheckpointJournal(ref_path)
        j.start(ref_fp, resume=False)
        j.record_chunk(0, make_tally(["a/1"], jp))
        j.close()
        assert sorted(jck.CheckpointJournal(ref_path).load(ref_fp)) == [0]
        buf = io.StringIO()
        log = Logger(stream=buf, level=LogLevel.INFO)
        assert checkpoint.CheckpointJournal(ref_path, logger=log).load(
            my_fp) == {}
        log.flush()
        assert "written by another implementation" in buf.getvalue()
        my_path = str(tmp_path / "mine.ckpt")
        j = checkpoint.CheckpointJournal(my_path)
        j.start(my_fp, resume=False)
        j.record_chunk(0, make_tally(["a/1"]))
        j.close()
        assert jck.CheckpointJournal(my_path).load(ref_fp) == {}

    def test_torn_and_corrupt_records_dropped(self, tmp_path):
        path = str(tmp_path / "j.ckpt")
        fp = {"chunk_size": 2}
        j = checkpoint.CheckpointJournal(path)
        j.start(fp, resume=False)
        j.record_chunk(0, make_tally(["m/0"]))
        j.record_chunk(1, make_tally(["m/1"]))
        j.close()
        data = open(path, "rb").read()
        open(path, "wb").write(data[: data.rindex(b'{"type": "chunk"') + 40])
        scope = default_registry().scope()
        restored = checkpoint.CheckpointJournal(path).load(fp)
        assert sorted(restored) == [0]
        assert scope.counter_value("ccs_checkpoint_records_total",
                                   kind="corrupt") == 1

    def test_corrupt_fault_site(self, tmp_path):
        path = str(tmp_path / "j.ckpt")
        fp = {"chunk_size": 2}
        with faults.active("checkpoint.record:corrupt@2"):
            j = checkpoint.CheckpointJournal(path)
            j.start(fp, resume=False)              # record 1: header
            j.record_chunk(0, make_tally(["m/0"]))  # record 2: corrupt
            j.record_chunk(1, make_tally(["m/1"]))
            j.close()
        assert sorted(checkpoint.CheckpointJournal(path).load(fp)) == [1]

    def test_fingerprint_tracks_same_size_content_change(self, tmp_path):
        f = tmp_path / "in.fasta"
        f.write_text(">a\nACGT\n")
        fp1 = checkpoint.run_fingerprint([str(f)], 2, tp.ConsensusSettings())
        os.utime(f, ns=(1, 1))
        fp2 = checkpoint.run_fingerprint([str(f)], 2, tp.ConsensusSettings())
        assert fp1 != fp2

    def test_resume_appends_and_last_record_wins(self, tmp_path):
        path = str(tmp_path / "j.ckpt")
        fp = {"chunk_size": 2}
        j = checkpoint.CheckpointJournal(path)
        j.start(fp, resume=False)
        j.record_chunk(0, make_tally(["m/0"]))
        j.close()
        j2 = checkpoint.CheckpointJournal(path)
        assert sorted(j2.load(fp)) == [0]
        j2.start(fp, resume=True)
        j2.record_chunk(0, make_tally(["m/0x"]))
        j2.record_chunk(1, make_tally(["m/1"]))
        j2.close()
        restored = checkpoint.CheckpointJournal(path).load(fp)
        assert sorted(restored) == [0, 1]
        assert [r.id for r in restored[0].results] == ["m/0x"]


# ---------------------------------------- resource-exhaustion governance


CAPACITY_CASES = [
    lambda m: RuntimeError("RESOURCE_EXHAUSTED: Attempting to allocate"),
    lambda m: MemoryError(),
    lambda m: RuntimeError("Out of memory allocating 2.1G in HBM"),
    lambda m: m.InjectedFault("sched.dispatch", "RESOURCE_EXHAUSTED"),
    lambda m: ValueError("bad template"),
    lambda m: RuntimeError("UNAVAILABLE: preempted"),
]


class TestCapacityClassification:
    @pytest.mark.parametrize("make", CAPACITY_CASES)
    def test_capacity_markers_match(self, make):
        assert resources.is_capacity_error(make(faults)) == \
            jres.is_capacity_error(make(jfaults))

    def test_cuda_out_of_memory_is_capacity(self):
        oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")
        assert resources.is_capacity_error(oom)
        assert resources.is_capacity_error(torch.cuda.OutOfMemoryError())
        note = resources.CapacityError.of(oom)
        assert resources.is_capacity_error(note)
        assert note.__traceback__ is None and "OutOfMemoryError" in str(note)
        try:
            try:
                raise oom
            except RuntimeError as e:
                raise ValueError("wrapped") from e
        except ValueError as outer:
            assert resources.is_capacity_error(outer)

    def test_oom_fault_kind_is_capacity_not_transient(self):
        with faults.active("sched.dispatch:oom@1"):
            with pytest.raises(InjectedFault) as ei:
                faults.maybe_fail("sched.dispatch", keys=["cuda"])
        assert resources.is_capacity_error(ei.value)
        assert not retry.is_transient_device_error(ei.value)

    def test_enospc_fault_kind_raises_real_oserror(self):
        with faults.active("checkpoint.record:enospc@1"):
            with pytest.raises(OSError) as ei:
                faults.maybe_fail("checkpoint.record", keys=["chunk"])
        assert ei.value.errno == errno.ENOSPC


class TestMemoryGovernor:
    def test_ceilings_match(self):
        steps = [("record", 64, "cuda:0"), ("cap", None, "cuda:0"),
                 ("cap", None, "cuda:1"), ("cap", None, None),
                 ("record", 16, "cuda:0"), ("record", 100, "cuda:0"),
                 ("record", 32, "cuda:1"), ("cap", None, "cuda:1"),
                 ("reset", None, "cuda:0"), ("cap", None, "cuda:0"),
                 ("reset", None, "cuda:1"), ("cap", None, None),
                 ("reset", None, "cuda:1")]
        b = shape_bucket(128, 256, 8)
        assert b == jres.shape_bucket(128, 256, 8)
        seqs = []
        for gov in (MemoryGovernor(), jres.MemoryGovernor()):
            seq = []
            for op, z, dev in steps:
                if op == "record":
                    seq.append(gov.record_oom(b, z, device=dev))
                elif op == "cap":
                    seq.append(gov.cap(b, device=dev))
                else:
                    seq.append(gov.reset_device(dev))
            seq.append(gov.cap(shape_bucket(64, 128, 4)))
            seqs.append(seq)
        assert seqs[0] == seqs[1]
        assert seqs[0][:4] == [32, 32, 32, 32]

    @pytest.mark.parametrize("n,cap", [(10, 4), (4, 4), (5, 4), (12, 8),
                                       (1, 3), (1023, 64), (32, 16)])
    def test_split_sizes_match(self, n, cap):
        assert split_sizes(n, cap) == jres.split_sizes(n, cap)
        assert sum(split_sizes(n, cap)) == n

    def test_split_sizes_rejects_zero_cap(self):
        with pytest.raises(ValueError):
            split_sizes(4, 0)

    def test_device_scope_thread_local(self):
        assert resources.current_device() == "host"
        with resources.device_scope("cuda:3"):
            assert resources.current_device() == "cuda:3"
            assert jres.current_device() == "host"   # its own scope
            seen = []
            t = threading.Thread(
                target=lambda: seen.append(resources.current_device()))
            t.start()
            t.join()
            assert seen == ["host"]
        assert resources.current_device() == "host"


class TestHostBudget:
    @pytest.mark.parametrize("text", ["8G", "512M", "1.5K", "12345",
                                      "2GiB", "3 t", 77])
    def test_parse_size_matches(self, text):
        assert parse_size(text) == jres.parse_size(text)

    def test_parse_size_rejects(self):
        with pytest.raises(ValueError):
            parse_size("eight gigs")

    def test_gate_blocks_until_release(self):
        b = HostBudget(100)
        first = b.admit(80, site="t")
        got = []
        t = threading.Thread(
            target=lambda: got.append(b.admit(50, site="t")))
        t.start()
        time.sleep(0.15)
        assert not got                      # parked: 80 + 50 > 100
        first.release()
        t.join(timeout=5.0)
        assert got and got[0] is not None
        assert b.in_use() == 50
        assert b.throttle_count() == 1
        got[0].release()
        assert b.in_use() == 0

    def test_oversize_charge_admits_alone(self):
        b = HostBudget(10)
        lease = b.admit(500, site="t")
        assert lease is not None and b.in_use() == 500
        lease.release()

    def test_abort_unblocks_waiter(self):
        b = HostBudget(10)
        hold = b.admit(10, site="t")
        flag = threading.Event()
        got = []
        t = threading.Thread(
            target=lambda: got.append(
                b.admit(5, site="t", abort=flag.is_set)))
        t.start()
        time.sleep(0.1)
        flag.set()
        t.join(timeout=5.0)
        assert got == [None]
        assert b.in_use() == 10
        hold.release()

    def test_release_idempotent(self):
        b = HostBudget(100)
        lease = b.admit(60, site="t")
        lease.release()
        lease.release()
        assert b.in_use() == 0

    def test_rejects_nonpositive_budget(self):
        with pytest.raises(ValueError):
            HostBudget(0)


class TestDiskFullWriters:
    def _write_all(self, path):
        header = BamHeader(read_groups=[ReadGroupInfo("m", "CCS")])
        with BamWriter(str(path), header) as bw:
            for i in range(3):
                bw.write(BamRecord(name=f"m/{i}/ccs", seq="ACGTACGT",
                                   qual="IIIIIIII", tags={"zm": i}))

    def test_bam_enospc_structured_and_rewrite_identical(self, tmp_path):
        control = tmp_path / "control.bam"
        self._write_all(control)
        out = tmp_path / "out.bam"
        scope = default_registry().scope()
        with faults.active("output.write:enospc@3*1"):
            with pytest.raises(OutputWriteError) as ei:
                self._write_all(out)
        assert ei.value.sink == "bam" and ei.value.errno == errno.ENOSPC
        assert not out.exists()
        assert not (tmp_path / "out.bam.tmp").exists()
        assert scope.counter_value("ccs_output_write_errors_total",
                                   sink="bam") == 1
        self._write_all(out)
        assert out.read_bytes() == control.read_bytes()

    def test_report_enospc_atomic(self, tmp_path):
        from pbccs_tpu_torch.io.report import write_report_file

        tally = tp.ResultTally()
        tally.tally(tp.Failure.SUCCESS)
        path = tmp_path / "report.csv"
        with faults.active("output.write:enospc~report@1*1"):
            with pytest.raises(OutputWriteError) as ei:
                write_report_file(str(path), tally)
        assert ei.value.sink == "report"
        assert not path.exists()
        assert not (tmp_path / "report.csv.tmp").exists()
        write_report_file(str(path), tally)
        assert "Success -- CCS generated,1" in path.read_text()


class TestCheckpointDiskFull:
    def _tallies(self):
        out = []
        for i in range(3):
            t = tp.ResultTally()
            t.tally(tp.Failure.SUCCESS)
            t.results.append(make_result(id=f"m/{i}"))
            out.append(t)
        return out

    def _restore_map(self, path, fp):
        restored = checkpoint.CheckpointJournal(str(path)).load(fp)
        return {i: [r.id for r in t.results] for i, t in restored.items()}

    def test_enospc_mid_record_then_resume_byte_identity(self, tmp_path):
        fp = {"v": 1}
        tallies = self._tallies()
        control = tmp_path / "control.ndjson"
        j = checkpoint.CheckpointJournal(str(control))
        j.start(fp, resume=False)
        for i, t in enumerate(tallies):
            j.record_chunk(i, t)
        j.close()
        want = self._restore_map(control, fp)

        path = tmp_path / "run.ndjson"
        j = checkpoint.CheckpointJournal(str(path))
        j.start(fp, resume=False)
        j.record_chunk(0, tallies[0])
        with faults.active("checkpoint.record:enospc@1*1"):
            with pytest.raises(OutputWriteError) as ei:
                j.record_chunk(1, tallies[1])
        assert ei.value.sink == "checkpoint"
        assert ei.value.bytes_written == path.stat().st_size
        with open(path, "ab") as fh:
            fh.write(b'{"type":"chunk","index":1,"cou')
        j2 = checkpoint.CheckpointJournal(str(path))
        assert sorted(j2.load(fp)) == [0]
        j2.start(fp, resume=True)
        for i in (1, 2):
            j2.record_chunk(i, tallies[i])
        j2.close()
        assert self._restore_map(path, fp) == want
        for line in path.read_bytes().splitlines():
            json.loads(line)

    def test_close_reraise_does_not_clobber_structured_error(
            self, tmp_path):
        class FullDiskFile:
            def write(self, data):
                return len(data)

            def tell(self):
                return 0

            def flush(self):
                raise OSError(errno.ENOSPC, "No space left on device")

            def close(self):
                raise OSError(errno.ENOSPC, "No space left on device")

        j = checkpoint.CheckpointJournal(str(tmp_path / "full.ndjson"))
        j.start({"v": 1}, resume=False)
        real_fh, j._fh = j._fh, FullDiskFile()
        try:
            with pytest.raises(OutputWriteError) as ei:
                j.record_chunk(0, self._tallies()[0])
        finally:
            real_fh.close()
        assert ei.value.sink == "checkpoint"
        assert j._fh is None

    def test_trim_noop_on_clean_journal(self, tmp_path):
        fp = {"v": 1}
        path = tmp_path / "clean.ndjson"
        j = checkpoint.CheckpointJournal(str(path))
        j.start(fp, resume=False)
        j.record_chunk(0, self._tallies()[0])
        j.close()
        before = path.read_bytes()
        j2 = checkpoint.CheckpointJournal(str(path))
        j2.load(fp)
        j2.start(fp, resume=True)
        j2.close()
        assert path.read_bytes() == before


class TestOomAdaptiveDispatch:
    """polish_prepared_batch's capacity governance with the dispatch
    stubbed, against pbccs_tpu's under the same stub: the same dispatch
    sizes, ceilings and counters."""

    def _run_both(self, monkeypatch, stub_of, n, batches=1, **kw):
        out = {}
        for name, mod, pol, reg in (("port", tp, "_guarded_dispatch",
                                     default_registry()),
                                    ("jax", jp, "_guarded_dispatch",
                                     jregistry())):
            sizes = []
            monkeypatch.setattr(mod, pol, stub_of(sizes, mod))
            scope = reg.scope()
            outs = [mod.polish_prepared_batch(
                [make_prep(f"m/{i}", mod=mod) for i in range(n)], **kw,
                **({"device": "cpu"} if mod is tp else {}))
                for _ in range(batches)]
            out[name] = (sizes, outs, scope)
        return out

    @staticmethod
    def _oom_above(limit):
        def stub_of(sizes, mod):
            def stub(preps, settings, *a, **kw):
                sizes.append(len(preps))
                if len(preps) > limit:
                    raise RuntimeError("RESOURCE_EXHAUSTED: out of memory "
                                       "allocating scratch")
                return [(mod.Failure.SUCCESS, None) for _ in preps]
            return stub
        return stub_of

    def test_oom_splits_and_records_ceiling(self, monkeypatch,
                                            fresh_governors):
        got = self._run_both(monkeypatch, self._oom_above(2), 6, batches=2)
        (sizes, outs, scope), (jsizes, _, jscope) = got["port"], got["jax"]
        assert sizes == jsizes
        assert sizes[0] == 6 and max(sizes[1:]) <= 3
        assert all(f == tp.Failure.SUCCESS for o in outs for f, _ in o)
        assert [len(o) for o in outs] == [6, 6]
        for name in ("ccs_resource_oom_splits_total",
                     "ccs_resource_oom_ceilings_total",
                     "ccs_resource_presplit_batches_total"):
            assert scope.counter_value(name) == \
                jscope.counter_value(name) >= 1, name
        assert resources.default_governor().snapshot() == \
            jres.default_governor().snapshot()

    def test_oom_singleton_serial_rescue_not_retry(self, monkeypatch,
                                                   fresh_governors):
        rescued = []

        def stub_dispatch(preps, settings, *a, **kw):
            raise RuntimeError("RESOURCE_EXHAUSTED: always")

        def stub_rescue(prep, settings, exc, **kw):
            rescued.append(prep.chunk.id)
            return (tp.Failure.OTHER, None)

        monkeypatch.setattr(tp, "_guarded_dispatch", stub_dispatch)
        monkeypatch.setattr(quarantine, "serial_rescue", stub_rescue)
        out = tp.polish_prepared_batch([make_prep(f"m/{i}")
                                        for i in range(4)], device="cpu")
        assert out == [(tp.Failure.OTHER, None)] * 4
        assert sorted(rescued) == [f"m/{i}" for i in range(4)]

    def test_injected_oom_at_polish_dispatch_splits(self, monkeypatch,
                                                    fresh_governors):
        sizes = []

        def spy(preps, settings, *a, **kw):
            sizes.append(len(preps))
            return [(tp.Failure.SUCCESS, None) for _ in preps]

        monkeypatch.setattr(tp, "_polish_batch_arrow", spy)
        scope = default_registry().scope()
        with faults.active("polish.dispatch:oom@1*1"):
            out = tp.polish_prepared_batch([make_prep(f"m/{i}")
                                            for i in range(4)], device="cpu")
        assert out == [(tp.Failure.SUCCESS, None)] * 4
        assert sizes == [2, 2]
        assert scope.counter_value("ccs_quarantined_zmws_total") == 0
        assert scope.counter_value("ccs_resource_oom_splits_total") == 1
        assert scope.counter_value(
            "ccs_retries_total", site="polish.dispatch") == 0

    @pytest.mark.parametrize("exc", [
        RuntimeError("CUDA error: an illegal memory access was encountered"),
        KernelError("arrow_fill: CUDA launch failed with error 719"),
        LaunchRefused("arrow_fill: band width 224 is not built"),
    ], ids=lambda e: type(e).__name__)
    def test_sticky_device_errors_never_retried(self, monkeypatch, exc):
        calls = []

        def boom(preps, settings, *a, **kw):
            calls.append(len(preps))
            raise exc

        monkeypatch.setattr(tp, "_polish_batch_arrow", boom)
        scope = default_registry().scope()
        with pytest.raises(type(exc)):
            tp.polish_prepared_batch([make_prep(f"m/{i}")
                                      for i in range(4)], device="cpu")
        assert calls == [4]
        assert scope.counter_value("ccs_retries_total",
                                   site="polish.dispatch") == 0


# ---------------------------------------- end to end: both packages' polish

N_E2E = 4
#: counters held equal between the packages (the bisection-dispatch
#: counter is not: see the module docstring)
E2E_COUNTERS = [("ccs_quarantined_zmws_total", {}),
                ("ccs_degraded_zmws_total", {}),
                ("ccs_retries_total", {"site": "polish.dispatch"}),
                ("ccs_watchdog_timeouts_total", {"site": "polish.dispatch"}),
                ("ccs_resource_oom_splits_total", {}),
                ("ccs_resource_oom_ceilings_total", {}),
                ("ccs_resource_presplit_batches_total", {}),
                ("ccs_checkpoint_records_total", {"kind": "written"})]


@pytest.fixture(scope="module")
def e2e():
    rng = np.random.default_rng(77)
    sims = [simulate_zmw(rng, 70, 4) for _ in range(N_E2E)]

    def chunks(mod):
        return [mod.Chunk(f"q/{z}", [mod.Subread(f"q/{z}/{i}", r)
                                     for i, r in enumerate(s[1])], s[3])
                for z, s in enumerate(sims)]

    clean = tp.process_chunks(chunks(tp), device="cpu")
    jclean = jp.process_chunks(chunks(jp))
    assert clean.counts[tp.Failure.SUCCESS] == N_E2E
    return {"chunks": chunks, "clean": {r.id: r for r in clean.results},
            "jclean": jclean}


def _same(a, b):
    assert a.sequence == b.sequence
    np.testing.assert_array_equal(a.qvs, b.qvs)
    np.testing.assert_array_equal(a.zscores, b.zscores)
    assert a.global_zscore == b.global_zscore or (
        np.isnan(a.global_zscore) and np.isnan(b.global_zscore))


E2E_SPECS = {
    "poison": ("polish.dispatch:error~q/1", {}),
    "poison_degraded": ("polish.dispatch:error~q/2",
                        {"degrade_quarantined": True}),
    "transient": ("polish.dispatch:error=transient*1", {}),
    "oom": ("polish.dispatch:oom@1*1", {}),
    "hang": ("polish.dispatch:delay=20*1", {}),
}


@pytest.mark.parametrize("case", sorted(E2E_SPECS))
def test_fault_recovery_matches_jax(e2e, case, fresh_governors):
    """One fault spec through both packages' process_chunks: the same
    tally and the same recovery counters; the port's survivors
    byte-equal to its fault-free run.  The hang case arms a 15 s
    watchdog in both, past a warm dispatch of this batch in either."""
    spec, kw = E2E_SPECS[case]
    scope, jscope = default_registry().scope(), jregistry().scope()
    deadline = 15.0 if case == "hang" else None
    watchdog.configure(deadline)
    jwd.configure(deadline)
    try:
        with faults.active(spec):
            mine = tp.process_chunks(e2e["chunks"](tp),
                                     tp.ConsensusSettings(**kw),
                                     device="cpu")
        with jfaults.active(spec):
            ref = jp.process_chunks(e2e["chunks"](jp),
                                    jp.ConsensusSettings(**kw))
    finally:
        watchdog.configure(None)
        jwd.configure(None)
        join_watchdog_threads()
    assert {f.value: c for f, c in mine.counts.items()} == \
        {f.value: c for f, c in ref.counts.items()}
    for name, labels in E2E_COUNTERS:
        assert scope.counter_value(name, **labels) == \
            jscope.counter_value(name, **labels), name
    poison = {"poison": "q/1", "poison_degraded": "q/2"}.get(case)
    for r in mine.results:
        if r.id == poison:
            assert r.draft_only and kw
            continue
        _same(r, e2e["clean"][r.id])
    expect = {"poison": ("ccs_quarantined_zmws_total", {}),
              "poison_degraded": ("ccs_degraded_zmws_total", {}),
              "transient": ("ccs_retries_total", {"site": "polish.dispatch"}),
              "oom": ("ccs_resource_oom_splits_total", {}),
              "hang": ("ccs_watchdog_timeouts_total",
                       {"site": "polish.dispatch"})}[case]
    assert scope.counter_value(expect[0], **expect[1]) == 1


# ------------------------------------------------ CLI: checkpoint / resume


def _cli_input(d):
    rng = np.random.default_rng(11)
    recs = []
    for hole in range(1, 5):
        _, reads, _, _ = simulate_zmw(rng, 70, 4)
        recs += [(f"movie1/{hole}/{i * 100}_{i * 100 + len(r)}",
                  decode_bases(r)) for i, r in enumerate(reads)]
    path = os.path.join(d, "in.fasta")
    write_fasta(path, recs)
    return path


def test_cli_checkpoint_killed_then_resumed(tmp_path):
    """--checkpoint with --chunkSize 1 over 4 ZMWs, killed by a
    workqueue.task fault on the third task: the journal keeps the
    completed chunks, and --resume restores them, computes the rest and
    writes the BAM, .pbi and report byte-identical to an uninterrupted
    run; the journal is gone at the end."""
    inp = _cli_input(str(tmp_path))
    common = ["--chunkSize", "1", "--numThreads", "1",
              "--skipChemistryCheck", "--logLevel", "WARN"]

    def argv(name, *extra):
        return [str(tmp_path / f"{name}.bam"), inp, "--reportFile",
                str(tmp_path / f"{name}.csv"), *common, *extra]

    assert run(argv("whole"), device="cpu") == 0
    ckpt = str(tmp_path / "run.ckpt")
    with pytest.raises(RuntimeError):
        run(argv("run", "--checkpoint", ckpt, "--faults",
                 "workqueue.task:error@3"), device="cpu")
    assert faults.get() is None
    done = [json.loads(line) for line in open(ckpt)]
    assert [r["type"] for r in done[:3]] == ["header", "chunk", "chunk"]
    scope = default_registry().scope()
    assert run(argv("run", "--checkpoint", ckpt, "--resume"),
               device="cpu") == 0
    assert scope.counter_value("ccs_checkpoint_records_total",
                               kind="restored") == len(done) - 1 >= 2
    assert scope.counter_value("ccs_checkpoint_records_total",
                               kind="written") == 4 - (len(done) - 1)
    for ext in (".bam", ".bam.pbi", ".csv"):
        assert open(tmp_path / f"run{ext}", "rb").read() == \
            open(tmp_path / f"whole{ext}", "rb").read(), ext
    assert not os.path.exists(ckpt)
