"""The port's serving tier (pbccs_tpu_torch/serve) on the CPU.

Counterparts of tests/test_serve.py's cases (dynamic batcher with a
fake clock, protocol, engine and TCP server with stub prep/polish
functions, so scheduling, backpressure, error containment and the wire
run without device work) and of tests/test_sched.py's four pool-mode
engine tests (CPU workers).  Then the parity tests against pbccs_tpu:

  * the two packages' protocol modules encode the same seeded messages
    to the same bytes and decode each other's;
  * pbccs_tpu's CcsClient completes against the port's CcsServer and
    the port's client against pbccs_tpu's server (stub polish);
  * four simulated ZMWs (numpy seed 20261017, one of them 2-pass)
    through the port's server with device="cpu": byte-equal to the
    port's polish_prepared_batch at the flush's pinned shapes, the same
    sequences as pbccs_tpu's process_chunks with QVs within 1.

And `ccs serve` as a process (run_serve with device="cpu" in a child):
CCS-SERVE-READY, /metrics and /healthz, SIGTERM drain with exit 0.
Every wait has a bound.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pbccs_tpu_torch.pipeline import (
    Chunk,
    ConsensusResult,
    Failure,
    PreparedZmw,
    Subread,
)
from pbccs_tpu_torch.serve import protocol
from pbccs_tpu_torch.serve.batcher import Batch, DynamicBatcher, PendingItem
from pbccs_tpu_torch.serve.client import CcsClient, ServeError
from pbccs_tpu_torch.serve.engine import (
    CcsEngine,
    EngineClosed,
    EngineOverloaded,
    ServeConfig,
)
from pbccs_tpu_torch.serve.server import CcsServer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QV_ATOL = 1

# ---------------------------------------------------------------- helpers


def item(key, t, wait=1.0, payload=None):
    return PendingItem(key=key, payload=payload, admit_t=t,
                       flush_by=t + wait)


def make_chunk(zmw_id="m/1", n_reads=4, length=20):
    seq = np.arange(length, dtype=np.int8) % 4
    return Chunk(zmw_id,
                 [Subread(f"{zmw_id}/{i}", seq.copy())
                  for i in range(n_reads)],
                 np.full(4, 8.0))


def stub_prep(tpl_len=64):
    """Prep stub: a PreparedZmw whose draft length selects the bucket."""
    def prep(chunk, settings):
        return None, PreparedZmw(chunk, np.zeros(tpl_len, np.int8),
                                 [], len(chunk.reads), 0, 0.0)
    return prep


def fake_result(zmw_id, sequence="ACGT"):
    return ConsensusResult(
        id=zmw_id, sequence=sequence,
        qvs=np.full(len(sequence), 40), num_passes=4,
        predicted_accuracy=0.999, global_zscore=0.0, avg_zscore=0.0,
        zscores=np.zeros(0), status_counts=[0] * 5, mutations_tested=0,
        mutations_applied=0, snr=np.full(4, 8.0), elapsed_ms=1.0)


def stub_polish(preps, settings):
    return [(Failure.SUCCESS, fake_result(p.chunk.id)) for p in preps]


def stub_engine(max_batch=4, max_wait_ms=50.0, max_pending=64,
                tpl_len=64, polish=stub_polish, **kw):
    return CcsEngine(
        device="cpu",
        config=ServeConfig(max_batch=max_batch, max_wait_ms=max_wait_ms,
                           max_pending=max_pending, **kw),
        prep_fn=stub_prep(tpl_len), polish_fn=polish)


# ---------------------------------------------------------------- batcher


class TestDynamicBatcher:
    def test_fill_triggered_flush(self):
        b = DynamicBatcher(max_batch=3)
        assert b.add(item("k", 0.0)) is None
        assert b.add(item("k", 0.1)) is None
        batch = b.add(item("k", 0.2))
        assert isinstance(batch, Batch)
        assert batch.reason == "fill"
        assert batch.key == "k"
        assert [i.admit_t for i in batch.items] == [0.0, 0.1, 0.2]
        assert b.pending_count() == 0

    def test_bucket_selection_keeps_keys_apart(self):
        """Items only co-batch within their length bucket."""
        b = DynamicBatcher(max_batch=2)
        assert b.add(item((64, 128), 0.0)) is None
        assert b.add(item((256, 128), 0.0)) is None
        assert b.pending_count() == 2  # two singleton buckets, no flush
        batch = b.add(item((64, 128), 0.1))
        assert batch is not None and batch.key == (64, 128)
        assert len(batch.items) == 2
        # the other bucket is untouched
        assert b.pending_count() == 1
        assert b.depth_by_bucket() == {str((256, 128)): 1}

    def test_deadline_triggered_flush(self):
        b = DynamicBatcher(max_batch=10)
        b.add(item("a", 0.0, wait=1.0))
        b.add(item("a", 0.5, wait=1.0))   # younger: flush_by 1.5
        b.add(item("b", 0.9, wait=1.0))
        assert b.due(0.99) == []          # nothing expired yet
        batches = b.due(1.0)              # bucket a's OLDEST expires at 1.0
        assert [bt.key for bt in batches] == ["a"]
        assert batches[0].reason == "deadline"
        # the whole bucket ships, including the younger item
        assert len(batches[0].items) == 2
        assert b.pending_count() == 1     # bucket b still waiting
        assert b.due(1.89) == []
        assert [bt.key for bt in b.due(1.9)] == ["b"]

    def test_next_deadline_tracks_oldest(self):
        b = DynamicBatcher(max_batch=10)
        assert b.next_deadline() is None
        b.add(item("a", 1.0, wait=2.0))
        b.add(item("b", 0.5, wait=1.0))
        assert b.next_deadline() == 1.5
        assert [bt.key for bt in b.due(1.6)] == ["b"]
        assert b.next_deadline() == 3.0

    def test_drain(self):
        b = DynamicBatcher(max_batch=10)
        b.add(item("a", 0.0))
        b.add(item("b", 0.0))
        batches = b.drain()
        assert {bt.key for bt in batches} == {"a", "b"}
        assert all(bt.reason == "drain" for bt in batches)
        assert b.pending_count() == 0 and b.next_deadline() is None

    def test_length_bucket_key(self):
        """The bucket key is the shape bucket of parallel.batch (the
        same key as pbccs_tpu's): nearby lengths share it, far lengths
        split."""
        from pbccs_tpu_torch.parallel.batch import length_bucket

        assert length_bucket(100, 110) == length_bucket(105, 112)
        j_small, _ = length_bucket(100, 110)
        j_large, _ = length_bucket(1000, 110)
        assert j_small != j_large
        _, i_small = length_bucket(100, 110)
        _, i_large = length_bucket(100, 1100)
        assert i_small != i_large


# --------------------------------------------------------------- protocol


class TestProtocol:
    def test_chunk_round_trip(self):
        chunk = make_chunk("movie/7", n_reads=3, length=12)
        wire = protocol.chunk_to_wire(chunk)
        back = protocol.chunk_from_wire(wire)
        assert back.id == chunk.id
        np.testing.assert_allclose(back.snr, chunk.snr)
        assert len(back.reads) == 3
        for a, b in zip(chunk.reads, back.reads):
            assert a.id == b.id and a.flags == b.flags
            np.testing.assert_array_equal(a.seq, b.seq)

    def test_decode_line_errors(self):
        with pytest.raises(protocol.ProtocolError):
            protocol.decode_line(b"not json")
        with pytest.raises(protocol.ProtocolError):
            protocol.decode_line(b"[1, 2]")
        msg = protocol.decode_line(protocol.encode_msg({"verb": "ping"}))
        assert msg == {"verb": "ping"}

    @pytest.mark.parametrize("zmw", [
        None, "str", {}, {"id": "m/1"},
        {"id": "m/1", "reads": []},
        {"id": "m/1", "snr": [1, 2, 3], "reads": [{"seq": "ACGT"}]},
        {"id": "m/1", "reads": [{"seq": 5}]},
    ])
    def test_chunk_from_wire_rejects(self, zmw):
        with pytest.raises(protocol.ProtocolError):
            protocol.chunk_from_wire(zmw)

    def test_result_to_wire(self):
        ok = protocol.result_to_wire("r1", "m/1", Failure.SUCCESS,
                                     fake_result("m/1", "ACGT"), 12.5)
        assert ok["type"] == "result" and ok["status"] == "Success"
        assert ok["sequence"] == "ACGT" and len(ok["qual"]) == 4
        gate = protocol.result_to_wire("r2", "m/2", Failure.TOO_FEW_PASSES,
                                       None, 3.0)
        assert gate["status"] == "TooFewPasses"
        assert "sequence" not in gate


# ----------------------------------------------------------------- engine


class TestEngine:
    def test_fill_flush_completes_requests(self):
        with stub_engine(max_batch=2, max_wait_ms=60_000.0) as eng:
            r1 = eng.submit(make_chunk("m/1"))
            r2 = eng.submit(make_chunk("m/2"))  # tops off the bucket
            assert r1.wait(10.0) and r2.wait(10.0)
            assert r1.failure == Failure.SUCCESS
            assert r1.result.id == "m/1" and r2.result.id == "m/2"
            assert r1.latency_ms > 0

    def test_deadline_flush_completes_a_lone_request(self):
        # bucket can never fill (max_batch huge): only the max-wait flush
        # can complete this request
        with stub_engine(max_batch=1000, max_wait_ms=50.0) as eng:
            t0 = time.monotonic()
            req = eng.submit(make_chunk("m/1"))
            assert req.wait(10.0)
            assert req.failure == Failure.SUCCESS
            assert time.monotonic() - t0 >= 0.045  # waited for the flush

    def test_deadline_slack_beats_max_wait(self):
        # a tight per-request deadline flushes BEFORE the engine max-wait
        with stub_engine(max_batch=1000, max_wait_ms=60_000.0) as eng:
            req = eng.submit(make_chunk("m/1"), deadline_ms=80.0)
            assert req.wait(10.0)
            assert req.failure == Failure.SUCCESS

    def test_out_of_order_completion_across_buckets(self):
        """A later-submitted small-bucket request completes while an
        earlier request still waits on its (slower) bucket."""
        order = []
        gate = threading.Event()

        def polish(preps, settings):
            if len(preps[0].css) == 512:  # the slow bucket
                gate.wait(10.0)
            return stub_polish(preps, settings)

        # two buckets: tpl_len differs enough to split the Jmax bucket
        cfg = ServeConfig(max_batch=1, max_wait_ms=60_000.0,
                          polish_workers=2)

        def prep(chunk, settings):
            L = 512 if chunk.id.startswith("slow") else 64
            return None, PreparedZmw(chunk, np.zeros(L, np.int8), [],
                                     1, 0, 0.0)

        with CcsEngine(device="cpu", config=cfg, prep_fn=prep,
                       polish_fn=polish) as eng:
            slow = eng.submit(make_chunk("slow/1"),
                              callback=lambda r: order.append(r.chunk.id))
            fast = eng.submit(make_chunk("fast/1"),
                              callback=lambda r: order.append(r.chunk.id))
            assert fast.wait(10.0)       # completes while slow is blocked
            assert not slow.done.is_set()
            gate.set()
            assert slow.wait(10.0)
            assert order == ["fast/1", "slow/1"]

    def test_backpressure_overloaded(self):
        gate = threading.Event()

        def polish(preps, settings):
            gate.wait(10.0)
            return stub_polish(preps, settings)

        eng = stub_engine(max_batch=1, max_wait_ms=60_000.0,
                          max_pending=2, polish=polish).start()
        try:
            eng.submit(make_chunk("m/1"))
            eng.submit(make_chunk("m/2"))
            with pytest.raises(EngineOverloaded):
                eng.submit(make_chunk("m/3"))
            assert eng.status()["rejected"] == 1
            gate.set()  # drain; slots free as requests complete
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                try:
                    req = eng.submit(make_chunk("m/4"))
                    break
                except EngineOverloaded:
                    time.sleep(0.01)
            else:
                pytest.fail("admission never recovered after drain")
            assert req.wait(10.0)
        finally:
            gate.set()
            eng.close()

    def test_raising_polish_fails_batch_not_engine(self):
        calls = []

        def polish(preps, settings):
            calls.append(len(preps))
            if len(calls) == 1:
                raise RuntimeError("device on fire")
            return stub_polish(preps, settings)

        with stub_engine(max_batch=1, max_wait_ms=60_000.0,
                         polish=polish) as eng:
            bad = eng.submit(make_chunk("m/1"))
            assert bad.wait(10.0)
            assert bad.error is not None and "device on fire" in bad.error
            assert bad.result is None
            # the engine keeps serving after the failed batch
            ok = eng.submit(make_chunk("m/2"))
            assert ok.wait(10.0)
            assert ok.failure == Failure.SUCCESS
            assert eng.status()["errors"] == 1

    def test_raising_prep_fails_request_not_engine(self):
        def prep(chunk, settings):
            if chunk.id == "m/boom":
                raise ValueError("bad zmw")
            return stub_prep()(chunk, settings)

        with CcsEngine(device="cpu",
                       config=ServeConfig(max_batch=1,
                                          max_wait_ms=60_000.0),
                       prep_fn=prep, polish_fn=stub_polish) as eng:
            bad = eng.submit(make_chunk("m/boom"))
            ok = eng.submit(make_chunk("m/2"))
            assert bad.wait(10.0) and ok.wait(10.0)
            assert bad.error is not None and ok.failure == Failure.SUCCESS

    def test_prep_gate_failure_skips_polish(self):
        def prep(chunk, settings):
            return Failure.TOO_FEW_PASSES, None

        polished = []

        def polish(preps, settings):
            polished.append(1)
            return stub_polish(preps, settings)

        with CcsEngine(device="cpu",
                       config=ServeConfig(max_batch=1,
                                          max_wait_ms=60_000.0),
                       prep_fn=prep, polish_fn=polish) as eng:
            req = eng.submit(make_chunk("m/1"))
            assert req.wait(10.0)
            assert req.failure == Failure.TOO_FEW_PASSES
            assert req.result is None and not polished

    def test_min_read_score_gate_matches_offline(self):
        """The offline CLI's --minReadScore input gate applies at
        admission: low-accuracy reads never reach prep."""
        seen = []

        def prep(chunk, settings):
            seen.append([r.id for r in chunk.reads])
            return Failure.NO_SUBREADS, None

        with CcsEngine(device="cpu",
                       config=ServeConfig(max_batch=1,
                                          max_wait_ms=60_000.0,
                                          min_read_score=0.75),
                       prep_fn=prep, polish_fn=stub_polish) as eng:
            chunk = make_chunk("m/1", n_reads=3)
            chunk.reads[1].read_accuracy = 0.5   # below the gate
            req = eng.submit(chunk)
            assert req.wait(10.0)
        assert seen == [["m/1/0", "m/1/2"]]

    def test_closed_engine_rejects(self):
        eng = stub_engine()
        with pytest.raises(EngineClosed):
            eng.submit(make_chunk("m/1"))  # never started
        eng.start()
        eng.close()
        with pytest.raises(EngineClosed):
            eng.submit(make_chunk("m/1"))

    def test_close_drains_pending(self):
        with stub_engine(max_batch=1000, max_wait_ms=60_000.0) as eng:
            # neither fill nor max-wait can flush this before close();
            # the shutdown drain must ship it
            req = eng.submit(make_chunk("m/1"))
        assert req.done.is_set()
        assert req.failure == Failure.SUCCESS

    def test_status_shape(self):
        with stub_engine() as eng:
            req = eng.submit(make_chunk("m/1"))
            req.wait(10.0)
            st = eng.status()
            for key in ("queue_depth", "bucketed", "in_flight_batches",
                        "stage_seconds", "device_fetches", "pending",
                        "admitted", "completed", "uptime_s"):
                assert key in st
            assert st["admitted"] == st["completed"] == 1


# ----------------------------------------------------------------- server


@pytest.fixture
def serve_stack():
    """Engine (stubbed pipeline) + TCP server on an ephemeral port."""
    eng = stub_engine(max_batch=2, max_wait_ms=50.0, max_pending=8).start()
    srv = CcsServer(eng, port=0).start()
    yield srv
    srv.shutdown()
    eng.close()


class TestServer:
    def test_submit_streams_results(self, serve_stack):
        with CcsClient(serve_stack.host, serve_stack.port) as cli:
            handles = [cli.submit(f"m/{i}", ["ACGTACGT"] * 4)
                       for i in range(5)]
            for i, h in enumerate(handles):
                msg = h.reply(timeout=10.0)
                assert msg["status"] == "Success"
                assert msg["zmw"] == f"m/{i}"
                assert msg["sequence"] == "ACGT"
                assert msg["latency_ms"] > 0

    def test_drain_notice_never_overtakes_a_reply(self, serve_stack,
                                                  monkeypatch):
        """A drain's `closed` notice goes to a session holding no slot,
        and the notice shuts the socket: a reply frees its slot and is
        written under the session's write lock, so a drain landing in
        between waits for the reply instead of dropping it."""
        from pbccs_tpu_torch.serve import server as server_mod

        release = server_mod._FramedSession._release_slot
        drains = []

        def release_then_drain(session):
            release(session)
            t = threading.Thread(target=serve_stack.notify_draining)
            t.start()
            drains.append(t)
            t.join(timeout=0.5)   # the drain runs before this reply is sent

        monkeypatch.setattr(server_mod._FramedSession, "_release_slot",
                            release_then_drain)
        with CcsClient(serve_stack.host, serve_stack.port) as cli:
            msg = cli.submit("m/0", ["ACGTACGT"] * 4).reply(timeout=10.0)
            assert msg["status"] == "Success"
        for t in drains:
            t.join(timeout=10.0)
            assert not t.is_alive()

    def test_status_and_ping(self, serve_stack):
        with CcsClient(serve_stack.host, serve_stack.port) as cli:
            cli.ping()
            st = cli.status()
            assert st["engine"] == "ccs-serve"
            assert st["sessions"] == 1
            assert "stage_seconds" in st and "in_flight_batches" in st

    def test_malformed_frame_keeps_session(self, serve_stack):
        raw = socket.create_connection(
            (serve_stack.host, serve_stack.port), timeout=10.0)
        rf = raw.makefile("rb")
        raw.sendall(b"{broken\n")
        err = protocol.decode_line(rf.readline())
        assert err["type"] == "error" and err["code"] == "bad_request"
        # same session still answers
        raw.sendall(protocol.encode_msg({"verb": "ping", "id": "p"}))
        assert protocol.decode_line(rf.readline())["type"] == "pong"
        raw.close()

    def test_invalid_zmw_is_structured_error(self, serve_stack):
        with CcsClient(serve_stack.host, serve_stack.port) as cli:
            handle = cli.submit_wire({"id": "m/1", "reads": []})
            with pytest.raises(ServeError) as ei:
                handle.reply(timeout=10.0)
            assert ei.value.code == "bad_request"

    def test_unknown_verb(self, serve_stack):
        raw = socket.create_connection(
            (serve_stack.host, serve_stack.port), timeout=10.0)
        rf = raw.makefile("rb")
        raw.sendall(protocol.encode_msg({"verb": "frobnicate", "id": "x"}))
        err = protocol.decode_line(rf.readline())
        assert err["code"] == "bad_request" and "frobnicate" in err["error"]
        raw.close()

    def test_disconnect_mid_stream_server_survives(self, serve_stack):
        cli = CcsClient(serve_stack.host, serve_stack.port)
        cli.submit("gone/1", ["ACGTACGT"] * 4)
        cli.close()  # vanish with a request in flight
        # the server keeps serving other sessions
        with CcsClient(serve_stack.host, serve_stack.port) as cli2:
            msg = cli2.submit("m/2", ["ACGTACGT"] * 4).reply(timeout=10.0)
            assert msg["status"] == "Success"
            # the orphaned request still completed engine-side
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if cli2.status()["pending"] == 0:
                    break
                time.sleep(0.02)
            assert cli2.status()["pending"] == 0

    def test_overloaded_reply(self):
        gate = threading.Event()

        def polish(preps, settings):
            gate.wait(10.0)
            return stub_polish(preps, settings)

        eng = stub_engine(max_batch=1, max_wait_ms=60_000.0, max_pending=1,
                          polish=polish).start()
        srv = CcsServer(eng, port=0).start()
        try:
            with CcsClient(srv.host, srv.port) as cli:
                first = cli.submit("m/1", ["ACGTACGT"] * 4)
                # second submit exceeds max_pending -> structured reply
                deadline = time.monotonic() + 10.0
                code = None
                while time.monotonic() < deadline:
                    try:
                        cli.submit("m/2", ["ACGTACGT"] * 4).reply(10.0)
                    except ServeError as e:
                        code = e.code
                        break
                    time.sleep(0.01)
                assert code == "overloaded"
                gate.set()
                assert first.reply(timeout=10.0)["status"] == "Success"
        finally:
            gate.set()
            srv.shutdown()
            eng.close()

    def test_concurrent_sessions(self, serve_stack):
        results = {}
        lock = threading.Lock()

        def one(i):
            with CcsClient(serve_stack.host, serve_stack.port) as cli:
                msg = cli.submit(f"c{i}/1",
                                 ["ACGTACGT"] * 4).reply(timeout=10.0)
                with lock:
                    results[i] = msg["status"]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15.0)
        assert results == {i: "Success" for i in range(4)}


# ------------------------------------------------------ pool mode (sched)


def _pool_prep(chunk, settings):
    return None, PreparedZmw(chunk, np.zeros(12, np.int8), [], 0, 0, 0.0)


def _pool_polish_ok(preps, settings):
    return [(Failure.SUCCESS, None) for _ in preps]


def make_chunks(n):
    return [make_chunk(f"m/{i}") for i in range(n)]


def test_engine_pool_mode_completes_and_reports():
    cfg = ServeConfig(max_batch=4, max_wait_ms=20.0, devices=4)
    with CcsEngine(config=cfg, prep_fn=_pool_prep,
                   polish_fn=_pool_polish_ok, device="cpu") as eng:
        reqs = [eng.submit(c) for c in make_chunks(10)]
        for r in reqs:
            assert r.wait(60.0)
            assert r.error is None
        st = eng.status()
        assert st["sched"]["policy"] == "sticky"
        assert [d["device"] for d in st["sched"]["devices"]] == \
            ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
        assert sum(d["tasks_done"] for d in st["sched"]["devices"]) >= 1
    # pool is torn down with the engine
    assert eng._pool is None


def test_engine_pool_mode_survives_benched_device():
    from pbccs_tpu_torch.obs.metrics import default_registry
    from pbccs_tpu_torch.resilience import faults

    scope = default_registry().scope()
    cfg = ServeConfig(max_batch=2, max_wait_ms=20.0, devices=3)
    eng = CcsEngine(config=cfg, prep_fn=_pool_prep,
                    polish_fn=_pool_polish_ok, device="cpu")
    eng.start()
    try:
        bad = eng._pool._workers[0].name
        with faults.active(f"sched.dispatch:error~{bad}"):
            reqs = [eng.submit(c) for c in make_chunks(8)]
            for r in reqs:
                assert r.wait(60.0)
                # requeue to a healthy device: every request SUCCEEDS
                assert r.error is None, r.error
        assert scope.counter_value("ccs_sched_requeues_total") >= 1
        assert len(eng.status()["sched"]["devices"]) == 3
    finally:
        eng.close()


def test_engine_fleet_timeout_fails_after_two_devices_not_a_tour():
    """A polish that outlives the serve watchdog on TWO different devices
    is workload-shaped: the batch fails after the second expiry, without
    touring every device or benching healthy ones."""
    attempts = []

    def slow_polish(preps, settings):
        attempts.append(1)
        time.sleep(1.0)
        return [(Failure.SUCCESS, None) for _ in preps]

    cfg = ServeConfig(max_batch=4, max_wait_ms=10.0, devices=4,
                      polish_timeout_ms=150.0)
    eng = CcsEngine(config=cfg, prep_fn=_pool_prep, polish_fn=slow_polish,
                    device="cpu")
    eng.start()
    try:
        reqs = [eng.submit(c) for c in make_chunks(2)]
        for r in reqs:
            assert r.wait(60.0)
            assert r.error is not None
        assert len(attempts) == 2        # one requeue, then surfaced
        benched = [d for d in eng.status()["sched"]["devices"]
                   if d["benched"]]
        assert not benched               # no healthy device benched
    finally:
        eng.close()


def test_engine_single_device_default_unchanged():
    with CcsEngine(config=ServeConfig(max_batch=2, max_wait_ms=20.0),
                   prep_fn=_pool_prep, polish_fn=_pool_polish_ok,
                   device="cpu") as eng:
        reqs = [eng.submit(c) for c in make_chunks(4)]
        for r in reqs:
            assert r.wait(30.0)
        assert eng._pool is None
        assert "sched" not in eng.status()


# ------------------------------------------------------- device errors


def _kernel_error_polish(preps, settings):
    from pbccs_tpu_torch.ops.cuda_lib import KernelError

    raise KernelError("arrow_fill: launch failed")


@pytest.mark.parametrize("devices", [1, 0], ids=["executor", "pool"])
def test_device_error_is_a_structured_reply_and_serving_goes_on(devices):
    """A device-shaped failure fails the batch's requests with an error
    naming it; later submits complete too (errors again, as on a card
    whose context is lost), none hangs.  In pool mode the one worker is
    the last healthy device: struck, never benched."""
    cfg = ServeConfig(max_batch=2, max_wait_ms=20.0, devices=devices)
    with CcsEngine(config=cfg, prep_fn=_pool_prep,
                   polish_fn=_kernel_error_polish, device="cpu") as eng:
        first = [eng.submit(c) for c in make_chunks(2)]
        for r in first:
            assert r.wait(30.0)
            assert r.error is not None and "KernelError" in r.error
        later = eng.submit(make_chunk("m/later"))
        assert later.wait(30.0)
        assert later.error is not None and "KernelError" in later.error
        st = eng.status()
        assert st["errors"] == 3 and st["pending"] == 0
        if devices == 0:
            (dev,) = st["sched"]["devices"]
            assert dev["device"] == "cpu:0" and not dev["benched"]


def test_engine_needs_a_card_by_default(monkeypatch):
    """No CUDA device and no device="cpu": the engine raises at
    construction instead of serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CcsEngine(prep_fn=_pool_prep, polish_fn=_pool_polish_ok)


def test_flush_buckets_pin_z_to_a_power_of_two():
    """A flush polishes at the batch path's (Imax, Jmax, R) of its ZMWs
    and Z = next_pow2(n, 4)."""
    from pbccs_tpu_torch.parallel.batch import effective_shapes
    from pbccs_tpu_torch.pipeline import MappedRead
    from pbccs_tpu_torch.serve.engine import flush_buckets

    def prep(n_reads, tpl_len, read_len):
        mapped = [MappedRead(f"m/1/{i}", np.zeros(read_len, np.int8), 0,
                             0, tpl_len, True) for i in range(n_reads)]
        return PreparedZmw(make_chunk("m/1"), np.zeros(tpl_len, np.int8),
                           mapped, n_reads, 0, 0.0)

    preps = [prep(5, 200, 210), prep(9, 230, 260), prep(3, 180, 190)]
    imax, jmax, r, _ = effective_shapes(3, 9, 260, 230)
    assert flush_buckets(preps) == (imax, jmax, r, 4)
    assert flush_buckets(preps * 2)[3] == 8
    assert flush_buckets(preps[:1])[3] == 4


# ------------------------------------------------ parity with pbccs_tpu

BASES = np.array(list("ACGT"))


def seeded_wire_messages(seed=20261017):
    """Seeded ZMW payloads, results, errors and verb frames: the same
    content as (port object, pbccs_tpu object) pairs."""
    import pbccs_tpu.pipeline as jpipe

    rng = np.random.default_rng(seed)
    out = []
    for z in range(6):
        reads = ["".join(BASES[rng.integers(0, 4, int(rng.integers(8, 40)))])
                 for _ in range(int(rng.integers(1, 6)))]
        snr = [float(x) for x in rng.uniform(3.0, 12.0, 4)]
        flags = [int(rng.integers(0, 4)) for _ in reads]
        acc = [float(x) for x in rng.uniform(0.6, 0.95, len(reads))]
        pair = []
        for mod in (__import__("pbccs_tpu_torch.pipeline",
                               fromlist=["Chunk"]), jpipe):
            pair.append(mod.Chunk(
                f"movie/{z}",
                [mod.Subread.from_str(f"movie/{z}/{i}", r, flags=f,
                                      read_accuracy=a)
                 for i, (r, f, a) in enumerate(zip(reads, flags, acc))],
                np.asarray(snr)))
        seq = "".join(BASES[rng.integers(0, 4, int(rng.integers(1, 30)))])
        qvs = rng.integers(0, 100, len(seq))
        fields = dict(
            id=f"movie/{z}", sequence=seq, qvs=qvs,
            num_passes=int(rng.integers(1, 12)),
            predicted_accuracy=float(rng.uniform(0.9, 1.0)),
            global_zscore=float(rng.normal()),
            avg_zscore=float(rng.normal()) if z % 3 else float("nan"),
            zscores=np.zeros(0), status_counts=[0] * 5,
            mutations_tested=0, mutations_applied=0, snr=np.asarray(snr),
            elapsed_ms=1.0, draft_only=bool(z == 4))
        out.append((pair, (ConsensusResult(**fields),
                           jpipe.ConsensusResult(**fields)),
                    float(rng.uniform(0.0, 900.0))))
    return out


def test_protocol_bytes_match_pbccs_tpu():
    """Both protocol modules encode the same seeded messages to the same
    bytes, decode each other's, and declare the same wire tables."""
    import pbccs_tpu.pipeline as jpipe
    from pbccs_tpu.serve import protocol as jproto

    for name in ("PROTOCOL_VERSION", "WIRE_VERBS", "WIRE_REPLIES",
                 "WIRE_UNSOLICITED", "WIRE_ERRORS", "WIRE_FIELDS",
                 "METRICS_CONTENT_TYPE"):
        assert getattr(protocol, name) == getattr(jproto, name), name
    for (tc, jc), (tr, jr), lat in seeded_wire_messages():
        frames = [
            ({"verb": "submit", "id": tc.id, "deadline_ms": lat,
              "zmw": protocol.chunk_to_wire(tc),
              "trace": {"trace_id": "ab" * 8, "span_id": "x-1"}},
             {"verb": "submit", "id": jc.id, "deadline_ms": lat,
              "zmw": jproto.chunk_to_wire(jc),
              "trace": {"trace_id": "ab" * 8, "span_id": "x-1"}}),
            (protocol.result_to_wire("r1", tr.id, Failure.SUCCESS, tr, lat),
             jproto.result_to_wire("r1", jr.id, jpipe.Failure.SUCCESS, jr,
                                   lat)),
            (protocol.result_to_wire("r2", tr.id, Failure.TOO_FEW_PASSES,
                                     None, lat),
             jproto.result_to_wire("r2", jr.id,
                                   jpipe.Failure.TOO_FEW_PASSES, None, lat)),
            (protocol.error_to_wire("r3", protocol.ERR_OVERLOADED, "busy",
                                    retry_after_ms=lat),
             jproto.error_to_wire("r3", jproto.ERR_OVERLOADED, "busy",
                                  retry_after_ms=lat)),
        ]
        for mine, ref in frames:
            assert protocol.encode_msg(mine) == jproto.encode_msg(ref)
        mine_bytes = protocol.encode_msg(frames[0][0])
        ref_bytes = jproto.encode_msg(frames[0][1])
        back = protocol.chunk_from_wire(protocol.decode_line(ref_bytes)["zmw"])
        jback = jproto.chunk_from_wire(jproto.decode_line(mine_bytes)["zmw"])
        for a, b in zip(back.reads, jback.reads):
            assert a.id == b.id and a.flags == b.flags
            assert a.read_accuracy == b.read_accuracy
            np.testing.assert_array_equal(a.seq, np.asarray(b.seq))
        np.testing.assert_array_equal(back.snr, jback.snr)
        for decode in (protocol.trace_from_wire, jproto.trace_from_wire):
            assert decode(frames[0][0]["trace"]) == \
                {"trace_id": "ab" * 8, "span_id": "x-1"}
        assert protocol.tenant_from_wire({"name": "a"}) == \
            jproto.tenant_from_wire({"name": "a"})


def _jax_stub_engine():
    import pbccs_tpu.pipeline as jpipe
    from pbccs_tpu.serve.engine import CcsEngine as JEngine
    from pbccs_tpu.serve.engine import ServeConfig as JConfig

    def prep(chunk, settings):
        return None, jpipe.PreparedZmw(chunk, np.zeros(64, np.int8), [],
                                       len(chunk.reads), 0, 0.0)

    def polish(preps, settings):
        return [(jpipe.Failure.SUCCESS, jpipe.ConsensusResult(
            id=p.chunk.id, sequence="ACGT", qvs=np.full(4, 40),
            num_passes=4, predicted_accuracy=0.999, global_zscore=0.0,
            avg_zscore=0.0, zscores=np.zeros(0), status_counts=[0] * 5,
            mutations_tested=0, mutations_applied=0, snr=np.full(4, 8.0),
            elapsed_ms=1.0)) for p in preps]

    return JEngine(config=JConfig(max_batch=2, max_wait_ms=50.0,
                                  max_pending=8),
                   prep_fn=prep, polish_fn=polish)


@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_clients_and_servers_interoperate(direction):
    """pbccs_tpu's CcsClient against the port's CcsServer, and the port's
    client against pbccs_tpu's server: results, structured errors,
    status and ping cross the wire both ways (stub polish)."""
    from pbccs_tpu.serve.client import CcsClient as JClient
    from pbccs_tpu.serve.client import ServeError as JServeError
    from pbccs_tpu.serve.server import CcsServer as JServer

    if direction == "jax_client_port_server":
        eng = stub_engine(max_batch=2, max_wait_ms=50.0, max_pending=8)
        server_cls, client_cls, error_cls = CcsServer, JClient, JServeError
    else:
        eng = _jax_stub_engine()
        server_cls, client_cls, error_cls = JServer, CcsClient, ServeError
    eng.start()
    srv = server_cls(eng, port=0).start()
    try:
        with client_cls(srv.host, srv.port, timeout=10.0) as cli:
            handles = [cli.submit(f"m/{i}", ["ACGTACGT"] * 4)
                       for i in range(3)]
            for i, h in enumerate(handles):
                msg = h.reply(timeout=10.0)
                assert (msg["type"], msg["status"], msg["zmw"],
                        msg["sequence"], msg["qual"]) == \
                    ("result", "Success", f"m/{i}", "ACGT", "IIII")
            with pytest.raises(error_cls) as ei:
                cli.submit_wire({"id": "m/9", "reads": []}).reply(10.0)
            assert ei.value.code == "bad_request"
            cli.ping()
            st = cli.status()
            assert st["engine"] == "ccs-serve" and st["completed"] == 3
            assert "ccs_serve_completed_total" in cli.metrics()
    finally:
        srv.shutdown()
        eng.close()


def serve_chunks(seed=20261017):
    """Four simulated ZMWs (L = 100), the second one 2-pass, for both
    packages."""
    import pbccs_tpu.pipeline as jpipe
    import pbccs_tpu_torch.pipeline as tpipe
    from pbccs_tpu_torch.simulate import simulate_zmw

    rng = np.random.default_rng(seed)
    jc, tc = [], []
    for z in range(4):
        _, reads, _, snr = simulate_zmw(rng, 100, 6 if z != 1 else 2)
        ids = [f"serve/{z}/{i}" for i in range(len(reads))]
        jc.append(jpipe.Chunk(f"serve/{z}", [jpipe.Subread(i, r)
                                             for i, r in zip(ids, reads)],
                              snr))
        tc.append(tpipe.Chunk(f"serve/{z}", [tpipe.Subread(i, r)
                                             for i, r in zip(ids, reads)],
                              snr))
    return jc, tc


def test_served_zmws_match_the_batch_path_and_pbccs_tpu():
    """The port's server on the CPU (real prep and polish): each reply is
    byte-equal to the port's polish_prepared_batch at the flush's pinned
    shapes, and has pbccs_tpu's process_chunks sequence with QVs within
    1.  max_batch 4 and one prep worker make the four ZMWs one fill
    flush, in submit order (the 2-pass ZMW fails the polish's pass
    gate)."""
    import pbccs_tpu.pipeline as jpipe
    from pbccs_tpu_torch.pipeline import (ConsensusSettings,
                                          polish_prepared_batch,
                                          prepare_chunk)
    from pbccs_tpu_torch.serve.engine import flush_buckets

    jc, tc = serve_chunks()
    cfg = ServeConfig(max_batch=4, max_wait_ms=60_000.0, prep_workers=1)
    with CcsEngine(config=cfg, device="cpu") as eng:
        srv = CcsServer(eng, port=0).start()
        try:
            with CcsClient(srv.host, srv.port, timeout=300.0) as cli:
                handles = [cli.submit_chunk(c) for c in tc]
                replies = [h.reply(timeout=300.0) for h in handles]
        finally:
            srv.shutdown()
    assert [r["status"] for r in replies] == \
        ["Success", "TooFewPasses", "Success", "Success"]

    settings = ConsensusSettings()
    preps = [prepare_chunk(c, settings)[1] for c in tc]
    batch = polish_prepared_batch(preps, settings, device="cpu",
                                  buckets=flush_buckets(preps))
    for reply, prep, (failure, result) in zip(replies, preps, batch):
        ref = protocol.result_to_wire(reply["id"], prep.chunk.id, failure,
                                      result, reply["latency_ms"])
        assert protocol.encode_msg(reply) == protocol.encode_msg(ref)
    served = [r for r in replies if r["status"] == "Success"]

    offline = {r.id: r for r in jpipe.process_chunks(jc).results}
    assert sorted(offline) == sorted(r["zmw"] for r in served)
    for reply in served:
        ref = offline[reply["zmw"]]
        assert reply["sequence"] == ref.sequence
        # the wire's phred+33 clamps QVs at 93
        qvs = np.frombuffer(reply["qual"].encode(), np.uint8).astype(int) - 33
        ref_qvs = np.minimum(ref.qvs.astype(int), 93)
        assert np.abs(qvs - ref_qvs).max() <= QV_ATOL


# ------------------------------------------------------ `ccs serve` process

SERVE_CHILD = ("import sys\n"
               "from pbccs_tpu_torch.serve.server import run_serve\n"
               "sys.exit(run_serve(sys.argv[1:], device='cpu'))\n")


def _http_get(host: str, port: int, path: str) -> tuple[int, bytes]:
    """(status, body) of one GET, straight to the socket: urllib would
    take a proxy from the environment."""
    conn = http.client.HTTPConnection(host, port, timeout=10.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_serve_process_ready_metrics_and_sigterm_drain(tmp_path):
    """`ccs serve` as a process: CCS-SERVE-READY and CCS-METRICS-READY,
    /metrics and /healthz, then SIGTERM with a request in flight: it
    prints CCS-SERVE-DRAINING, answers that request, writes a final
    serve_snapshot ledger record and exits 0."""
    from pbccs_tpu_torch.serve.client import wait_for_ready

    ledger = str(tmp_path / "ledger.ndjson")
    # one torch thread: on a loaded host a thread per core makes the
    # child's CPU polish crawl; the drain deadline bounds the wait for
    # the in-flight request, not its speed, so it is the reply's bound
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_CHILD, "--port", "0",
         "--metricsPort", "-1", "--perfLedger", ledger, "--maxBatch", "1",
         "--drainTimeout", "240", "--logLevel", "WARN"],
        cwd=REPO, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    lines: list[str] = []
    try:
        ready = wait_for_ready(proc, 120.0, lines)
        assert ready is not None, lines
        host, port = ready["CCS-SERVE-READY"]
        mhost, mport = ready["CCS-METRICS-READY"]
        _, tc = serve_chunks()
        with CcsClient(host, port, timeout=120.0) as cli:
            first = cli.submit_chunk(tc[0]).reply(timeout=120.0)
            assert first["status"] == "Success"
            status, body = _http_get(mhost, mport, "/metrics")
            assert status == 200 and b"ccs_serve_completed_total 1" in body
            status, body = _http_get(mhost, mport, "/healthz")
            assert status == 200 and body.strip() == b"ok"
            in_flight = cli.submit_chunk(tc[2])
            # SIGTERM once the engine admitted it: a submit the session
            # has not read when the drain begins is not in flight
            deadline = time.monotonic() + 60.0
            while cli.status()["admitted"] < 2:
                assert time.monotonic() < deadline, "never admitted"
                time.sleep(0.01)
            proc.send_signal(signal.SIGTERM)
            assert in_flight.reply(timeout=240.0)["status"] == "Success"
        assert proc.wait(timeout=120.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
    deadline = time.monotonic() + 10.0
    while not any("CCS-SERVE-DRAINING" in x for x in lines) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert any(x.startswith("CCS-SERVE-DRAINING signal=SIGTERM")
               for x in lines), lines
    records = [json.loads(x) for x in open(ledger)]
    assert records[-1]["kind"] == "serve_snapshot"
    assert records[-1]["completed"] == 2 and records[-1]["errors"] == 0
