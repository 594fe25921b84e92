"""The port's replica router (pbccs_tpu_torch/serve/router.py) on the CPU.

Counterparts of every case of tests/test_router.py: sticky replica
routing, health-checked failover, reply/failover race dedup, flapping
re-admission, drain handling, and the client's reconnect/resubmit +
deterministic-cleanup contract.  Most tests drive a real
CcsRouter/RouterServer against SCRIPTED fake replicas (a small NDJSON
socket server with `echo`/`hold`/`overloaded` submit modes and
togglable status probes), so every failure mode -- connection loss,
probe timeout, backpressure, drain notice, late duplicate reply -- is
triggered deterministically rather than by timing luck.  The shared
sched/health helpers get direct unit tests.

Where the fakes differ from tests/test_router.py's:

  * a draining fake reports `accepting: false` in its status replies,
    as a draining `ccs serve` does -- otherwise the next probe reply
    re-admits the replica and the drain-notice test races the probe;
  * the no-replica-reachable case points the router at a port that was
    bound and closed and never listened on (refused from the start);
    losing the link to the only replica mid-request is its own case,
    whose answer is `internal` ("failed on every healthy replica").

Then the cross-package parity: the port's router in front of a
pbccs_tpu CcsServer (CPU engine), and pbccs_tpu's router in front of
the port's CcsServer on device="cpu", each answer four simulated ZMWs
with pbccs_tpu's process_chunks sequences, QVs within 1.  Every wait
has a bound.
"""

import json
import socket
import threading
import time

import pytest

from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.resilience.retry import RetriesExhausted, RetryPolicy
from pbccs_tpu_torch.sched.health import HealthPolicy, HealthTracker, StickyMap
from pbccs_tpu_torch.serve import protocol
from pbccs_tpu_torch.serve.client import CcsClient, ServeError
from pbccs_tpu_torch.serve.router import (
    CcsRouter,
    RouterClosed,
    RouterConfig,
    RouterServer,
    route_key,
)

_REG = default_registry()

ZMW = {"id": "m/1", "reads": [{"seq": "ACGTACGT"}] * 4}


def wait_until(fn, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(step)
    return False


def fake_result(rid, msg):
    return {"type": "result", "id": rid, "zmw": msg["zmw"]["id"],
            "status": "Success", "latency_ms": 1.0, "sequence": "ACGT",
            "qual": "IIII", "num_passes": 4, "predicted_accuracy": 0.99,
            "avg_zscore": 0.0}


class FakeReplica:
    """Scripted NDJSON replica backend.

    Submit handling by mode: `echo` replies Success immediately, `hold`
    parks replies until release(), `overloaded` rejects with the
    structured backpressure error.  Status probes answer (with the
    current `accepting` flag) unless `answer_status` is False -- the
    probe-timeout / flapping lever."""

    def __init__(self, mode="echo"):
        self.mode = mode
        self.answer_status = True
        self.accepting = True
        # engine-reported backlog carried in status replies (the
        # admission-weighting lever: work other clients put on us)
        self.pending = 0
        self.received: list[str] = []
        self.submits: list[dict] = []   # full submit frames, in order
        self.trace_actions: list[str] = []   # trace verb fan-out record
        self.held: list[tuple] = []
        self._lock = threading.Lock()
        self._conns: list[socket.socket] = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self.name = f"127.0.0.1:{self.port}"
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _send(self, conn, msg):
        try:
            conn.sendall(json.dumps(msg).encode() + b"\n")
        except OSError:
            pass

    def _serve(self, conn):
        try:
            rf = conn.makefile("rb")
            for line in rf:
                if not line.strip():
                    continue
                msg = json.loads(line)
                verb = msg.get("verb")
                if verb == "status":
                    if self.answer_status:
                        self._send(conn, {"type": "status",
                                          "id": msg.get("id"),
                                          "accepting": self.accepting,
                                          "pending": self.pending})
                elif verb == "trace":
                    with self._lock:
                        self.trace_actions.append(msg.get("action"))
                    self._send(conn, {"type": "trace",
                                      "id": msg.get("id"),
                                      "state": "stopped"
                                      if msg.get("action") == "stop"
                                      else "started",
                                      "trace": {"traceEvents": []}})
                elif verb == "submit":
                    rid = msg.get("id")
                    with self._lock:
                        self.received.append(rid)
                        self.submits.append(msg)
                    if self.mode == "echo":
                        self._send(conn, fake_result(rid, msg))
                    elif self.mode == "hold":
                        with self._lock:
                            self.held.append((conn, rid, msg))
                    elif self.mode == "overloaded":
                        self._send(conn, {"type": "error", "id": rid,
                                          "code": "overloaded",
                                          "error": "engine full"})
        except (OSError, ValueError):
            pass

    def release(self):
        """Answer every held submit (late replies for race tests)."""
        with self._lock:
            held, self.held = self.held, []
        for conn, rid, msg in held:
            self._send(conn, fake_result(rid, msg))

    def reject_held(self):
        """Reject every held submit with `overloaded` (the STALE
        rejection shape for the failover-ownership race tests)."""
        with self._lock:
            held, self.held = self.held, []
        for conn, rid, _msg in held:
            self._send(conn, {"type": "error", "id": rid,
                              "code": "overloaded", "error": "late"})

    def drop(self):
        """Hard connection loss (the kill -9 shape)."""
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()

    def notify_draining(self):
        # a draining replica's status replies say so from here on
        self.accepting = False
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            self._send(c, {"type": "closed", "reason": "draining"})

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self.drop()


class DeadPort:
    """A replica address nothing listens on: bound, closed, and never
    listened on, so every connect to it is refused."""

    def __init__(self):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        self.port = s.getsockname()[1]
        self.name = f"127.0.0.1:{self.port}"
        s.close()


def make_router(fakes, **cfg):
    defaults = dict(health_interval_s=0.05, health_timeout_s=0.2,
                    connect_timeout_s=2.0)
    defaults.update(cfg)
    router = CcsRouter([f"127.0.0.1:{f.port}" for f in fakes],
                       RouterConfig(**defaults)).start()
    server = RouterServer(router, port=0).start()
    return router, server


@pytest.fixture
def fakes_pair():
    fakes = [FakeReplica(), FakeReplica()]
    yield fakes
    for f in fakes:
        f.close()


# ----------------------------------------------------- sched/health helpers


class TestHealthHelpers:
    def test_sticky_map_route_outcomes(self):
        m = StickyMap()
        members = ["a", "b"]
        depth = {"a": 0, "b": 0}

        def route(key):
            return m.route(key, members, member_id=lambda x: x,
                           load=lambda x: (depth[x], m.resident_count(x), x),
                           depth=lambda x: depth[x], spill_depth=0)

        target, outcome = route("k")
        assert outcome == "new"
        m.note("k", target)
        # idle home wins
        assert route("k") == (target, "home")
        # busy home spills to the least-loaded member
        depth[target] = 3
        spill, outcome = route("k")
        assert outcome == "spill" and spill != target
        m.note("k", spill)
        # both homes busy: the least-loaded HOME is still "home"
        depth[spill] = 1
        assert route("k") == (spill, "home")

    def test_sticky_map_forget_member(self):
        m = StickyMap()
        m.note("k", "a")
        m.note("j", "a")
        assert m.resident_count("a") == 2
        m.forget_member("a")
        assert m.resident_count("a") == 0 and m.homes("k") == set()

    def test_health_tracker_bench_and_readmit(self):
        t = HealthTracker(HealthPolicy(bench_after=2, readmit_after=2))
        assert t.healthy("r")
        assert not t.record_failure("r")       # strike 1
        assert t.record_failure("r")           # strike 2 -> benched
        assert not t.healthy("r")
        assert not t.record_failure("r")       # already benched: no edge
        assert not t.record_success("r")       # 1 good probe: not yet
        assert t.record_success("r")           # 2nd -> re-admitted
        assert t.healthy("r")
        # a success resets the strike count
        assert not t.record_failure("r")
        assert not t.record_success("r")
        assert not t.record_failure("r")       # strike 1 again, not 2

    def test_health_policy_validation(self):
        with pytest.raises(ValueError):
            HealthPolicy(bench_after=0)
        with pytest.raises(ValueError):
            HealthPolicy(readmit_after=0)


def test_route_key_groups_by_geometry():
    import numpy as np

    from pbccs_tpu_torch.pipeline import Chunk, Subread

    def chunk(lengths):
        return Chunk("m/1", [Subread(f"m/1/{i}",
                                     np.zeros(n, np.int8))
                             for i, n in enumerate(lengths)],
                     np.full(4, 8.0))

    assert route_key(chunk([100, 102, 98])) == \
        route_key(chunk([99, 101, 103]))
    assert route_key(chunk([100, 100, 100])) != \
        route_key(chunk([1000, 1000, 1000]))


# ------------------------------------------------------------ routing basics


class TestRouting:
    def test_routes_and_replies(self, fakes_pair):
        router, server = make_router(fakes_pair)
        try:
            with CcsClient(server.host, server.port) as cli:
                for i in range(4):
                    msg = cli.submit_wire(dict(ZMW, id=f"m/{i}")).reply(10.0)
                    assert msg["status"] == "Success"
                    assert msg["zmw"] == f"m/{i}"
            # same bucket, depth below spill_depth: all stick to one home
            got = [len(f.received) for f in fakes_pair]
            assert sorted(got) == [0, 4]
            st = router.status()
            assert st["routed"] == 4 and st["completed"] == 4
            assert st["failovers"] == 0
        finally:
            server.shutdown()
            router.close()

    def test_spill_past_depth_uses_second_replica(self, fakes_pair):
        for f in fakes_pair:
            f.mode = "hold"
        router, server = make_router(fakes_pair, spill_depth=1)
        try:
            with CcsClient(server.host, server.port) as cli:
                handles = [cli.submit_wire(dict(ZMW, id=f"m/{i}"))
                           for i in range(4)]
                assert wait_until(
                    lambda: sum(len(f.received) for f in fakes_pair) == 4)
                # depth cap 1 per home: the overflow spilled
                assert all(f.received for f in fakes_pair)
                for f in fakes_pair:
                    f.release()
                for h in handles:
                    assert h.reply(10.0)["status"] == "Success"
        finally:
            server.shutdown()
            router.close()

    def test_admission_weights_reported_depth(self, fakes_pair):
        """Uneven fleet: a replica whose status probe reports a deep
        engine backlog (work OTHER clients put on it) stops winning
        routes even though this router has nothing in flight there --
        admission weighting by status depth, not in-flight count
        alone."""
        a, b = fakes_pair
        a.pending = 50
        router, server = make_router(fakes_pair, spill_depth=2)
        try:
            # a probe cycle must observe the backlog before routing
            assert wait_until(lambda: router.status()["replicas"][0]
                              ["external_backlog"] == 50)
            with CcsClient(server.host, server.port) as cli:
                for i in range(4):
                    msg = cli.submit_wire(dict(ZMW, id=f"m/{i}")).reply(10.0)
                    assert msg["status"] == "Success"
            assert not a.received
            assert len(b.received) == 4
        finally:
            server.shutdown()
            router.close()

    def test_sticky_home_spills_on_reported_backlog(self, fakes_pair):
        """The spill threshold counts the replica's reported backlog:
        a sticky home that got busy from elsewhere loses its bucket's
        overflow to the idle replica instead of queueing blindly."""
        router, server = make_router(fakes_pair, spill_depth=2)
        try:
            with CcsClient(server.host, server.port) as cli:
                assert cli.submit_wire(dict(ZMW, id="m/0")).reply(
                    10.0)["status"] == "Success"
                home = next(f for f in fakes_pair if f.received)
                other = next(f for f in fakes_pair if f is not home)
                home.pending = 50
                idx = fakes_pair.index(home)
                assert wait_until(lambda: router.status()["replicas"][idx]
                                  ["external_backlog"] >= 49)
                for i in range(1, 4):
                    assert cli.submit_wire(dict(ZMW, id=f"m/{i}")).reply(
                        10.0)["status"] == "Success"
            # same bucket throughout; without depth weighting all four
            # would stick to the home replica
            assert other.received
        finally:
            server.shutdown()
            router.close()

    def test_resubmits_on_replica_overloaded(self, fakes_pair):
        fakes_pair[0].mode = "overloaded"
        router, server = make_router(fakes_pair)
        try:
            with CcsClient(server.host, server.port) as cli:
                # route to the overloaded replica is possible (index 0 is
                # the least-loaded tie-break winner); the router must
                # absorb the rejection and land on the healthy one
                for i in range(3):
                    msg = cli.submit_wire(dict(ZMW, id=f"m/{i}")).reply(10.0)
                    assert msg["status"] == "Success"
            assert router.status()["failovers"] >= 1 or \
                not fakes_pair[0].received
        finally:
            server.shutdown()
            router.close()

    def test_all_replicas_overloaded_surfaces_error(self):
        fake = FakeReplica(mode="overloaded")
        router, server = make_router([fake])
        try:
            with CcsClient(server.host, server.port) as cli:
                with pytest.raises(ServeError) as ei:
                    cli.submit_wire(dict(ZMW)).reply(10.0)
                assert ei.value.code == protocol.ERR_OVERLOADED
        finally:
            server.shutdown()
            router.close()
            fake.close()

    def test_no_replica_reachable_is_overloaded(self):
        dead = DeadPort()   # bound, closed, never listened on
        router, server = make_router([dead])
        try:
            assert not router.status()["replicas"][0]["connected"]
            with CcsClient(server.host, server.port) as cli:
                with pytest.raises(ServeError) as ei:
                    cli.submit_wire(dict(ZMW)).reply(10.0)
                assert ei.value.code == protocol.ERR_OVERLOADED
        finally:
            server.shutdown()
            router.close()

    def test_replica_lost_on_the_only_replica_is_internal(self):
        """The request reached the fleet's only replica, whose link then
        dropped: it failed on every healthy replica, so the answer is
        `internal`, not the no-replica `overloaded`."""
        fake = FakeReplica(mode="hold")
        router, server = make_router([fake])
        try:
            with CcsClient(server.host, server.port) as cli:
                handle = cli.submit_wire(dict(ZMW))
                assert wait_until(lambda: len(fake.received) == 1)
                fake.close()   # listener and link gone
                with pytest.raises(ServeError) as ei:
                    handle.reply(10.0)
                assert ei.value.code == protocol.ERR_INTERNAL
                assert "every healthy replica" in str(ei.value)
        finally:
            server.shutdown()
            router.close()

    def test_submit_after_close_is_closed_error(self, fakes_pair):
        router, _server = make_router(fakes_pair)
        router.close()
        with pytest.raises(RouterClosed):
            router.submit_routed(dict(ZMW), ("k",), None, lambda m: None)
        _server.shutdown()


# --------------------------------------------------------- failover + dedup


class TestFailover:
    def test_connection_loss_zero_lost(self, fakes_pair):
        a, b = fakes_pair
        a.mode = "hold"
        router, server = make_router(fakes_pair)
        try:
            with CcsClient(server.host, server.port) as cli:
                handles = [cli.submit_wire(dict(ZMW, id=f"m/{i}"))
                           for i in range(3)]
                assert wait_until(lambda: len(a.received) == 3)
                a.drop()   # kill -9 shape: unanswered requests fail over
                for h in handles:
                    assert h.reply(30.0)["status"] == "Success"
            assert len(b.received) == 3
            assert router.status()["failovers"] == 3
        finally:
            server.shutdown()
            router.close()

    def test_reply_beats_failover_then_duplicate_dropped(self, fakes_pair):
        """The race the request-id dedup contract exists for: the
        benched replica's reply lands FIRST (it wins, the client sees
        it), then the failover target's duplicate arrives and must be
        dropped -- one frame per request id on the wire."""
        a, b = fakes_pair
        a.mode = "hold"
        b.mode = "hold"
        # bench_after=1: one missed probe benches; probes only time out
        # while answer_status is off
        router, server = make_router(fakes_pair, bench_after=1)
        try:
            scope = _REG.scope()
            conn = socket.create_connection((server.host, server.port),
                                            timeout=10.0)
            rf = conn.makefile("rb")
            conn.sendall(protocol.encode_msg(
                {"verb": "submit", "id": "race", "zmw": ZMW}))
            assert wait_until(lambda: len(a.received) == 1)
            a.answer_status = False   # probes now time out -> bench
            assert wait_until(lambda: len(b.received) == 1, timeout=15.0)
            # the ORIGINAL replica answers first (its link is still up:
            # benching moves work, it does not tear the socket down)
            a.release()
            first = json.loads(rf.readline())
            assert first["id"] == "race" and first["status"] == "Success"
            # now the failover target's duplicate: dropped by rid dedup
            b.release()
            assert wait_until(lambda: scope.counter_value(
                "ccs_router_dedup_dropped_total") == 1)
            conn.settimeout(1.0)
            with pytest.raises((socket.timeout, TimeoutError)):
                rf.readline()
            conn.close()
        finally:
            server.shutdown()
            router.close()

    def test_failover_beats_reply_then_duplicate_dropped(self, fakes_pair):
        a, b = fakes_pair
        a.mode = "hold"
        router, server = make_router(fakes_pair, bench_after=1)
        try:
            scope = _REG.scope()
            conn = socket.create_connection((server.host, server.port),
                                            timeout=10.0)
            rf = conn.makefile("rb")
            conn.sendall(protocol.encode_msg(
                {"verb": "submit", "id": "race2", "zmw": ZMW}))
            assert wait_until(lambda: len(a.received) == 1)
            a.answer_status = False
            # b is echo-mode: the failover reply wins the race outright
            first = json.loads(rf.readline())
            assert first["id"] == "race2" and first["status"] == "Success"
            a.release()   # the stale original reply must be dropped
            assert wait_until(lambda: scope.counter_value(
                "ccs_router_dedup_dropped_total") == 1)
            conn.settimeout(1.0)
            with pytest.raises((socket.timeout, TimeoutError)):
                rf.readline()
            conn.close()
        finally:
            server.shutdown()
            router.close()

    def test_stale_rejection_after_failover_is_dropped(self, fakes_pair):
        """A detached replica's LATE `overloaded` rejection must not
        complete (or re-route) a request another replica now owns: on a
        2-replica fleet it would otherwise surface a spurious error
        while the new owner is still polishing."""
        a, b = fakes_pair
        a.mode = "hold"
        b.mode = "hold"
        router, server = make_router(fakes_pair, bench_after=1)
        try:
            scope = _REG.scope()
            conn = socket.create_connection((server.host, server.port),
                                            timeout=10.0)
            rf = conn.makefile("rb")
            conn.sendall(protocol.encode_msg(
                {"verb": "submit", "id": "stale", "zmw": ZMW}))
            assert wait_until(lambda: len(a.received) == 1)
            a.answer_status = False   # probe timeout -> bench -> failover
            assert wait_until(lambda: len(b.received) == 1, timeout=15.0)
            a.reject_held()           # stale rejection from the old owner
            assert wait_until(lambda: scope.counter_value(
                "ccs_router_dedup_dropped_total") == 1)
            b.release()               # the real owner answers
            first = json.loads(rf.readline())
            assert first["id"] == "stale" and first["status"] == "Success"
            conn.settimeout(1.0)
            with pytest.raises((socket.timeout, TimeoutError)):
                rf.readline()
            conn.close()
        finally:
            server.shutdown()
            router.close()

    def test_replica_flapping_readmission(self, fakes_pair):
        a, b = fakes_pair
        router, server = make_router(fakes_pair, bench_after=1,
                                     readmit_after=2)
        try:
            def replica_state(name):
                st = router.status()
                return next(r for r in st["replicas"]
                            if r["replica"] == name)

            a.answer_status = False
            assert wait_until(
                lambda: not replica_state(a.name)["healthy"], timeout=15.0)
            # unhealthy replica takes no new work
            with CcsClient(server.host, server.port) as cli:
                assert cli.submit_wire(dict(ZMW)).reply(
                    10.0)["status"] == "Success"
                assert len(b.received) == 1 and not a.received
                # recovery: two good probes re-admit it
                a.answer_status = True
                assert wait_until(
                    lambda: replica_state(a.name)["healthy"], timeout=15.0)
                # the benched-and-forgotten bucket re-homed on b; a NEW
                # bucket prefers the re-admitted replica (fewer resident
                # buckets in the least-loaded tie-break)
                big = {"id": "m/2",
                       "reads": [{"seq": "ACGT" * 300}] * 4}
                assert cli.submit_wire(big).reply(
                    10.0)["status"] == "Success"
                assert len(a.received) == 1
        finally:
            server.shutdown()
            router.close()

    def test_sticky_survives_reconnect(self, fakes_pair):
        a, b = fakes_pair
        router, server = make_router(fakes_pair)
        try:
            with CcsClient(server.host, server.port) as cli:
                assert cli.submit_wire(dict(ZMW)).reply(
                    10.0)["status"] == "Success"
                assert len(a.received) == 1

                def connected():
                    return next(r for r in router.status()["replicas"]
                                if r["replica"] == a.name)["connected"]

                old = router._by_name[a.name].link
                a.drop()   # idle connection loss (no in-flight)
                # the loss registers first (the old link is failed),
                # then the health loop reconnects on a NEW link; one
                # strike != benched, so the bucket's home assignment
                # survives the round trip
                assert wait_until(lambda: old.failed, timeout=15.0)
                assert wait_until(
                    lambda: router._by_name[a.name].link not in (None, old)
                    and connected(), timeout=15.0)
                assert cli.submit_wire(
                    dict(ZMW, id="m/2")).reply(10.0)["status"] == "Success"
            assert len(a.received) == 2 and not b.received
        finally:
            server.shutdown()
            router.close()

    def test_drain_notice_moves_traffic(self, fakes_pair):
        a, b = fakes_pair
        router, server = make_router(fakes_pair)
        try:
            with CcsClient(server.host, server.port) as cli:
                assert cli.submit_wire(dict(ZMW)).reply(
                    10.0)["status"] == "Success"
                assert len(a.received) == 1
                a.notify_draining()
                assert wait_until(lambda: next(
                    r for r in router.status()["replicas"]
                    if r["replica"] == a.name)["draining"])
                for i in range(2):
                    assert cli.submit_wire(dict(
                        ZMW, id=f"d/{i}")).reply(10.0)["status"] == "Success"
            assert len(a.received) == 1 and len(b.received) == 2
        finally:
            server.shutdown()
            router.close()

    def test_draining_replica_inflight_still_completes(self, fakes_pair):
        a, b = fakes_pair
        a.mode = "hold"
        router, server = make_router(fakes_pair)
        try:
            with CcsClient(server.host, server.port) as cli:
                h = cli.submit_wire(dict(ZMW))
                assert wait_until(lambda: len(a.received) == 1)
                a.notify_draining()   # drain does NOT fail over in-flight
                time.sleep(0.2)
                assert not h.done()
                a.release()           # the draining replica answers it
                assert h.reply(10.0)["status"] == "Success"
            assert not b.received
        finally:
            server.shutdown()
            router.close()

    def test_router_close_drains_inflight(self, fakes_pair):
        a, _b = fakes_pair
        a.mode = "hold"
        fakes_pair[1].mode = "hold"
        router, server = make_router(fakes_pair)
        with CcsClient(server.host, server.port) as cli:
            h = cli.submit_wire(dict(ZMW))
            assert wait_until(
                lambda: sum(len(f.received) for f in fakes_pair) == 1)
            closer = threading.Thread(
                target=lambda: router.close(drain=True, deadline_s=30.0))
            closer.start()
            time.sleep(0.1)
            for f in fakes_pair:
                f.release()
            closer.join(timeout=30.0)
            assert h.reply(10.0)["status"] == "Success"
        server.shutdown()


# ------------------------------------------------- client reconnect/cleanup


def stub_serve_stack(port=0, max_pending=64, gate=None):
    import numpy as np

    from pbccs_tpu_torch.pipeline import Failure, PreparedZmw
    from pbccs_tpu_torch.serve.engine import CcsEngine, ServeConfig
    from pbccs_tpu_torch.serve.server import CcsServer

    def prep(chunk, settings):
        return None, PreparedZmw(chunk, np.zeros(64, np.int8), [],
                                 len(chunk.reads), 0, 0.0)

    def polish(preps, settings):
        if gate is not None:
            gate.wait(10.0)
        return [(Failure.SUCCESS, None) for _ in preps]

    eng = CcsEngine(config=ServeConfig(max_batch=1, max_wait_ms=20.0,
                                       max_pending=max_pending),
                    prep_fn=prep, polish_fn=polish, device="cpu").start()
    srv = CcsServer(eng, port=port).start()
    return eng, srv


class TestClientResilience:
    def test_submit_with_retry_reconnects_and_resubmits(self):
        eng1, srv1 = stub_serve_stack()
        port = srv1.port
        cli = CcsClient(srv1.host, port)
        try:
            assert cli.submit_wire(dict(ZMW)).reply(10.0)
            # the server goes away mid-session (rolling restart) ...
            srv1.shutdown()
            eng1.close()
            # ... and comes back on the same endpoint
            eng2, srv2 = stub_serve_stack(port=port)
            try:
                msg = cli.submit_with_retry(
                    dict(ZMW, id="m/2"),
                    policy=RetryPolicy(max_attempts=20, base_delay_s=0.05,
                                       max_delay_s=0.2))
                assert msg["status"] == "Success" and msg["zmw"] == "m/2"
            finally:
                srv2.shutdown()
                eng2.close()
        finally:
            cli.close()

    def test_retry_exhaustion_clean_state_and_structured_cause(self):
        gate = threading.Event()
        eng, srv = stub_serve_stack(max_pending=1, gate=gate)
        filler = CcsClient(srv.host, srv.port)
        cli = CcsClient(srv.host, srv.port)
        try:
            filler.submit_wire(dict(ZMW))   # occupies the only slot
            assert wait_until(lambda: eng.status()["pending"] == 1)
            with pytest.raises(RetriesExhausted) as ei:
                cli.submit_with_retry(
                    dict(ZMW, id="m/2"),
                    policy=RetryPolicy(max_attempts=2, base_delay_s=0.01))
            # the structured error survives as the cause ...
            assert isinstance(ei.value.__cause__, ServeError)
            assert ei.value.__cause__.code == protocol.ERR_OVERLOADED
            # ... and nothing dangles: no pending handle, session usable
            assert cli._pending == {}
            gate.set()
            assert cli.submit_with_retry(
                dict(ZMW, id="m/3"))["status"] == "Success"
        finally:
            gate.set()
            filler.close()
            cli.close()
            srv.shutdown()
            eng.close()

    def test_reply_timeout_discards_pending_handle(self):
        gate = threading.Event()
        eng, srv = stub_serve_stack(gate=gate)
        cli = CcsClient(srv.host, srv.port)
        try:
            with pytest.raises(TimeoutError):
                cli.submit_with_retry(dict(ZMW), reply_timeout=0.1)
            # the unanswered id is discarded, not parked forever
            assert cli._pending == {}
            gate.set()
            # the late reply for the discarded id falls on the floor and
            # the session keeps working
            cli.ping(timeout=10.0)
        finally:
            gate.set()
            cli.close()
            srv.shutdown()
            eng.close()

    def test_closed_client_fails_fast_not_retried(self):
        eng, srv = stub_serve_stack()
        cli = CcsClient(srv.host, srv.port)
        cli.close()
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            cli.submit_with_retry(
                dict(ZMW),
                policy=RetryPolicy(max_attempts=50, base_delay_s=0.5,
                                   max_delay_s=2.0))
        # a deliberate close surfaces immediately, not after the
        # retry budget burns down
        assert time.monotonic() - t0 < 2.0
        srv.shutdown()
        eng.close()

    def test_plain_submit_still_fails_fast_without_reconnect(self):
        eng, srv = stub_serve_stack()
        cli = CcsClient(srv.host, srv.port)
        cli.ping(timeout=10.0)   # session established before the outage
        srv.shutdown()
        eng.close()
        try:
            assert wait_until(lambda: not cli._reader.is_alive())
            with pytest.raises(ConnectionError):
                cli.submit_wire(dict(ZMW)).reply(5.0)
        finally:
            cli.close()


def test_engine_status_reports_accepting():
    eng, srv = stub_serve_stack()
    try:
        assert eng.status()["accepting"] is True
    finally:
        srv.shutdown()
        eng.close()
    assert eng.status()["accepting"] is False


# ------------------------------------------------- trace-context plumbing


class TestTraceContext:
    """The fleet observability plane's wire contract: trace_id survives
    the router's id rewriting and failover re-dispatch; span_id is
    rewritten to the router's per-request span on the replica hop."""

    def test_trace_id_survives_id_rewrite(self, fakes_pair):
        router, server = make_router(fakes_pair)
        try:
            with CcsClient(server.host, server.port) as cli:
                msg = cli.submit_wire(
                    dict(ZMW), trace={"trace_id": "feedc0de00000001",
                                      "span_id": "cl-7"}).reply(10.0)
                assert msg["status"] == "Success"
            frames = [m for f in fakes_pair for m in f.submits]
            assert len(frames) == 1
            tr = frames[0]["trace"]
            # trace_id untouched; span_id rewritten to the router's
            # per-request span, matching the rewritten request id
            assert tr["trace_id"] == "feedc0de00000001"
            assert tr["span_id"] == f"rt-{frames[0]['id']}"
            assert tr["span_id"] != "cl-7"
        finally:
            server.shutdown()
            router.close()

    def test_trace_follows_failover_redispatch(self, fakes_pair):
        a, b = fakes_pair
        a.mode = b.mode = "hold"
        router, server = make_router(fakes_pair)
        try:
            with CcsClient(server.host, server.port) as cli:
                handle = cli.submit_wire(
                    dict(ZMW), trace={"trace_id": "feedc0de00000002",
                                      "span_id": None})
                assert wait_until(lambda: a.submits or b.submits)
                first = a if a.submits else b
                second = b if first is a else a
                first.drop()     # connection loss -> failover
                assert wait_until(lambda: second.submits)
                second.release()   # answer the re-dispatched copy
                msg = handle.reply(10.0)
                assert msg["status"] == "Success"
            # both replicas saw the SAME trace_id and the SAME router
            # span id (failover re-dispatches the identical frame)
            f1, f2 = first.submits[-1], second.submits[-1]
            assert f1["trace"]["trace_id"] == "feedc0de00000002"
            assert f1["trace"] == f2["trace"]
            assert f1["id"] == f2["id"]
        finally:
            server.shutdown()
            router.close()

    def test_router_mints_trace_id_when_capture_live(self, fakes_pair):
        router, server = make_router(fakes_pair)
        try:
            assert router.trace_start()
            try:
                with CcsClient(server.host, server.port) as cli:
                    # no explicit trace field: the client's auto-context
                    # is also absent (this thread is inside no span), so
                    # the router edge must mint the id
                    msg = cli.submit_wire(dict(ZMW)).reply(10.0)
                    assert msg["status"] == "Success"
            finally:
                bundle = router.trace_stop(timeout_s=2.0)
            frames = [m for f in fakes_pair for m in f.submits]
            assert len(frames) == 1
            # edge-minted: a fresh 16-hex id, span_id = router span
            tr = frames[0]["trace"]
            assert len(tr["trace_id"]) == 16
            assert tr["span_id"] == f"rt-{frames[0]['id']}"
            # the router recorded a retroactive per-request span whose
            # exported span_id matches the forwarded remote parent
            events = bundle["trace"]["traceEvents"]
            mine = [e for e in events if e["name"] == "router.request"]
            assert mine and mine[0]["args"]["span_id"] == tr["span_id"]
            assert mine[0]["args"]["trace_id"] == tr["trace_id"]
        finally:
            server.shutdown()
            router.close()

    def test_replica_span_parents_under_inbound_context(self):
        from pbccs_tpu_torch.obs import trace as obs_trace

        eng, srv = stub_serve_stack()
        cap = obs_trace.Tracer(tag="rep")
        assert obs_trace.install_tracer(cap)
        try:
            with CcsClient(srv.host, srv.port) as cli:
                msg = cli.submit_wire(
                    dict(ZMW), trace={"trace_id": "feedc0de00000003",
                                      "span_id": "rt-q9"}).reply(10.0)
                assert msg["status"] == "Success"
        finally:
            obs_trace.clear_tracer(cap)
            srv.shutdown()
            eng.close()
        preps = [e for e in cap.to_chrome()["traceEvents"]
                 if e["name"] == "serve.prep"]
        assert preps
        args = preps[0]["args"]
        assert args["trace_id"] == "feedc0de00000003"
        assert args["remote_parent"] == "rt-q9"
        assert args["span_id"].startswith("rep-")

    def test_malformed_trace_is_bad_request(self):
        eng, srv = stub_serve_stack()
        try:
            with CcsClient(srv.host, srv.port) as cli:
                with pytest.raises(ServeError) as ei:
                    cli.submit_wire(dict(ZMW),
                                    trace={"trace_id": 7}).reply(10.0)
                assert ei.value.code == "bad_request"
        finally:
            srv.shutdown()
            eng.close()


def test_router_close_stops_replica_captures(fakes_pair=None):
    """Regression: close() must fan the trace stop out while the
    replica links are still alive -- a torn-down-first order left every
    replica's globally-installed tracer running forever."""
    fakes = [FakeReplica(), FakeReplica()]
    router, server = make_router(fakes)
    try:
        assert router.trace_start()
        assert wait_until(lambda: all(
            f.trace_actions[:1] == ["start"] for f in fakes))
        router.close()
        for f in fakes:
            assert "stop" in f.trace_actions, f.trace_actions
        from pbccs_tpu_torch.obs import trace as obs_trace
        assert obs_trace.get_tracer() is None   # router capture cleared
    finally:
        server.shutdown()
        router.close()
        for f in fakes:
            f.close()


# --------------------------------------------- parity with pbccs_tpu


@pytest.fixture(scope="module")
def parity_chunks():
    """Four simulated ZMWs (one of them 2-pass) for both packages, and
    pbccs_tpu's process_chunks records of them."""
    import pbccs_tpu.pipeline as jpipe
    from tests.test_torch_serve import serve_chunks

    jc, tc = serve_chunks()
    return jc, tc, {r.id: r for r in jpipe.process_chunks(jc).results}


@pytest.mark.parametrize("direction", ["port_router_jax_server",
                                       "jax_router_port_server"])
def test_router_and_server_interoperate_on_real_polish(direction,
                                                       parity_chunks):
    """The port's router in front of a pbccs_tpu CcsServer (CPU engine),
    and pbccs_tpu's router in front of the port's CcsServer on
    device="cpu": the four ZMWs come back as pbccs_tpu's process_chunks
    has them (sequences equal, QVs within 1; the 2-pass ZMW fails the
    pass gate)."""
    import numpy as np

    import pbccs_tpu.serve.client as jclient
    import pbccs_tpu.serve.engine as jengine
    import pbccs_tpu.serve.router as jrouter
    import pbccs_tpu.serve.server as jserver
    import pbccs_tpu_torch.serve.router as trouter
    from pbccs_tpu_torch.serve.engine import CcsEngine, ServeConfig
    from pbccs_tpu_torch.serve.server import CcsServer

    jc, tc, offline = parity_chunks
    if direction == "port_router_jax_server":
        eng = jengine.CcsEngine(config=jengine.ServeConfig(
            max_batch=4, max_wait_ms=60_000.0, prep_workers=1))
        srv_cls = jserver.CcsServer
        router_mod, client_cls, chunks = trouter, CcsClient, tc
    else:
        eng = CcsEngine(config=ServeConfig(max_batch=4,
                                           max_wait_ms=60_000.0,
                                           prep_workers=1), device="cpu")
        srv_cls = CcsServer
        router_mod, client_cls, chunks = jrouter, jclient.CcsClient, jc
    eng.start()
    replica = srv_cls(eng, port=0).start()
    router = router_mod.CcsRouter(
        [f"127.0.0.1:{replica.port}"],
        router_mod.RouterConfig(health_interval_s=0.5,
                                health_timeout_s=120.0)).start()
    front = router_mod.RouterServer(router, port=0).start()
    try:
        with client_cls(front.host, front.port, timeout=300.0) as cli:
            handles = [cli.submit_chunk(c) for c in chunks]
            replies = [h.reply(timeout=300.0) for h in handles]
        assert router.status()["routed"] == 4
    finally:
        front.shutdown()
        router.close(drain=False)
        replica.shutdown()
        eng.close(drain=False)
    assert [r["status"] for r in replies] == \
        ["Success", "TooFewPasses", "Success", "Success"]
    served = [r for r in replies if r["status"] == "Success"]
    assert sorted(offline) == sorted(r["zmw"] for r in served)
    for reply in served:
        ref = offline[reply["zmw"]]
        assert reply["sequence"] == ref.sequence
        # the wire's phred+33 clamps QVs at 93
        qvs = np.frombuffer(reply["qual"].encode(), np.uint8).astype(int) - 33
        assert np.abs(qvs - np.minimum(ref.qvs.astype(int), 93)).max() <= 1
