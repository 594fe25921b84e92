"""The port's fleet autopilot (pbccs_tpu_torch/serve/supervisor.py) on
the CPU.

Counterparts of every case of tests/test_supervisor.py: the supervisor
state machine (respawn backoff, crash-loop quarantine + readmit,
drain-timeout SIGKILL escalation, rolling deploys) against FAKE children
and a fake membership plane, plus the router's dynamic-membership
`fleet` verb round-tripped over real sockets against scripted
FakeReplica backends, and the fleet_event perf-ledger schema contract.
The injectable spawn_fn/clock seams make every timing-shaped behavior
(backoff schedule, quarantine window) deterministic here.

Then the port's own: the spawned child command (the port's CLI on the
card, a run_serve(device="cpu") child on the CPU), --compileCache
forwarded only when given, and `ccs fleet` as a process on device="cpu" -- two real CPU children,
a crash-loop fault on slot 1 that yields one `respawn` event, both
slots up, SIGTERM exit 0 with no child left.  Every wait has a bound.
"""

import itertools
import json
import signal
import socket
import subprocess
import threading
import time

import pytest

from pbccs_tpu_torch.obs.ledger import LedgerSchemaError, PerfLedger, read_ledger
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.serve import protocol
from pbccs_tpu_torch.serve.router import CcsRouter, RouterConfig, RouterServer
from pbccs_tpu_torch.serve.supervisor import (
    SLOT_DEAD,
    SLOT_STOPPED,
    SLOT_UP,
    FleetSupervisor,
    SpawnError,
    SupervisorConfig,
    backoff_schedule,
)
from tests.test_torch_router import FakeReplica, wait_until

_REG = default_registry()


# ------------------------------------------------------------ fake plane

class FakeChild:
    """In-process stand-in for a spawned `ccs serve` child process."""

    def __init__(self, port: int, pid: int, term_exits: bool = True):
        self.host = "127.0.0.1"
        self.port = port
        self.pid = pid
        self.term_exits = term_exits   # False = ignores SIGTERM (stuck)
        self.signals: list = []
        self.killed = False
        self._exit: int | None = None
        self._exited = threading.Event()

    def poll(self):
        return self._exit

    def send_signal(self, sig) -> None:
        self.signals.append(sig)
        if sig == signal.SIGTERM and self.term_exits:
            self.exit(0)

    def kill(self) -> None:
        self.killed = True
        self.exit(-9)

    def wait(self, timeout=None):
        if not self._exited.wait(60.0 if timeout is None else timeout):
            raise subprocess.TimeoutExpired("fake-child", timeout)
        return self._exit

    def exit(self, code: int) -> None:
        """Simulate the child dying (idempotent)."""
        if self._exit is None:
            self._exit = code
        self._exited.set()


class FakeMembership:
    """The router surface the supervisor drives, without sockets."""

    def __init__(self):
        self.members: dict[str, bool] = {}
        self.added: list[str] = []
        self.removed: list[tuple[str, bool]] = []
        self.pending = 0
        self._lock = threading.Lock()

    def add_replica(self, spec) -> str:
        host, port = spec
        name = f"{host}:{port}"
        with self._lock:
            if name in self.members:
                raise ValueError(f"replica {name} is already a member")
            self.members[name] = True
            self.added.append(name)
        return name

    def remove_replica(self, name, drain=True, timeout_s=30.0) -> dict:
        with self._lock:
            self.members.pop(name, None)
            self.removed.append((name, drain))
        return {"replica": name, "drained": True, "failed_over": 0}

    def pending_count(self) -> int:
        return self.pending

    def status(self) -> dict:
        with self._lock:
            return {"replicas": [
                {"replica": n, "connected": True, "healthy": True}
                for n in self.members]}


def make_spawner(fail=None, term_exits=True):
    """spawn_fn minting FakeChildren; `fail(slot, incarnation)` True
    raises SpawnError (the died-before-ready shape)."""
    counter = itertools.count()
    spawned: list[tuple[int, int, FakeChild]] = []
    lock = threading.Lock()

    def spawn(slot: int, incarnation: int) -> FakeChild:
        n = next(counter)
        if fail is not None and fail(slot, incarnation):
            raise SpawnError(
                f"slot {slot} incarnation {incarnation} died before "
                "ready (exit 86)", exit_code=86)
        child = FakeChild(port=7000 + n, pid=40000 + n,
                          term_exits=term_exits)
        with lock:
            spawned.append((slot, incarnation, child))
        return child

    spawn.spawned = spawned
    return spawn


def fast_config(**over) -> SupervisorConfig:
    kw = dict(replicas=2, backoff_base_s=0.05, backoff_cap_s=0.4,
              crashloop_window_s=30.0, crashloop_threshold=3,
              drain_timeout_s=0.2, health_gate_timeout_s=5.0,
              poll_interval_s=0.02, scale_down_idle_s=3600.0)
    kw.update(over)
    return SupervisorConfig(**kw)


def running_supervisor(config, spawn, ledger=None):
    sup = FleetSupervisor(FakeMembership(), config, spawn,
                          ledger=ledger)
    sup.start()
    return sup


def slot_states(sup) -> dict[int, str]:
    return {s["slot"]: s["state"]
            for s in sup.status_block()["slots"]}


def event_names(sup) -> list[str]:
    return [e["event"] for e in sup.events()]


# ------------------------------------------------------ backoff schedule

class TestBackoffSchedule:
    def test_deterministic_exponential_with_cap(self):
        c = SupervisorConfig(replicas=1, backoff_base_s=0.5,
                             backoff_factor=2.0, backoff_cap_s=30.0)
        got = [backoff_schedule(c, a) for a in range(1, 9)]
        assert got == [0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 30.0]
        assert backoff_schedule(c, 0) == 0.0
        assert backoff_schedule(c, 100) == 30.0

    def test_respawn_walks_the_schedule(self):
        spawn = make_spawner()
        sup = running_supervisor(
            fast_config(crashloop_threshold=10), spawn)
        try:
            assert wait_until(
                lambda: set(slot_states(sup).values()) == {SLOT_UP})
            # two consecutive deaths of slot 0: respawn events carry
            # attempt 1 then 2 with the exact schedule delays
            for expected_attempt in (1, 2):
                child = next(c for s, _, c in reversed(spawn.spawned)
                             if s == 0 and c.poll() is None)
                child.exit(1)
                assert wait_until(
                    lambda: slot_states(sup).get(0) == SLOT_UP
                    and event_names(sup).count("respawn")
                    == expected_attempt)
            respawns = [e for e in sup.events()
                        if e["event"] == "respawn"]
            assert [e["attempt"] for e in respawns] == [1, 2]
            assert [e["backoff_s"] for e in respawns] == [0.05, 0.1]
            # each death removed the old membership and added the new
            names = [e for e in event_names(sup) if e == "remove"]
            assert len(names) == 2
        finally:
            sup.stop(drain=False)

    def test_config_validation(self):
        with pytest.raises(ValueError):
            SupervisorConfig(replicas=0)
        with pytest.raises(ValueError):
            SupervisorConfig(replicas=2, min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError):
            SupervisorConfig(replicas=1, backoff_base_s=0.5,
                             backoff_cap_s=0.1)


# --------------------------------------------------- quarantine/readmit

class TestCrashLoopQuarantine:
    def test_k_rapid_deaths_quarantine_with_structured_reason(self):
        # slot 0's first three incarnations die before ready; slot 1
        # is healthy -- the fleet keeps serving around the bad slot
        spawn = make_spawner(
            fail=lambda slot, inc: slot == 0 and inc < 3)
        sup = running_supervisor(fast_config(), spawn)
        try:
            assert wait_until(
                lambda: slot_states(sup).get(0) == SLOT_DEAD)
            block = sup.status_block()
            dead = next(s for s in block["slots"] if s["slot"] == 0)
            assert "crash-loop" in dead["reason"]
            assert "readmit" in dead["reason"]
            assert dead["deaths"] >= 3
            assert slot_states(sup)[1] == SLOT_UP
            assert "quarantine" in event_names(sup)
            # quarantine is sticky: no further spawn attempts for slot 0
            attempts = len([1 for s, _, _ in spawn.spawned if s == 0])
            time.sleep(0.2)
            assert len([1 for s, _, _ in spawn.spawned
                        if s == 0]) == attempts
        finally:
            sup.stop(drain=False)

    def test_manual_readmit_respawns_the_slot(self):
        spawn = make_spawner(
            fail=lambda slot, inc: slot == 0 and inc < 3)
        sup = running_supervisor(fast_config(), spawn)
        try:
            assert wait_until(
                lambda: slot_states(sup).get(0) == SLOT_DEAD)
            sup.readmit(0)
            # incarnation 3 survives: the slot comes back up
            assert wait_until(
                lambda: slot_states(sup).get(0) == SLOT_UP)
            assert "readmit" in event_names(sup)
        finally:
            sup.stop(drain=False)

    def test_readmit_rejects_unknown_and_live_slots(self):
        spawn = make_spawner()
        sup = running_supervisor(fast_config(replicas=1), spawn)
        try:
            assert wait_until(
                lambda: slot_states(sup).get(0) == SLOT_UP)
            with pytest.raises(ValueError, match="unknown slot"):
                sup.readmit(99)
            with pytest.raises(ValueError, match="not quarantined"):
                sup.readmit(0)
        finally:
            sup.stop(drain=False)


# ------------------------------------------------------ drain escalation

class TestDrainEscalation:
    def test_stuck_child_gets_sigkill_past_drain_timeout(self):
        spawn = make_spawner(term_exits=False)   # children ignore TERM
        sup = running_supervisor(fast_config(), spawn)
        assert wait_until(
            lambda: set(slot_states(sup).values()) == {SLOT_UP})
        children = [c for _, _, c in spawn.spawned]
        sup.stop(drain=True)
        for c in children:
            assert signal.SIGTERM in c.signals  # polite first
            assert c.killed                      # escalated
        assert event_names(sup).count("drain_kill") == len(children)

    def test_cooperative_child_is_never_killed(self):
        spawn = make_spawner()                   # exits 0 on SIGTERM
        sup = running_supervisor(fast_config(), spawn)
        assert wait_until(
            lambda: set(slot_states(sup).values()) == {SLOT_UP})
        children = [c for _, _, c in spawn.spawned]
        sup.stop(drain=True)
        assert all(not c.killed for c in children)
        assert "drain_kill" not in event_names(sup)


# -------------------------------------------------------- rolling deploy

class TestRollingRestart:
    def test_cycles_one_slot_at_a_time(self):
        spawn = make_spawner()
        sup = running_supervisor(fast_config(), spawn)
        try:
            assert wait_until(
                lambda: set(slot_states(sup).values()) == {SLOT_UP})
            first = {s: c for s, _, c in spawn.spawned}
            assert sup.request_rolling_restart() is True
            assert wait_until(
                lambda: "rolling_restart_done" in event_names(sup))
            assert sup.status_block()["rolling_restart"] is None
            assert set(slot_states(sup).values()) == {SLOT_UP}
            # every original child was TERMed, every slot respawned at
            # incarnation 1, one step event per slot, in slot order
            for c in first.values():
                assert signal.SIGTERM in c.signals
            incs = sorted((s, i) for s, i, _ in spawn.spawned)
            assert incs == [(0, 0), (0, 1), (1, 0), (1, 1)]
            steps = [e["slot"] for e in sup.events()
                     if e["event"] == "rolling_restart_step"]
            assert steps == [0, 1]
        finally:
            sup.stop(drain=False)

    def test_second_request_while_running_is_refused(self):
        spawn = make_spawner()
        sup = running_supervisor(fast_config(), spawn)
        try:
            assert wait_until(
                lambda: set(slot_states(sup).values()) == {SLOT_UP})
            assert sup.request_rolling_restart() is True
            # either refused mid-run, or the first one already finished
            second = sup.request_rolling_restart()
            if second:
                assert "rolling_restart_done" in event_names(sup)
            assert wait_until(
                lambda: sup.status_block()["rolling_restart"] is None)
        finally:
            sup.stop(drain=False)


# ------------------------------------------------- fleet verb round trip

def router_verb(port: int, frame: dict, timeout: float = 10.0) -> dict:
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as c:
        c.sendall(json.dumps(frame).encode() + b"\n")
        rf = c.makefile("rb")
        while True:
            msg = json.loads(rf.readline())
            if msg.get("id") == frame.get("id"):
                return msg


class StubSupervisor:
    """Just enough supervisor for the verb plumbing tests."""

    def __init__(self):
        self.readmitted: list[int] = []
        self.restarts = 0

    def request_rolling_restart(self) -> bool:
        self.restarts += 1
        return self.restarts == 1

    def readmit(self, slot: int) -> None:
        if slot == 404:
            raise ValueError("unknown slot 404")
        self.readmitted.append(slot)

    def status_block(self) -> dict:
        return {"slots": [], "events": [], "rolling_restart": None}


class TestFleetVerb:
    def _fleet(self, port, action, **extra):
        return router_verb(
            port, {"verb": protocol.VERB_FLEET, "id": f"f-{action}",
                   "action": action, **extra})

    def test_add_remove_list_round_trip(self):
        fakes = [FakeReplica(), FakeReplica()]
        router = CcsRouter(
            [f"127.0.0.1:{fakes[0].port}"],
            RouterConfig(health_interval_s=0.05,
                         health_timeout_s=0.5)).start()
        server = RouterServer(router, port=0).start()
        try:
            out = self._fleet(server.port, "list")
            assert out["type"] == protocol.TYPE_FLEET and out["ok"]
            assert [r["replica"] for r in out["replicas"]] \
                == [fakes[0].name]

            out = self._fleet(server.port, "add", replica=fakes[1].name)
            assert out["ok"] and out["replica"] == fakes[1].name
            assert wait_until(lambda: all(
                r["connected"]
                for r in router.status()["replicas"]))
            assert len(router.status()["replicas"]) == 2

            # duplicate add is a structured usage error
            out = self._fleet(server.port, "add", replica=fakes[1].name)
            assert out["type"] == protocol.TYPE_ERROR
            assert "already a member" in out["error"]

            out = self._fleet(server.port, "remove",
                              replica=fakes[1].name, timeout_s=5.0)
            assert out["ok"] and out["drained"] is True
            assert [r["replica"] for r in router.status()["replicas"]] \
                == [fakes[0].name]

            # the last replica is load-bearing: removal refused
            out = self._fleet(server.port, "remove",
                              replica=fakes[0].name)
            assert out["type"] == protocol.TYPE_ERROR
            assert "last replica" in out["error"]

            out = self._fleet(server.port, "bogus")
            assert out["type"] == protocol.TYPE_ERROR
        finally:
            server.shutdown()
            router.close(drain=False)
            for f in fakes:
                f.close()

    def test_removed_replica_drains_inflight_first(self):
        fakes = [FakeReplica(mode="hold"), FakeReplica()]
        router = CcsRouter(
            [f.name for f in fakes],
            RouterConfig(health_interval_s=0.05,
                         health_timeout_s=5.0)).start()
        server = RouterServer(router, port=0).start()
        try:
            assert wait_until(lambda: all(
                r["connected"] for r in router.status()["replicas"]))
            # park one submit on the holding replica, then remove it
            # with a drain: the call must block until release, and the
            # request must still be answered exactly once
            got = []
            router.submit_routed({"id": "m/1", "snr": [9, 9, 9, 9],
                                  "reads": [{"seq": "ACGT"}] * 3},
                                 "m/1", 60000.0, got.append)
            assert wait_until(lambda: fakes[0].held or fakes[1].held)
            holder = fakes[0] if fakes[0].held else fakes[1]
            done = {}

            def remove():
                done["out"] = router.remove_replica(
                    holder.name, drain=True, timeout_s=30.0)

            t = threading.Thread(target=remove, daemon=True)
            t.start()
            time.sleep(0.2)
            assert not got, "drain completed before the reply exists"
            holder.release()
            t.join(timeout=10.0)
            assert done["out"]["drained"] is True
            assert wait_until(lambda: len(got) == 1)
            assert got[0].get("status") == "Success"
            assert [r["replica"] for r in router.status()["replicas"]] \
                == [f.name for f in fakes if f is not holder]
        finally:
            server.shutdown()
            router.close(drain=False)
            for f in fakes:
                f.close()

    def test_restart_and_readmit_need_a_supervisor(self):
        fakes = [FakeReplica()]
        router = CcsRouter([fakes[0].name],
                           RouterConfig(health_interval_s=0.05)).start()
        server = RouterServer(router, port=0).start()
        try:
            out = self._fleet(server.port, "restart")
            assert out["type"] == protocol.TYPE_ERROR
            assert "unsupervised" in out["error"]

            stub = StubSupervisor()
            router.set_supervisor(stub)
            out = self._fleet(server.port, "restart")
            assert out["ok"] and out["state"] == "started"
            out = self._fleet(server.port, "restart")
            assert out["ok"] and out["state"] == "already_running"

            out = self._fleet(server.port, "readmit", slot=2)
            assert out["ok"] and stub.readmitted == [2]
            out = self._fleet(server.port, "readmit", slot=404)
            assert out["type"] == protocol.TYPE_ERROR
            out = self._fleet(server.port, "readmit", slot="x")
            assert out["type"] == protocol.TYPE_ERROR

            # with a supervisor attached, status carries its block
            st = router_verb(server.port,
                             {"verb": "status", "id": "st"})
            assert protocol.FIELD_SUPERVISOR in st
            assert st[protocol.FIELD_SUPERVISOR]["slots"] == []
        finally:
            server.shutdown()
            router.close(drain=False)
            fakes[0].close()


# --------------------------------------------------- reconnect backoff

class TestReconnectBackoff:
    def test_down_replica_reconnects_on_a_backoff_schedule(self):
        fake = FakeReplica()
        name = fake.name
        router = CcsRouter(
            [name],
            RouterConfig(health_interval_s=0.02, health_timeout_s=0.5,
                         reconnect_backoff_base_s=0.2,
                         reconnect_backoff_cap_s=1.0)).start()
        try:
            assert wait_until(lambda: router.status()
                              ["replicas"][0]["connected"])
            scope = _REG.scope()
            fake.close()   # hard down: reconnect attempts now fail
            # with a 0.02s probe tick and a >=0.2s backoff window, most
            # ticks must be SKIPPED (counted) rather than attempted
            assert wait_until(lambda: scope.counter_value(
                "ccs_router_reconnect_backoffs_total",
                replica=name) >= 3, timeout=15.0)
        finally:
            router.close(drain=False)


# ------------------------------------------------------- ledger schema

class TestFleetEventLedger:
    def test_fleet_event_record_accepted(self, tmp_path):
        led = PerfLedger(str(tmp_path / "perf.ndjson"))
        assert led.append({"kind": "fleet_event",
                           "fleet_event": "quarantine", "slot": 1,
                           "reason": "crash-loop: 3 deaths in 30s",
                           "attempt": 3, "backoff_s": 0.4})
        led.close()
        records, skipped = read_ledger(str(tmp_path / "perf.ndjson"))
        assert skipped == 0 and len(records) == 1
        assert records[0]["fleet_event"] == "quarantine"

    def test_undeclared_field_rejected(self, tmp_path):
        led = PerfLedger(str(tmp_path / "perf.ndjson"))
        with pytest.raises(LedgerSchemaError, match="blast_radius"):
            led.append({"kind": "fleet_event",
                        "fleet_event": "quarantine",
                        "blast_radius": "total"})
        led.close()

    def test_supervisor_writes_schema_clean_records(self, tmp_path):
        path = str(tmp_path / "fleet.ndjson")
        spawn = make_spawner(fail=lambda slot, inc: slot == 0
                             and inc < 3)
        sup = running_supervisor(fast_config(), spawn,
                                 ledger=PerfLedger(path))
        try:
            assert wait_until(
                lambda: slot_states(sup).get(0) == SLOT_DEAD)
        finally:
            sup.stop(drain=False)
        records, skipped = read_ledger(path)
        assert skipped == 0
        events = [r for r in records if r.get("kind") == "fleet_event"]
        names = {r["fleet_event"] for r in events}
        assert {"respawn", "quarantine", "add"} <= names
        quarantine = next(r for r in events
                          if r["fleet_event"] == "quarantine")
        assert quarantine["slot"] == 0
        assert "crash-loop" in quarantine["reason"]


# ----------------------------------------------------------- status block

class TestStatusBlock:
    def test_shape_and_states(self):
        spawn = make_spawner()
        sup = running_supervisor(fast_config(), spawn)
        try:
            assert wait_until(
                lambda: set(slot_states(sup).values()) == {SLOT_UP})
            block = sup.status_block()
            assert {"slots", "events", "rolling_restart"} \
                <= set(block)
            for s in block["slots"]:
                assert {"slot", "state", "replica", "pid",
                        "incarnation", "deaths", "backoff_s",
                        "reason"} <= set(s)
                assert s["state"] == SLOT_UP
                assert s["pid"] is not None
        finally:
            sup.stop(drain=False)
        assert set(slot_states(sup).values()) == {SLOT_STOPPED}


# ------------------------------------------------- the port's children


class TestPortChildren:
    def test_serve_command_runs_the_port_on_the_card_by_default(self):
        import sys

        from pbccs_tpu_torch.serve.supervisor import serve_command

        assert serve_command() == [sys.executable, "-m",
                                   "pbccs_tpu_torch.cli", "serve"]
        head = serve_command("cpu")
        assert head[:2] == [sys.executable, "-c"]
        assert "run_serve(sys.argv[1:], device='cpu')" in head[2]

    def test_child_serve_args_forward_no_compile_cache(self):
        from pbccs_tpu_torch.serve.supervisor import (build_fleet_parser,
                                                      child_serve_args)

        tail = child_serve_args(build_fleet_parser().parse_args([]))
        assert tail == ["--maxInflightPerSession", "256",
                        "--logLevel", "ERROR"]
        tail = child_serve_args(build_fleet_parser().parse_args(
            ["--compileCache", "d"]))
        assert tail == ["--maxInflightPerSession", "256",
                        "--logLevel", "ERROR", "--compileCache", "d"]

    def test_child_without_a_card_fails_visibly(self, monkeypatch):
        """With no card visible and no device named, the spawned `ccs
        serve` exits non-zero before its ready line: a SpawnError with
        the exit code, never a replica on the CPU."""
        from pbccs_tpu_torch.serve.supervisor import make_serve_spawn

        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        spawn = make_serve_spawn([], ready_timeout_s=120.0)
        with pytest.raises(SpawnError) as ei:
            spawn(0, 0)
        assert ei.value.exit_code not in (None, 0)
        assert "died before ready" in str(ei.value)


FLEET_CHILD = ("import sys\n"
               "from pbccs_tpu_torch.serve.supervisor import run_fleet\n"
               "sys.exit(run_fleet(sys.argv[1:], device='cpu'))\n")


def _alive(pid: int) -> bool:
    """True while `pid` runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, IndexError):
        return False


def test_fleet_process_on_cpu_respawns_a_crash_looped_slot(tmp_path):
    """`ccs fleet` with device="cpu" as a process: two real CPU `ccs
    serve` children, slot 1's first incarnation killed by the injected
    crash loop (exit 86) and respawned once, both slots up, a ZMW
    answered through the fleet's router, then SIGTERM: exit 0 and no
    child left."""
    import os
    import sys

    import numpy as np

    from pbccs_tpu_torch.pipeline import Chunk, Subread
    from pbccs_tpu_torch.serve.client import CcsClient
    from pbccs_tpu_torch.simulate import simulate_zmw

    ledger = str(tmp_path / "fleet.ndjson")
    # one intra-op thread per child: three torch processes beside the
    # suite's workers must not oversubscribe the host's cores
    env = dict(os.environ, PBCCS_FAULTS="serve.start:crashloop=1~1",
               OMP_NUM_THREADS="1")
    err = open(tmp_path / "fleet.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", FLEET_CHILD, "--replicas", "2",
         "--port", "0", "--perfLedger", ledger, "--backoffBase", "0.2",
         "--routerHealthInterval", "0.2", "--readyTimeout", "120"],
        stdout=subprocess.PIPE, stderr=err, text=True, env=env)
    lines: list[str] = []
    threading.Thread(target=lambda: lines.extend(proc.stdout),
                     daemon=True).start()
    pids: list[int] = []
    try:
        assert wait_until(lambda: any("CCS-FLEET-READY" in ln
                                      for ln in list(lines)),
                          timeout=120.0), lines
        ready = next(ln for ln in lines if "CCS-FLEET-READY" in ln)
        port = int(ready.split()[2])

        def block():
            with CcsClient("127.0.0.1", port, timeout=10.0) as cli:
                return cli.status(timeout=10.0)[protocol.FIELD_SUPERVISOR]

        assert wait_until(lambda: [s["state"] for s in block()["slots"]]
                          == [SLOT_UP, SLOT_UP], timeout=120.0)
        slots = block()["slots"]
        assert [s["incarnation"] for s in slots] == [0, 1]
        pids = [s["pid"] for s in slots]
        respawns = [r for r in read_ledger(ledger)[0]
                    if r.get("fleet_event") == "respawn"]
        assert [r["slot"] for r in respawns] == [1]

        _, reads, _, snr = simulate_zmw(np.random.default_rng(7), 60, 4)
        chunk = Chunk("fleet/0", [Subread(f"fleet/0/{i}", r)
                                  for i, r in enumerate(reads)], snr)
        with CcsClient("127.0.0.1", port, timeout=300.0) as cli:
            reply = cli.submit_chunk(chunk).reply(timeout=300.0)
        assert reply["type"] == "result" and reply["zmw"] == "fleet/0"
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=10.0)
        err.close()
    assert rc == 0, open(tmp_path / "fleet.err").read()[-2000:]
    assert pids and not any(_alive(p) for p in pids)
