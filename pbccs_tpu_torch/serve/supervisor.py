"""Fleet autopilot: self-healing replica supervision for `ccs serve`.

Port of pbccs_tpu.serve.supervisor: the same state machine, flags,
status block and `fleet_event` ledger records.  The children are the
port's `ccs serve` (``python -m pbccs_tpu_torch.cli serve``), which
polish on the card; with ``run_fleet(argv, device="cpu")`` (the tests)
each child calls ``run_serve(..., device="cpu")`` instead.  A child that
finds no card exits non-zero before its ready line, which surfaces as a
SpawnError with that exit code and, repeated, quarantines the slot;
nothing falls back to the CPU.  ``--compileCache DIR`` is forwarded to
every child, so a respawned replica loads the kernel libraries the
fleet already built there.

`ccs fleet` is the control plane the router deliberately is not: it
SPAWNS the replicas (router + N `ccs serve` child processes), watches
them through the same federated status/metrics plane every other tool
uses, and closes two loops the router alone cannot:

  self-healing   a crashed replica is removed from the routing table
                 (its ephemeral port is gone forever), respawned with
                 exponential backoff, and re-added under its NEW port
                 via the router's dynamic-membership API.  K rapid
                 deaths inside a sliding window quarantine the slot --
                 the same strike/bench shape sched/health.py applies to
                 devices, lifted to process granularity -- with a
                 structured reason; a quarantined slot rejoins only on
                 an explicit `ccs fleet readmit`.
  elasticity     sustained router queue depth spawns an extra replica
                 (warm-started from the shared kernel builds);
                 sustained idleness retires the youngest one by a
                 PROVEN drain: sticky homes migrate, in-flight work
                 completes or fails over, then SIGTERM -> SIGKILL past
                 the drain deadline.

`ccs fleet restart` is the zero-loss rolling deploy built from the same
primitives: one slot at a time, drain -> SIGTERM -> respawn warm ->
health-gate -> next.

Every decision (respawn, quarantine, readmit, scale_up, scale_down,
add, remove, drain_kill, rolling_restart_*) is appended to the perf
ledger as a schema-declared `fleet_event` record (meta class: the perf
gate never selects them) and kept in a bounded in-memory tail that
rides the router's status verb under `supervisor` -- which is how
`ccs top` tells a *restarting* replica from a *dead* one.

The child-process interface is injectable (``spawn_fn``), so the whole
state machine -- backoff schedule, quarantine, drain escalation,
rolling deploys -- is unit-testable with fake children and a fake
clock (tests/test_torch_supervisor.py); chip_smoke.py's router phase
exercises the real thing with an injected crash loop and a rolling
restart on the card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable

from pbccs_tpu_torch.obs.ledger import PerfLedger
from pbccs_tpu_torch.runtime.logging import Logger, LogLevel
from pbccs_tpu_torch.serve import protocol
from pbccs_tpu_torch.serve.router import (CcsRouter, RouterConfig, RouterServer,
                                    parse_replica_spec)

# slot lifecycle states; `ccs top` renders these for roster-absent rows
SLOT_STARTING = "starting"      # spawn in progress / scheduled now
SLOT_UP = "up"                  # child alive and a router member
SLOT_DRAINING = "draining"      # planned retirement: drain then stop
SLOT_RESTARTING = "restarting"  # died (or rolling); respawn scheduled
SLOT_DEAD = "dead"              # crash-loop quarantined; manual readmit
SLOT_STOPPED = "stopped"        # retired on purpose (scale-down/shutdown)

# fleet_event vocabulary (each becomes one perf-ledger meta record)
EV_ADD = "add"
EV_REMOVE = "remove"
EV_RESPAWN = "respawn"
EV_QUARANTINE = "quarantine"
EV_READMIT = "readmit"
EV_SCALE_UP = "scale_up"
EV_SCALE_DOWN = "scale_down"
EV_DRAIN_KILL = "drain_kill"
EV_ROLLING_BEGIN = "rolling_restart_begin"
EV_ROLLING_STEP = "rolling_restart_step"
EV_ROLLING_DONE = "rolling_restart_done"


class SpawnError(RuntimeError):
    """A child failed to reach CCS-SERVE-READY (died, hung past the
    ready deadline, or could not exec)."""

    def __init__(self, msg: str, exit_code: int | None = None):
        super().__init__(msg)
        self.exit_code = exit_code


@dataclasses.dataclass
class SupervisorConfig:
    """Autopilot policy knobs (see `ccs fleet --help` for the flags)."""

    replicas: int = 2                  # initial fleet size
    min_replicas: int | None = None    # scale-down floor (None = replicas)
    max_replicas: int | None = None    # scale-up ceiling (None = replicas)
    backoff_base_s: float = 0.5        # first respawn delay
    backoff_factor: float = 2.0        # growth per consecutive death
    backoff_cap_s: float = 30.0        # respawn delay ceiling
    crashloop_window_s: float = 30.0   # sliding death window
    crashloop_threshold: int = 3       # deaths in window => quarantine
    drain_timeout_s: float = 30.0      # drain budget before SIGKILL
    health_gate_timeout_s: float = 60.0  # rolling: healthy-again budget
    ready_timeout_s: float = 300.0     # spawn-to-READY budget
    scale_up_pending: int = 0          # queue depth that burns (0 = off)
    scale_up_sustain_s: float = 2.0    # burn must last this long
    scale_down_idle_s: float = 10.0    # zero-pending span before retire
    poll_interval_s: float = 0.2       # supervision tick
    event_history: int = 64            # status-verb event tail length

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError("SupervisorConfig.replicas must be >= 1")
        if self.min_replicas is None:
            self.min_replicas = self.replicas
        if self.max_replicas is None:
            self.max_replicas = max(self.replicas, self.min_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                "need 1 <= min_replicas <= max_replicas "
                f"(got {self.min_replicas}..{self.max_replicas})")
        if self.backoff_base_s <= 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff_base_s must be > 0 and "
                             "backoff_factor >= 1.0")
        if self.backoff_cap_s < self.backoff_base_s:
            raise ValueError("backoff_cap_s must be >= backoff_base_s")
        if self.crashloop_threshold < 1:
            raise ValueError("crashloop_threshold must be >= 1")


def backoff_schedule(config: SupervisorConfig, attempt: int) -> float:
    """Respawn delay before the `attempt`-th consecutive respawn
    (1-based): base * factor**(attempt-1), capped.  Pure + deterministic
    -- the chaos tests assert the exact schedule."""
    if attempt <= 0:
        return 0.0
    return min(config.backoff_cap_s,
               config.backoff_base_s
               * config.backoff_factor ** (attempt - 1))


class _Slot:
    """One supervised replica slot (supervisor lock guards all fields)."""

    def __init__(self, slot: int):
        self.slot = slot
        self.state = SLOT_STARTING
        self.child = None               # spawn_fn handle; None when down
        self.replica: str | None = None  # router membership name
        self.incarnation = 0            # next PBCCS_FLEET_INCARNATION
        self.deaths: collections.deque[float] = collections.deque()
        self.attempt = 0                # consecutive respawns so far
        self.backoff_s = 0.0            # current scheduled delay
        self.respawn_at = 0.0           # clock() time of next spawn
        self.reason = ""                # structured quarantine/retire why
        self.spawning = False           # spawn worker in flight
        self.managed = False            # rolling/retire worker owns it


class FleetSupervisor:
    """The autopilot state machine over a CcsRouter and its children.

    ``spawn_fn(slot, incarnation) -> handle`` must block until the child
    is serving and return a handle with ``host``/``port``/``pid``,
    ``poll()`` (exit code or None), ``send_signal(sig)``, ``kill()`` and
    ``wait(timeout)`` (raising subprocess.TimeoutExpired/TimeoutError),
    or raise SpawnError.  ``clock`` is injectable for deterministic
    backoff tests."""

    def __init__(self, router: CcsRouter, config: SupervisorConfig,
                 spawn_fn: Callable[[int, int], object],
                 clock: Callable[[], float] = time.monotonic,
                 ledger: PerfLedger | None = None,
                 logger: Logger | None = None):
        self.router = router
        self.config = config
        self.spawn_fn = spawn_fn
        self.clock = clock
        self._ledger = ledger
        self._log = logger or Logger.default()
        self._lock = threading.Lock()
        self._slots: dict[int, _Slot] = {}
        self._events: collections.deque[dict] = collections.deque(
            maxlen=config.event_history)
        self._rolling: dict | None = None
        self._burn_since: float | None = None
        self._idle_since: float | None = None
        self._stop = threading.Event()
        self._loop_thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "FleetSupervisor":
        with self._lock:
            for i in range(self.config.replicas):
                self._slots[i] = _Slot(i)
        self._loop_thread = threading.Thread(
            target=self._loop, daemon=True, name="ccs-fleet-supervisor")
        self._loop_thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop supervising and shut every child down (drain = SIGTERM
        first, SIGKILL past the drain budget; else straight SIGKILL)."""
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)
        with self._lock:
            children = [(s, s.child) for s in self._slots.values()
                        if s.child is not None]
            for s, _ in children:
                s.state = SLOT_STOPPED
        for s, child in children:
            self._shutdown_child(s, child,
                                 self.config.drain_timeout_s
                                 if drain else 0.0)
        with self._lock:
            for s, _ in children:
                s.child = None
                s.replica = None

    # ----------------------------------------------------------- main loop

    def _loop(self) -> None:
        while not self._stop.wait(self.config.poll_interval_s):
            try:
                self._tick_slots()
                self._tick_autoscale()
            except Exception as e:  # supervision must outlive surprises
                self._log.warn(f"fleet: supervision tick failed: {e!r}")

    def _tick_slots(self) -> None:
        now = self.clock()
        with self._lock:
            slots = list(self._slots.values())
        for s in slots:
            with self._lock:
                if s.managed or s.spawning:
                    continue
                # a quiet stretch resets the consecutive-death streak:
                # backoff growth punishes crash LOOPS, not a monthly blip
                while s.deaths and now - s.deaths[0] \
                        > self.config.crashloop_window_s:
                    s.deaths.popleft()
                if s.state == SLOT_UP and not s.deaths:
                    s.attempt = 0
                    s.backoff_s = 0.0
                child = s.child
                spawn_due = (child is None
                             and s.state in (SLOT_STARTING,
                                             SLOT_RESTARTING)
                             and now >= s.respawn_at)
            if child is not None and child.poll() is not None:
                self._record_death(s, f"exit {child.poll()}")
                continue
            if spawn_due:
                self._launch_spawn(s)

    # ------------------------------------------------------- spawn/respawn

    def _launch_spawn(self, s: _Slot) -> None:
        with self._lock:
            if s.spawning or s.child is not None:
                return
            s.spawning = True
            s.state = SLOT_STARTING
        threading.Thread(target=self._spawn_worker, args=(s,),
                         daemon=True,
                         name=f"ccs-fleet-spawn-{s.slot}").start()

    def _spawn_worker(self, s: _Slot) -> None:
        with self._lock:
            incarnation = s.incarnation
            s.incarnation += 1
        try:
            child = self.spawn_fn(s.slot, incarnation)
        except SpawnError as e:
            with self._lock:
                s.spawning = False
            self._record_death(s, str(e))
            return
        try:
            name = self.router.add_replica((child.host, child.port))
        except ValueError as e:
            # membership refused (dup name / shutdown): not a crash loop
            self._log.warn(f"fleet: slot {s.slot} join refused: {e}")
            child.kill()
            with self._lock:
                s.spawning = False
            self._record_death(s, f"join refused: {e}")
            return
        with self._lock:
            s.child = child
            s.replica = name
            s.state = SLOT_UP
            s.reason = ""
            s.spawning = False
            self._event(EV_ADD, slot=s.slot, reason=name,
                        attempt=s.attempt)
        self._log.info(f"fleet: slot {s.slot} up as {name} "
                       f"(incarnation {incarnation})")

    def _record_death(self, s: _Slot, why: str) -> None:
        """A child died (or never reached ready): sweep it out of the
        router, then either quarantine the slot or schedule a backed-off
        respawn.  Never called with the supervisor lock held."""
        now = self.clock()
        with self._lock:
            if s.child is not None:
                try:
                    s.child.kill()  # reap a half-dead handle for certain
                except Exception:  # noqa: BLE001 -- already-dead is fine
                    pass
            s.child = None
            name, s.replica = s.replica, None
            s.deaths.append(now)
            while s.deaths and now - s.deaths[0] \
                    > self.config.crashloop_window_s:
                s.deaths.popleft()
            quarantine = len(s.deaths) >= self.config.crashloop_threshold
            if quarantine:
                s.state = SLOT_DEAD
                s.reason = (f"crash-loop: {len(s.deaths)} deaths in "
                            f"{self.config.crashloop_window_s:g}s "
                            f"({why}); `ccs fleet readmit --slot "
                            f"{s.slot}` to retry")
                s.backoff_s = 0.0
                self._event(EV_QUARANTINE, slot=s.slot, reason=s.reason)
            else:
                s.attempt += 1
                s.backoff_s = backoff_schedule(self.config, s.attempt)
                s.respawn_at = now + s.backoff_s
                s.state = SLOT_RESTARTING
                s.reason = why
                self._event(EV_RESPAWN, slot=s.slot, reason=why,
                            attempt=s.attempt, backoff_s=s.backoff_s)
        if name is not None:
            self._router_remove(name, drain=False, timeout_s=0.0)
        if quarantine:
            self._log.warn(f"fleet: slot {s.slot} QUARANTINED ({why})")
        else:
            self._log.warn(f"fleet: slot {s.slot} died ({why}); respawn "
                           f"in {s.backoff_s:.2f}s (attempt {s.attempt})")

    def _router_remove(self, name: str, drain: bool,
                       timeout_s: float) -> None:
        try:
            out = self.router.remove_replica(name, drain=drain,
                                             timeout_s=timeout_s)
        except ValueError:
            return  # already gone (e.g. an admin removed it first)
        with self._lock:
            self._event(EV_REMOVE, slot=None, reason=name,
                        backoff_s=None,
                        attempt=out.get("failed_over") or None)

    # -------------------------------------------------------- autoscaling

    def _active_count(self) -> int:
        """Slots that are serving or will be shortly (lock held)."""
        return sum(1 for s in self._slots.values()
                   if s.state in (SLOT_UP, SLOT_STARTING,
                                  SLOT_RESTARTING))

    def _tick_autoscale(self) -> None:
        if self.config.max_replicas <= self.config.min_replicas \
                and self.config.scale_up_pending <= 0:
            return
        with self._lock:
            if self._rolling is not None:
                self._burn_since = self._idle_since = None
                return
        pending = self.router.pending_count()
        now = self.clock()
        if self.config.scale_up_pending > 0 \
                and pending > self.config.scale_up_pending:
            self._idle_since = None
            if self._burn_since is None:
                self._burn_since = now
            elif now - self._burn_since >= self.config.scale_up_sustain_s:
                self._burn_since = None
                self._scale_up(pending)
            return
        self._burn_since = None
        if pending > 0:
            self._idle_since = None
            return
        if self._idle_since is None:
            self._idle_since = now
        elif now - self._idle_since >= self.config.scale_down_idle_s:
            self._idle_since = None
            self._scale_down()

    def _scale_up(self, pending: int) -> None:
        with self._lock:
            if self._active_count() >= self.config.max_replicas:
                return
            if any(s.spawning for s in self._slots.values()):
                return  # one membership change at a time
            # reuse a retired slot id before minting a new one, so the
            # roster stays compact across breathe-in/breathe-out cycles
            stopped = [s for s in self._slots.values()
                       if s.state == SLOT_STOPPED]
            if stopped:
                s = min(stopped, key=lambda s: s.slot)
                s.state = SLOT_STARTING
                s.respawn_at = 0.0
                s.reason = ""
            else:
                sid = max(self._slots) + 1 if self._slots else 0
                s = self._slots[sid] = _Slot(sid)
            self._event(EV_SCALE_UP, slot=s.slot,
                        reason=f"pending={pending} sustained "
                               f"{self.config.scale_up_sustain_s:g}s")
        self._log.info(f"fleet: scale up -> slot {s.slot} "
                       f"(pending={pending})")

    def _scale_down(self) -> None:
        with self._lock:
            up = [s for s in self._slots.values() if s.state == SLOT_UP
                  and not s.managed and s.child is not None]
            if self._active_count() <= self.config.min_replicas or not up:
                return
            s = max(up, key=lambda s: s.slot)  # retire the youngest
            s.state = SLOT_DRAINING
            s.managed = True
            s.reason = (f"idle {self.config.scale_down_idle_s:g}s; "
                        "draining for retirement")
            self._event(EV_SCALE_DOWN, slot=s.slot, reason=s.reason)
        self._log.info(f"fleet: scale down -> draining slot {s.slot}")
        threading.Thread(target=self._retire_worker, args=(s,),
                         daemon=True,
                         name=f"ccs-fleet-retire-{s.slot}").start()

    def _retire_worker(self, s: _Slot) -> None:
        try:
            with self._lock:
                name, child = s.replica, s.child
            if name is not None:
                self._router_remove(name, drain=True,
                                    timeout_s=self.config.drain_timeout_s)
            if child is not None:
                self._shutdown_child(s, child,
                                     self.config.drain_timeout_s)
            with self._lock:
                s.child = None
                s.replica = None
                s.state = SLOT_STOPPED
        finally:
            with self._lock:
                s.managed = False

    def _shutdown_child(self, s: _Slot, child,
                        drain_timeout_s: float) -> None:
        """SIGTERM (the replica drains itself) with SIGKILL escalation
        past the budget -- the drain_kill ledger event marks the
        escalation so a stuck build is visible in the audit trail."""
        if drain_timeout_s > 0:
            try:
                child.send_signal(signal.SIGTERM)
            except Exception:  # noqa: BLE001 -- racing an exited child
                pass
            try:
                child.wait(timeout=drain_timeout_s)
                return
            except (subprocess.TimeoutExpired, TimeoutError):
                pass
        try:
            child.kill()
            child.wait(timeout=10.0)
        except Exception:  # noqa: BLE001 -- SIGKILL is the last resort
            pass
        with self._lock:
            self._event(EV_DRAIN_KILL, slot=s.slot,
                        reason=f"drain budget {drain_timeout_s:g}s "
                               "exceeded; escalated to SIGKILL")

    # ---------------------------------------------------- rolling restart

    def request_rolling_restart(self) -> bool:
        """Begin a zero-loss rolling deploy; False when one is already
        running."""
        with self._lock:
            if self._rolling is not None:
                return False
            plan = sorted(s.slot for s in self._slots.values()
                          if s.state == SLOT_UP and not s.managed)
            self._rolling = {"state": "running", "plan": plan,
                             "done": [], "current": None}
            self._event(EV_ROLLING_BEGIN,
                        reason=f"slots {plan}")
        threading.Thread(target=self._rolling_worker, daemon=True,
                         name="ccs-fleet-rolling").start()
        return True

    def _rolling_worker(self) -> None:
        with self._lock:
            plan = list(self._rolling["plan"])
        ok = True
        for sid in plan:
            if self._stop.is_set():
                ok = False
                break
            if not self._rolling_step(sid):
                ok = False
                break
        with self._lock:
            state = "done" if ok else "failed"
            self._event(EV_ROLLING_DONE,
                        reason=f"{state}: "
                               f"{len(self._rolling['done'])}/"
                               f"{len(plan)} slots cycled")
            self._rolling = None
        self._log.info(f"fleet: rolling restart {state}")

    def _rolling_step(self, sid: int) -> bool:
        """Cycle ONE slot: drain -> SIGTERM -> respawn warm ->
        health-gate.  Never holds the supervisor lock across a router
        or child call."""
        with self._lock:
            s = self._slots.get(sid)
            if s is None or s.state != SLOT_UP or s.managed:
                return True  # it left the roster since planning; skip
            s.managed = True
            s.state = SLOT_RESTARTING
            s.reason = "rolling deploy"
            self._rolling["current"] = sid
            name, child = s.replica, s.child
        try:
            if name is not None:
                self._router_remove(name, drain=True,
                                    timeout_s=self.config.drain_timeout_s)
            if child is not None:
                self._shutdown_child(s, child,
                                     self.config.drain_timeout_s)
            with self._lock:
                s.child = None
                s.replica = None
                incarnation = s.incarnation
                s.incarnation += 1
            try:
                new_child = self.spawn_fn(s.slot, incarnation)
            except SpawnError as e:
                # hand the slot back to the self-healing path (it owns
                # backoff + quarantine) and stop the deploy: a build
                # that cannot come back up must not take down the rest
                with self._lock:
                    s.managed = False
                self._record_death(s, f"rolling respawn failed: {e}")
                return False
            try:
                new_name = self.router.add_replica(
                    (new_child.host, new_child.port))
            except ValueError as e:
                new_child.kill()
                with self._lock:
                    s.managed = False
                self._record_death(s, f"rolling join refused: {e}")
                return False
            with self._lock:
                s.child = new_child
                s.replica = new_name
                s.state = SLOT_UP
                s.reason = ""
            gated = self._health_gate(new_name)
            with self._lock:
                self._rolling["done"].append(sid)
                self._rolling["current"] = None
                self._event(EV_ROLLING_STEP, slot=sid, reason=new_name)
            if not gated:
                self._log.warn(f"fleet: rolling: {new_name} never went "
                               "healthy inside the gate; aborting")
                return False
            return True
        finally:
            with self._lock:
                s.managed = False

    def _health_gate(self, name: str) -> bool:
        """Block until the router reports `name` connected AND healthy
        (or the gate budget runs out) -- the rolling deploy only moves
        to the next slot behind a proven-good replacement."""
        deadline = self.clock() + self.config.health_gate_timeout_s
        while self.clock() < deadline and not self._stop.is_set():
            for r in self.router.status().get("replicas", ()):
                if r.get("replica") == name and r.get("connected") \
                        and r.get("healthy"):
                    return True
            time.sleep(self.config.poll_interval_s)
        return False

    # ------------------------------------------------------------- admin

    def readmit(self, slot: int) -> None:
        """Manually un-quarantine a slot (`ccs fleet readmit`)."""
        with self._lock:
            s = self._slots.get(slot)
            if s is None:
                raise ValueError(f"unknown slot {slot} (have "
                                 f"{sorted(self._slots)})")
            if s.state != SLOT_DEAD:
                raise ValueError(
                    f"slot {slot} is {s.state}, not quarantined")
            s.deaths.clear()
            s.attempt = 0
            s.backoff_s = 0.0
            s.respawn_at = self.clock()
            s.state = SLOT_RESTARTING
            s.reason = ""
            self._event(EV_READMIT, slot=slot)
        self._log.info(f"fleet: slot {slot} re-admitted")

    def status_block(self) -> dict:
        """The `supervisor` field of the router's status verb.  Touches
        ONLY supervisor state: the router calls this while its own lock
        is released, and taking the router lock here would invert the
        add/remove_replica lock order."""
        with self._lock:
            slots = [{
                "slot": s.slot,
                "state": s.state,
                "replica": s.replica,
                "pid": getattr(s.child, "pid", None),
                "incarnation": max(s.incarnation - 1, 0),
                "deaths": len(s.deaths),
                "backoff_s": round(s.backoff_s, 3),
                "reason": s.reason,
            } for _, s in sorted(self._slots.items())]
            rolling = dict(self._rolling) if self._rolling else None
            return {protocol.KEY_SUP_SLOTS: slots,
                    protocol.KEY_SUP_EVENTS: list(self._events),
                    protocol.KEY_SUP_ROLLING: rolling}

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def _event(self, event: str, slot: int | None = None,
               reason: str = "", attempt: int | None = None,
               backoff_s: float | None = None) -> None:
        """Record one autopilot decision (lock held by caller): bounded
        in-memory tail for the status verb + one schema-declared
        fleet_event ledger record (meta: the perf gate ignores them)."""
        rec = {"t_event": round(time.time(), 3), "event": event}
        if slot is not None:
            rec["slot"] = slot
        if reason:
            rec["reason"] = reason
        if attempt is not None:
            rec["attempt"] = attempt
        if backoff_s is not None:
            rec["backoff_s"] = round(backoff_s, 3)
        self._events.append(rec)
        if self._ledger is not None:
            led = {"kind": "fleet_event", "fleet_event": event}
            for k in ("slot", "reason", "attempt", "backoff_s"):
                if k in rec:
                    led[k] = rec[k]
            self._ledger.append(led)


# --------------------------------------------------------- real children

class _ProcChild:
    """subprocess.Popen adapter satisfying the spawn_fn handle shape."""

    def __init__(self, proc: subprocess.Popen, host: str, port: int):
        self.proc = proc
        self.host = host
        self.port = port

    @property
    def pid(self) -> int:
        return self.proc.pid

    def poll(self):
        return self.proc.poll()

    def send_signal(self, sig) -> None:
        try:
            self.proc.send_signal(sig)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        try:
            self.proc.kill()
        except ProcessLookupError:
            pass

    def wait(self, timeout=None):
        return self.proc.wait(timeout)


def serve_command(device=None) -> list[str]:
    """The argv head of one `ccs serve` child: the port's CLI, which
    polishes on the card, or with `device` a run_serve(..., device=...)
    child (the tests pass device="cpu")."""
    if device is None:
        return [sys.executable, "-m", "pbccs_tpu_torch.cli", "serve"]
    return [sys.executable, "-c",
            "import sys\n"
            "from pbccs_tpu_torch.serve.server import run_serve\n"
            f"sys.exit(run_serve(sys.argv[1:], device={str(device)!r}))\n"]


def make_serve_spawn(serve_args: list[str], ready_timeout_s: float,
                     logger: Logger | None = None, *, device=None
                     ) -> Callable[[int, int], _ProcChild]:
    """The production spawn_fn: one `ccs serve --port 0` subprocess per
    call (serve_command(device)), blocking until its CCS-SERVE-READY
    line.  The slot id and the 0-based respawn counter ride the
    environment (PBCCS_FLEET_SLOT / PBCCS_FLEET_INCARNATION) so fault
    injection can target one slot's early incarnations
    (`serve.start:crashloop=3~1`)."""
    log = logger or Logger.default()
    head = serve_command(device)

    def spawn(slot: int, incarnation: int) -> _ProcChild:
        cmd = head + ["--host", "127.0.0.1", "--port", "0"] \
            + list(serve_args)
        env = dict(os.environ,
                   PBCCS_FLEET_SLOT=str(slot),
                   PBCCS_FLEET_INCARNATION=str(incarnation))
        try:
            proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL, text=True)
        except OSError as e:
            raise SpawnError(f"slot {slot}: exec failed: {e}") from None
        # ready-or-dead: the watchdog kills a child that is alive but
        # silent past the deadline, turning the hang into stdout EOF
        watchdog = threading.Timer(max(ready_timeout_s, 1.0), proc.kill)
        watchdog.daemon = True
        watchdog.start()
        try:
            line = proc.stdout.readline()
            while line and not line.startswith("CCS-SERVE-READY"):
                line = proc.stdout.readline()
        finally:
            watchdog.cancel()
        if not line:
            try:
                rc = proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait(timeout=10.0)
            raise SpawnError(
                f"slot {slot} incarnation {incarnation} died before "
                f"ready (exit {rc})", exit_code=rc)
        _, host, port = line.split()[:3]
        # keep draining stdout forever: a full pipe would wedge the child
        threading.Thread(
            target=lambda: collections.deque(proc.stdout, maxlen=0),
            daemon=True, name=f"ccs-fleet-stdout-{slot}").start()
        log.debug(f"fleet: slot {slot} child pid {proc.pid} ready on "
                  f"{host}:{port}")
        return _ProcChild(proc, host, int(port))

    return spawn


# ------------------------------------------------------------- ccs fleet

def build_fleet_parser() -> argparse.ArgumentParser:
    rdefaults = RouterConfig(allow_empty=True)
    sdefaults = SupervisorConfig()
    p = argparse.ArgumentParser(
        prog="ccs fleet",
        description="Self-healing serve fleet: a supervised router + N "
                    "`ccs serve` replicas with crash respawn, "
                    "crash-loop quarantine, autoscaling and zero-loss "
                    "rolling restarts.  With no action, runs the "
                    "fleet; with an action, administers a running one "
                    "over its router port.")
    p.add_argument("action", nargs="?", default="run",
                   choices=["run", "list", "add", "remove", "restart",
                            "readmit"],
                   help="run (default) = supervise a fleet; the rest "
                        "are admin verbs against --target.")
    # ----- admin-client knobs
    p.add_argument("--target", metavar="HOST:PORT", default=None,
                   help="Router address for admin actions.")
    p.add_argument("--replica", metavar="HOST:PORT", default=None,
                   help="Replica to add/remove (admin actions).")
    p.add_argument("--slot", type=int, default=None,
                   help="Quarantined slot to readmit.")
    p.add_argument("--noDrain", action="store_true",
                   help="remove: skip the drain (fail over in-flight "
                        "work immediately).")
    # ----- fleet-run knobs
    p.add_argument("--host", default="127.0.0.1",
                   help="Router bind address. Default = %(default)s")
    p.add_argument("--port", type=int, default=7330,
                   help="Router bind port (0 = ephemeral). "
                        "Default = %(default)s")
    p.add_argument("--replicas", type=int, default=sdefaults.replicas,
                   help="Initial replica count. Default = %(default)s")
    p.add_argument("--minReplicas", type=int, default=None,
                   help="Autoscale floor. Default = --replicas")
    p.add_argument("--maxReplicas", type=int, default=None,
                   help="Autoscale ceiling. Default = --replicas "
                        "(autoscaling up disabled)")
    p.add_argument("--serveArg", action="append", default=[],
                   metavar="ARG",
                   help="Extra argument passed to every `ccs serve` "
                        "child (repeatable; use --serveArg=--flag=v "
                        "for flag-shaped values).")
    p.add_argument("--compileCache", default=None, metavar="DIR",
                   help="Persistent compile cache shared by every "
                        "replica: respawns and scale-ups warm-start "
                        "instead of recompiling. Default: off.")
    p.add_argument("--backoffBase", type=float,
                   default=sdefaults.backoff_base_s,
                   help="First respawn delay (seconds); doubles per "
                        "consecutive death. Default = %(default)s")
    p.add_argument("--backoffCap", type=float,
                   default=sdefaults.backoff_cap_s,
                   help="Respawn delay ceiling. Default = %(default)s")
    p.add_argument("--crashloopWindow", type=float,
                   default=sdefaults.crashloop_window_s,
                   help="Sliding window for the quarantine counter. "
                        "Default = %(default)s")
    p.add_argument("--crashloopThreshold", type=int,
                   default=sdefaults.crashloop_threshold,
                   help="Deaths inside the window that quarantine the "
                        "slot. Default = %(default)s")
    p.add_argument("--scaleUpPending", type=int,
                   default=sdefaults.scale_up_pending,
                   help="Router queue depth that triggers a scale-up "
                        "when sustained (0 disables). "
                        "Default = %(default)s")
    p.add_argument("--scaleUpSustain", type=float,
                   default=sdefaults.scale_up_sustain_s,
                   help="Seconds the queue must stay burning before a "
                        "scale-up. Default = %(default)s")
    p.add_argument("--scaleDownIdle", type=float,
                   default=sdefaults.scale_down_idle_s,
                   help="Seconds of zero pending work before the "
                        "youngest replica is drained away. "
                        "Default = %(default)s")
    p.add_argument("--readyTimeout", type=float,
                   default=sdefaults.ready_timeout_s,
                   help="Spawn-to-READY budget per child. "
                        "Default = %(default)s")
    p.add_argument("--healthGateTimeout", type=float,
                   default=sdefaults.health_gate_timeout_s,
                   help="Rolling restart: how long a respawned replica "
                        "gets to probe healthy before the deploy "
                        "aborts. Default = %(default)s")
    p.add_argument("--routerHealthInterval", type=float,
                   default=rdefaults.health_interval_s,
                   help="Router health-probe cadence. "
                        "Default = %(default)s")
    p.add_argument("--routerHealthTimeout", type=float,
                   default=rdefaults.health_timeout_s,
                   help="Unanswered-probe strike deadline. "
                        "Default = %(default)s")
    p.add_argument("--drainTimeout", type=float,
                   default=sdefaults.drain_timeout_s,
                   help="Drain budget (replica retirement, rolling "
                        "steps, admin remove) before SIGKILL. "
                        "Default = %(default)s")
    p.add_argument("--metricsPort", type=int, default=0,
                   help="Federated /metrics endpoint port (-1 = "
                        "ephemeral, 0 = off). Default = %(default)s")
    p.add_argument("--perfLedger", default=None, metavar="PATH",
                   help="Append fleet_event audit records (and the "
                        "router's fleet snapshots) to PATH. "
                        "Default: off.")
    p.add_argument("--perfLedgerInterval", type=float,
                   default=rdefaults.perf_ledger_interval_s,
                   help="Router fleet-snapshot cadence. "
                        "Default = %(default)s")
    # ----- multi-tenant edge (serve/tenancy.py): one flag set secures
    # every surface -- router front door, metrics endpoint, spawned
    # replicas, router->replica links, and the admin client
    p.add_argument("--tlsCert", default=None, metavar="PEM",
                   help="TLS certificate chain for the router front "
                        "door, the metrics endpoint AND every spawned "
                        "replica (with --tlsKey). Default: plaintext.")
    p.add_argument("--tlsKey", default=None, metavar="PEM",
                   help="TLS private key (with --tlsCert).")
    p.add_argument("--authTokens", default=None, metavar="FILE",
                   help="JSON token->tenant map applied at the router "
                        "edge AND passed to every replica; enables "
                        "per-tenant fair queuing + SLO shedding. "
                        "Default: open.")
    p.add_argument("--tlsCa", default=None, metavar="PEM",
                   help="CA bundle verifying replica/router certs for "
                        "the router links and admin actions; also "
                        "switches those connections to TLS.")
    p.add_argument("--authToken", default=None, metavar="TOKEN",
                   help="Bearer token for the router's replica links "
                        "(map it to a trusted tenant in --authTokens) "
                        "and for admin actions against --target.")
    p.add_argument("--shedBurnRate", type=float,
                   default=rdefaults.shed_burn_threshold,
                   help="Fleet SLO burn rate past which priority >= 1 "
                        "tenants are shed (0 disables). "
                        "Default = %(default)s")
    p.add_argument("--shedRetryMs", type=float,
                   default=rdefaults.retry_after_ms,
                   help="retry_after_ms hint on shed/quota rejections. "
                        "Default = %(default)s")
    p.add_argument("--tenantQueueDepth", type=int,
                   default=rdefaults.fair_queue_depth,
                   help="Parked submits per tenant before rejection. "
                        "Default = %(default)s")
    p.add_argument("--logLevel", default="INFO")
    return p


def child_serve_args(args) -> list[str]:
    """The argv tail every spawned `ccs serve` child gets.  The edge
    security flags pass DOWN: a TLS'd/token-guarded fleet must not spawn
    plaintext-open replicas on adjacent ports (the user's --serveArg
    values still come last so an argparse rematch lets them win)."""
    serve_args = ["--maxInflightPerSession", "256",
                  "--logLevel", "ERROR"]
    if args.compileCache:
        serve_args += ["--compileCache", args.compileCache]
    if args.tlsCert:
        serve_args += ["--tlsCert", args.tlsCert, "--tlsKey", args.tlsKey]
    if args.authTokens:
        serve_args += ["--authTokens", args.authTokens]
    serve_args += list(args.serveArg)
    return serve_args


def _fleet_admin(args, log: Logger) -> int:
    """One fleet admin verb round-tripped over a raw router session."""
    if not args.target:
        print("ccs fleet: admin actions need --target HOST:PORT",
              file=sys.stderr)
        return 2
    try:
        host, port = parse_replica_spec(args.target)
    except ValueError as e:
        print(f"ccs fleet: {e}", file=sys.stderr)
        return 2
    frame: dict = {"verb": protocol.VERB_FLEET, "id": "fleet-admin",
                   "action": args.action}
    if args.action in ("add", "remove"):
        if not args.replica:
            print(f"ccs fleet {args.action}: needs --replica HOST:PORT",
                  file=sys.stderr)
            return 2
        frame["replica"] = args.replica
        if args.action == "remove":
            frame["drain"] = not args.noDrain
            frame["timeout_s"] = args.drainTimeout
    if args.action == "readmit":
        if args.slot is None:
            print("ccs fleet readmit: needs --slot N", file=sys.stderr)
            return 2
        frame["slot"] = args.slot
    if args.authToken:
        # token-guarded router: every admin frame authenticates
        frame[protocol.FIELD_AUTH] = args.authToken
    try:
        with socket.create_connection((host, port), timeout=30.0) as c:
            if args.tlsCa:
                from pbccs_tpu_torch.serve import tenancy

                c = tenancy.client_ssl_context(args.tlsCa).wrap_socket(
                    c, server_hostname=host)
            c.sendall(json.dumps(frame).encode() + b"\n")
            rf = c.makefile("rb")
            while True:
                line = rf.readline()
                if not line:
                    print("ccs fleet: connection closed before a reply",
                          file=sys.stderr)
                    return 1
                msg = json.loads(line)
                if msg.get("id") == frame["id"]:
                    break
    except OSError as e:
        print(f"ccs fleet: cannot reach {host}:{port}: {e}",
              file=sys.stderr)
        return 1
    print(json.dumps(msg, indent=2, sort_keys=True))
    return 0 if msg.get("type") == protocol.TYPE_FLEET else 1


def run_fleet(argv: list[str] | None = None, *, device=None) -> int:
    """`ccs fleet` entry point (dispatched from pbccs_tpu_torch.cli).
    `device` as run_serve takes it: None spawns children that polish on
    the card, "cpu" children that run the kernels' plain versions."""
    args = build_fleet_parser().parse_args(argv)
    log = Logger.default(Logger(level=LogLevel.from_string(args.logLevel)))
    if args.action != "run":
        return _fleet_admin(args, log)

    # children: quiet by default, per-session cap sized to the trusted
    # router link (it multiplexes every client over one session); the
    # edge security flags pass down so the whole fleet shares one
    # identity surface (child_serve_args is unit-tested directly)
    serve_args = child_serve_args(args)
    from pbccs_tpu_torch.serve import tenancy
    from pbccs_tpu_torch.serve.server import load_edge_config

    edge = load_edge_config(args, "ccs fleet")
    if edge is None:
        return 2
    ssl_ctx, tenants = edge
    link_ssl = (tenancy.client_ssl_context(args.tlsCa)
                if args.tlsCa or args.tlsCert else None)
    if tenants is not None:
        # the router's own link identity must exist in the token file
        # and be trusted, or every spawned replica would reject the
        # router's probes/submits -- fail at startup, not in production
        row = tenants.authenticate(args.authToken) \
            if args.authToken else None
        if row is None or not row.trusted:
            print("ccs fleet: --authTokens needs --authToken mapping to "
                  "a TRUSTED tenant (the router's replica-link identity)",
                  file=sys.stderr)
            return 2

    try:
        rconfig = RouterConfig(
            allow_empty=True,  # membership is the supervisor's job
            health_interval_s=args.routerHealthInterval,
            health_timeout_s=args.routerHealthTimeout,
            perf_ledger_path=args.perfLedger,
            perf_ledger_interval_s=args.perfLedgerInterval,
            fair_queue_depth=args.tenantQueueDepth,
            shed_burn_threshold=args.shedBurnRate,
            retry_after_ms=args.shedRetryMs)
        sconfig = SupervisorConfig(
            replicas=args.replicas,
            min_replicas=args.minReplicas,
            max_replicas=args.maxReplicas,
            backoff_base_s=args.backoffBase,
            backoff_cap_s=args.backoffCap,
            crashloop_window_s=args.crashloopWindow,
            crashloop_threshold=args.crashloopThreshold,
            drain_timeout_s=args.drainTimeout,
            health_gate_timeout_s=args.healthGateTimeout,
            ready_timeout_s=args.readyTimeout,
            scale_up_pending=args.scaleUpPending,
            scale_up_sustain_s=args.scaleUpSustain,
            scale_down_idle_s=args.scaleDownIdle)
    except ValueError as e:
        print(f"ccs fleet: {e}", file=sys.stderr)
        return 2
    router = CcsRouter([], rconfig, logger=log, tenants=tenants,
                       link_ssl=link_ssl, link_token=args.authToken)
    # the supervisor's audit ledger appends to the same NDJSON file as
    # the router's snapshot loop; O_APPEND + one-line flushed writes
    # keep the two interleavable without a shared handle
    ledger = PerfLedger(args.perfLedger, logger=log) \
        if args.perfLedger else None
    supervisor = FleetSupervisor(
        router, sconfig,
        make_serve_spawn(serve_args, args.readyTimeout, log,
                         device=device),
        ledger=ledger, logger=log)
    with router:
        router.set_supervisor(supervisor)
        server = RouterServer(router, args.host, args.port, logger=log,
                              ssl_context=ssl_ctx, tenants=tenants)
        server.start()
        from pbccs_tpu_torch.serve.server import start_metrics_endpoint

        metrics_http = start_metrics_endpoint(
            args.metricsPort, router.metrics_text, args.host, log,
            health=router.accepting, ssl_context=ssl_ctx)
        supervisor.start()
        print(f"CCS-FLEET-READY {server.host} {server.port}", flush=True)

        stop = threading.Event()

        def _on_signal(signum, frame):
            print(f"CCS-FLEET-DRAINING "
                  f"signal={signal.Signals(signum).name}", flush=True)
            stop.set()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _on_signal)
            except ValueError:  # not the main thread (embedded fleet)
                pass
        try:
            stop.wait()
        except KeyboardInterrupt:
            pass
        log.info("ccs fleet draining: children first, then the router")
        server.stop_accepting()
        server.notify_draining()
        supervisor.stop(drain=True)
        drained = router.close(drain=True, deadline_s=args.drainTimeout)
        server.shutdown()
        if metrics_http is not None:
            metrics_http.shutdown()
        if ledger is not None:
            ledger.close()
        log.info("ccs fleet drained cleanly" if drained
                 else "ccs fleet drain deadline hit; failed remainder")
    log.flush()
    return 0
