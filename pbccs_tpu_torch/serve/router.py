"""`ccs router`: a health-checked front door over N `ccs serve` replicas.

Port of pbccs_tpu.serve.router: the same routing, failover, verbs,
flags, metric names, wire fields and ledger kinds.  The router process
makes no CUDA tensor and creates no CUDA context: it routes frames, and
the replicas own the card.

The serve engine made one PROCESS the failure domain: a crashed or
drained `ccs serve` loses every in-flight session.  The router lifts the
device-fleet resilience idioms (pbccs_tpu_torch/sched: sticky routing,
bench-and-requeue, bounded failure tours) to replica granularity:

  * **Sticky bucket-aware routing.**  Each submit is validated at the
    edge (the same `chunk_from_wire` contract the replicas apply), keyed
    by its approximate shape bucket (read-length geometry; the
    replica's prep stage derives the exact bucket), and routed with the
    shared ``sched.health.StickyMap`` -- the replica that already
    ran a bucket's shapes keeps receiving it, spilling to the
    least-loaded healthy replica only past ``spill_depth`` in-flight
    (work-conserving stickiness, exactly the DevicePool rule).  Load is
    weighted by the replica's STATUS-REPORTED queue depth, not the
    router's own in-flight count alone: each health probe's `status`
    reply carries the engine's `pending` figure, and the excess over
    what this router has in flight (work admitted from other clients,
    or a backlog the engine is still chewing) counts toward the
    replica's effective depth -- an unevenly-loaded fleet spills away
    from the busy replica instead of queueing blindly behind it.
  * **Health checks.**  A background loop probes every replica with the
    protocol's `status` verb; a probe unanswered past
    ``health_timeout_s`` is a strike, ``bench_after`` strikes mark the
    replica unhealthy (``sched.health.HealthTracker``), and -- unlike a
    benched device -- a later successful probe RE-ADMITS it (a restarted
    replica routinely comes back).  `status` replies also carry the
    replica's ``accepting`` flag, so a SIGTERM-draining replica stops
    receiving new work before its socket ever closes.
  * **Failover with exactly-once replies.**  Every client submit gets a
    router-assigned request id (the protocol's id field is rewritten on
    both hops).  When a replica dies (connection loss), times out its
    probes, or rejects with `overloaded`/`closed`, its unanswered
    requests are transparently resubmitted to a healthy replica the
    request has not yet visited (``attempted`` bounds the tour to the
    fleet, mirroring ``_Task.excluded``).  A reply that RACES a failover
    is emitted exactly once: the first reply for an id wins, completes
    the request, and any later duplicate finds the id retired and is
    dropped (counted ``ccs_router_dedup_dropped_total``).  Polish is
    pure, so the duplicated device work is waste, never corruption.

The router front door reuses the serve server's framed-session armor
(`server._FramedSession`): max frame length, idle reap, per-session
in-flight cap, and abort accounting all behave identically at both
tiers.

The multi-tenant edge (serve/tenancy.py) layers in FRONT of routing:
with ``--authTokens`` every session authenticates (token -> tenant),
admission is weighted-fair across tenants (per-tenant in-flight quotas,
bounded park queues, deficit-round-robin release), and when the fleet's
windowed SLO burn rate (from the same health probes) crosses
``--shedBurnRate`` the router sheds priority >= 1 work with a
``retry_after_ms`` hint before it can queue.  ``--tlsCert/--tlsKey``
secure the front door and the metrics endpoint; ``--tlsCa`` +
``--authToken`` secure and authenticate the replica links.

Metrics: ``ccs_router_routed_total{replica}``,
``ccs_router_failovers_total{replica}``,
``ccs_router_health_checks_total{replica,outcome}``,
``ccs_router_replica_unhealthy_total{replica}``,
``ccs_router_inflight{replica}``, ``ccs_router_dedup_dropped_total``,
``ccs_router_fleet_burn_rate`` (tenant-plane ``ccs_tenant_*`` metrics
live in serve/tenancy.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import queue
import signal
import socket
import sys
import threading
import time
from typing import Any, Callable

from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.obs.metrics import (
    default_registry,
    merge_expositions,
    relabel_exposition,
)
from pbccs_tpu_torch.runtime.logging import Logger, LogLevel
from pbccs_tpu_torch.sched.health import HealthPolicy, HealthTracker, StickyMap
from pbccs_tpu_torch.serve import protocol, tenancy
from pbccs_tpu_torch.serve.server import CcsServer, _FramedSession

_reg = default_registry()
_m_dedup = _reg.counter(
    "ccs_router_dedup_dropped_total",
    "Late duplicate replies dropped after a reply/failover race "
    "(exactly-once emission)")


class RouterClosed(RuntimeError):
    """Router is shutting down (or never started); no new requests."""


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router knobs (see module docstring for the policy they drive)."""

    # ---- health probing ----
    health_interval_s: float = 2.0   # probe cadence per replica
    health_timeout_s: float = 5.0    # unanswered probe = one strike
    bench_after: int = 2             # strikes before a replica is unhealthy
    readmit_after: int = 1           # good probes before re-admission
    connect_timeout_s: float = 5.0   # replica (re)connect bound
    # reconnect attempts to a DOWN replica back off exponentially
    # (base, doubling, capped) instead of re-firing a blocking connect
    # on every health tick against a replica the supervisor knows is
    # mid-restart; a successful connect resets the schedule.  Skipped
    # ticks count ccs_router_reconnect_backoffs_total{replica}.
    reconnect_backoff_base_s: float = 0.5
    reconnect_backoff_cap_s: float = 15.0
    # dynamic membership (fleet verb / supervisor): allow a router that
    # starts with ZERO replicas -- members arrive via add_replica() as
    # the supervisor's children come up -- and allow removing the last
    # member (the supervisor cycles 1-replica fleets through restarts)
    allow_empty: bool = False
    # ---- routing ----
    # a home replica keeps its bucket while its in-flight depth is <=
    # spill_depth; past it the least-loaded healthy replica takes the
    # spill and becomes an additional home (work-conserving stickiness;
    # ~one flush-worth of requests keeps a replica's pipeline fed)
    spill_depth: int = 8
    # ---- wire-protocol armor (enforced by the shared framed session;
    # same semantics as the ServeConfig fields of the same name) ----
    max_line_bytes: int = 8 << 20
    max_inflight_per_session: int = 64
    idle_timeout_s: float = 600.0
    # ---- performance ledger (obs.ledger) ----
    # append fleet-wide NDJSON perf records to this path (--perfLedger):
    # every interval the router records its own snapshot plus one
    # replica_snapshot per reachable replica (that replica's own ledger
    # block when it writes one, else a live-state record from its
    # status reply) -- the fleet-wide ledger merge.  None disables.
    perf_ledger_path: str | None = None
    perf_ledger_interval_s: float = 30.0
    # ---- multi-tenant edge (serve/tenancy.py) ----
    # weighted-fair admission engages when the router front door runs a
    # token file AND fair_queue is on: per-tenant in-flight quotas (from
    # the token file), a bounded per-tenant park queue, DRR drain.  Off
    # (or with no token file) admission is the legacy direct dispatch.
    fair_queue: bool = True
    fair_queue_depth: int = 64     # parked submits per tenant, max
    drr_quantum: int = 4           # DRR credit per round (x tenant weight)
    # SLO-driven shedding: when the fleet burn rate (violations /
    # requests over shed_window_s, from health-probe slo blocks) crosses
    # the threshold, submits from priority >= 1 tenants are rejected
    # `overloaded` with a retry_after_ms hint; priority 0 is NEVER shed.
    # 0 disables shedding.
    shed_burn_threshold: float = 0.0
    shed_window_s: float = 30.0
    retry_after_ms: float = 1000.0  # backoff hint on shed/quota rejects

    def __post_init__(self):
        if self.bench_after < 1:
            raise ValueError("bench_after must be >= 1")
        if self.readmit_after < 1:
            raise ValueError("readmit_after must be >= 1")
        if self.spill_depth < 0:
            raise ValueError("spill_depth must be >= 0")
        # a zero interval busy-spins the health loop; a zero timeout
        # strikes replicas that answer within milliseconds
        if self.health_interval_s <= 0:
            raise ValueError("health_interval_s must be > 0")
        if self.health_timeout_s <= 0:
            raise ValueError("health_timeout_s must be > 0")
        if self.connect_timeout_s <= 0:
            raise ValueError("connect_timeout_s must be > 0")
        if self.reconnect_backoff_base_s <= 0:
            raise ValueError("reconnect_backoff_base_s must be > 0")
        if self.reconnect_backoff_cap_s < self.reconnect_backoff_base_s:
            raise ValueError("reconnect_backoff_cap_s must be >= "
                             "reconnect_backoff_base_s")
        if self.fair_queue_depth < 1:
            raise ValueError("fair_queue_depth must be >= 1")
        if self.drr_quantum < 1:
            raise ValueError("drr_quantum must be >= 1")
        if not 0.0 <= self.shed_burn_threshold <= 1.0:
            raise ValueError("shed_burn_threshold must be in [0, 1] "
                             "(a violation fraction; 0 disables)")
        if self.shed_window_s <= 0:
            raise ValueError("shed_window_s must be > 0")
        if self.retry_after_ms < 0:
            raise ValueError("retry_after_ms must be >= 0")


def parse_replica_spec(spec) -> tuple[str, int]:
    """Normalize one replica spec -- "host:port" (host defaulting to
    loopback) or a (host, port) pair -- raising ValueError with a
    usage-shaped message on garbage (the fleet verb surfaces it as
    bad_request)."""
    if isinstance(spec, str):
        host, _, port_s = spec.rpartition(":")
        try:
            return host or "127.0.0.1", int(port_s)
        except ValueError:
            raise ValueError(
                f"replica spec {spec!r}: want HOST:PORT") from None
    host, port = spec
    return host, int(port)


def route_key(chunk) -> tuple[int, int]:
    """Approximate shape bucket of a ZMW from read-length geometry alone
    (the router never drafts): the median read length stands in for the
    template length the replica's POA will produce.  Affinity only -- a
    mismatch costs a batch at another shape on the routed replica, never
    correctness."""
    from pbccs_tpu_torch.parallel.batch import length_bucket

    lens = sorted(len(r.seq) for r in chunk.reads)
    return length_bucket(lens[len(lens) // 2], lens[-1])


class RoutedRequest:
    """One client submit in flight through the router; emitted exactly
    once (guarded by the router lock via `done`)."""

    __slots__ = ("rid", "key", "wire", "deadline_ms", "emit", "attempted",
                 "assigned", "done", "submit_t", "trace", "tenant")

    def __init__(self, rid: str, key, wire: dict, deadline_ms,
                 emit: Callable[[dict], None],
                 trace: dict | None = None,
                 tenant: str | None = None):
        self.rid = rid
        self.key = key
        self.wire = wire
        self.deadline_ms = deadline_ms
        self.emit = emit
        self.attempted: set[str] = set()   # replica names tried
        self.assigned: str | None = None
        self.done = False
        self.submit_t = time.monotonic()
        # inbound trace context (client-sent or edge-minted): trace_id is
        # NEVER rewritten; the replica hop carries it with span_id
        # rewritten to this request's router span (`rt-<rid>`), exactly
        # as the request id itself is rewritten
        self.trace = trace
        # resolved tenant identity (token-derived at the edge session);
        # forwarded to replicas in the wire `tenant` field and the key
        # the fair queue charges admission against
        self.tenant = tenant

    def span_id(self) -> str:
        """The router-side span id the replica hop parents under."""
        return f"rt-{self.rid}"


class ReplicaLink:
    """One NDJSON/TCP connection from the router to a replica; replies
    stream back through a dedicated reader thread."""

    def __init__(self, router: "CcsRouter", replica: "_Replica",
                 sock: socket.socket):
        self._router = router
        self._replica = replica
        self._sock = sock
        self._wlock = threading.Lock()
        # alive transitions under their own lock: _wlock is held across
        # a blocking sendall (frame atomicity on the replica hop), same
        # discipline as server._FramedSession
        self._slock = threading.Lock()
        self.alive = True
        self.failed = False   # set once by the router's _fail_link sweep
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"ccs-router-link-{replica.name}")

    def start(self) -> None:
        self._reader.start()

    def send(self, msg: dict) -> bool:
        """Best-effort frame to the replica; False marks the link dead
        (the caller runs the failover sweep, never this thread)."""
        token = self._router._link_token
        if token is not None and protocol.FIELD_AUTH not in msg:
            # authenticated replica hop: EVERY router-originated frame
            # (submits, health probes, fleet calls) carries the link
            # token, so a token-guarded replica never strikes its own
            # router's probes as unauthorized
            msg = dict(msg)
            msg[protocol.FIELD_AUTH] = token
        data = protocol.encode_msg(msg)
        try:
            with self._wlock:
                self._sock.sendall(data)
            return True
        except OSError:
            with self._slock:
                self.alive = False
            return False

    def _read_loop(self) -> None:
        try:
            with self._sock.makefile("rb") as rf:
                for line in rf:
                    if not line.strip():
                        continue
                    try:
                        msg = protocol.decode_line(line)
                    except protocol.ProtocolError:
                        continue  # never kill the link on one bad frame
                    self._router._on_replica_msg(self._replica, self, msg)
        except OSError:
            pass  # connection loss; the finally block runs the failover
        finally:
            with self._slock:
                self.alive = False
            self._router._on_link_lost(self._replica, self)

    def close(self) -> None:
        with self._slock:
            self.alive = False
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class _Replica:
    """Router-side bookkeeping for one `ccs serve` backend (mutable
    state guarded by the router lock)."""

    def __init__(self, index: int, host: str, port: int):
        self.index = index
        self.host = host
        self.port = port
        self.name = f"{host}:{port}"
        self.link: ReplicaLink | None = None
        self.connecting = False     # a reconnect attempt is in flight
        self.draining = False       # replica said it stopped accepting
        # reconnect backoff (exponential, capped): no attempt before
        # reconnect_at; a failed attempt doubles reconnect_backoff_s, a
        # successful connect resets both
        self.reconnect_backoff_s = 0.0
        self.reconnect_at = 0.0
        # engine-reported pending work BEYOND this router's own
        # in-flight (other clients / engine backlog), refreshed by each
        # status probe: routing weighs it so an unevenly-loaded fleet
        # spills off the busy replica (0 until the first probe answers)
        self.external_backlog = 0
        self.inflight: dict[str, RoutedRequest] = {}
        self.probe_id: str | None = None
        self.probe_t = 0.0
        self.routed = 0
        self.failovers = 0
        self.m_routed = _reg.counter(
            "ccs_router_routed_total",
            "Requests routed to each replica", replica=self.name)
        self.m_failover = _reg.counter(
            "ccs_router_failovers_total",
            "Unanswered requests resubmitted away from a replica "
            "(connection loss, probe timeout, drain, backpressure)",
            replica=self.name)
        self.m_hc_ok = _reg.counter(
            "ccs_router_health_checks_total",
            "Router health probes by outcome",
            replica=self.name, outcome="ok")
        self.m_hc_fail = _reg.counter(
            "ccs_router_health_checks_total",
            replica=self.name, outcome="fail")
        self.m_unhealthy = _reg.counter(
            "ccs_router_replica_unhealthy_total",
            "Times a replica was marked unhealthy", replica=self.name)
        self.m_inflight = _reg.gauge(
            "ccs_router_inflight",
            "Requests in flight per replica", replica=self.name)
        self.m_reconnect_backoff = _reg.counter(
            "ccs_router_reconnect_backoffs_total",
            "Health ticks that skipped a reconnect attempt while a down "
            "replica's exponential backoff window was open",
            replica=self.name)

    def depth(self) -> int:
        return len(self.inflight)

    def effective_depth(self) -> int:
        """Routing load: the router's own in-flight plus the engine's
        status-reported backlog from elsewhere (admission weighted by
        replica status depth, not in-flight count alone)."""
        return len(self.inflight) + self.external_backlog


class CcsRouter:
    """The replica-fleet scheduler behind the router front door (see
    module docstring).  Engine-shaped for server.CcsServer: exposes
    .config / .status() / .metrics_text(), and the router session calls
    submit_routed()."""

    def __init__(self, replicas, config: RouterConfig | None = None, *,
                 logger: Logger | None = None,
                 tenants: tenancy.TenantDirectory | None = None,
                 link_ssl=None, link_token: str | None = None):
        """`replicas`: "host:port" strings or (host, port) pairs.

        `tenants` (the edge token directory) turns on weighted-fair
        admission and SLO-burn shedding; `link_ssl` (an ssl.SSLContext)
        wraps every replica connection; `link_token` rides every
        router-originated frame so token-guarded replicas accept the
        router's submits and probes."""
        self.config = config or RouterConfig()
        self._log = logger or Logger.default()
        self._tenants = tenants
        self._link_ssl = link_ssl
        self._link_token = link_token
        self._fair = (tenancy.FairQueue(
            tenants, queue_depth=self.config.fair_queue_depth,
            quantum=self.config.drr_quantum)
            if tenants is not None and self.config.fair_queue else None)
        if self._fair is not None and hasattr(tenants, "add_listener"):
            # online token-map reloads: new tenants need admission
            # state before their first submit reaches try_admit
            tenants.add_listener(self._fair.refresh)
        self._burn = tenancy.BurnMeter(self.config.shed_window_s)
        self._shed_total = 0
        # non-reentrant fair-queue pump: the holder of _pump_lock drains
        # until _pump_flag stays clear (a dispatch failing inline frees
        # slots and re-raises the flag; the holder's loop picks it up)
        self._pump_lock = threading.Lock()
        self._pump_flag = threading.Event()
        self._m_burn = _reg.gauge(
            "ccs_router_fleet_burn_rate",
            "Windowed fleet SLO burn rate (violations/requests) from "
            "replica health probes; the shed policy thresholds on it")
        parsed = [parse_replica_spec(spec) for spec in replicas]
        if not parsed and not self.config.allow_empty:
            raise ValueError("CcsRouter needs at least one replica")
        self._replicas = [_Replica(i, h, p)
                          for i, (h, p) in enumerate(parsed)]
        self._by_name = {r.name: r for r in self._replicas}
        # monotone member index: removed slots never recycle an index,
        # so a re-added name gets fresh bookkeeping order
        self._replica_seq = len(self._replicas)
        self._lock = threading.Lock()
        self._sticky = StickyMap()
        self._health = HealthTracker(HealthPolicy(
            bench_after=self.config.bench_after,
            readmit_after=self.config.readmit_after))
        self._requests: dict[str, RoutedRequest] = {}
        self._seq = 0
        self._probe_seq = 0
        # fleet-call plumbing (trace fan-out, metrics federation): ids
        # `fl<N>` on replica links complete these waiters, never the
        # request path
        self._fleet_seq = 0
        self._fleet_waits: dict[str, tuple[threading.Event, list]] = {}
        # router-owned span capture (the `trace` verb); CAS against the
        # process-wide tracer exactly like the engine's
        self._trace_lock = threading.Lock()
        self._capture: obs_trace.Tracer | None = None
        self._accepting = False    # submit gate (drain flips this first)
        self._down = True          # hard stop (failover stops too)
        # fleet supervisor hook (serve/supervisor.py): its status block
        # rides the status verb and fleet restart/readmit delegate to it
        self._supervisor = None
        self._routed_total = 0
        self._completed_total = 0
        self._failover_total = 0
        self._dedup_total = 0
        self._start_t = 0.0
        self._stop = threading.Event()
        self._health_thread: threading.Thread | None = None
        self._emit_queue: queue.Queue | None = None
        self._emit_thread: threading.Thread | None = None
        # fleet-wide performance ledger (config.perf_ledger_path)
        self._ledger = None
        self._ledger_window = None
        self._ledger_thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "CcsRouter":
        with self._lock:
            if self._accepting:
                return self
            self._accepting = True
            self._down = False
        self._start_t = time.monotonic()
        with self._lock:
            initial = list(self._replicas)
        for replica in initial:
            self._try_connect(replica)
        self._stop.clear()
        emit_queue: queue.Queue = queue.Queue()
        emit_thread = threading.Thread(
            target=self._emit_worker, args=(emit_queue,), daemon=True,
            name="ccs-router-emit")
        health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="ccs-router-health")
        with self._lock:
            self._emit_queue = emit_queue
            self._emit_thread = emit_thread
            self._health_thread = health_thread
        emit_thread.start()
        health_thread.start()
        if self.config.perf_ledger_path:
            from pbccs_tpu_torch.obs.ledger import PerfLedger
            from pbccs_tpu_torch.runtime import timing

            ledger = PerfLedger(self.config.perf_ledger_path,
                                logger=self._log)
            ledger_thread = threading.Thread(
                target=self._ledger_loop, args=(ledger,), daemon=True,
                name="ccs-router-ledger")
            with self._lock:
                self._ledger = ledger
                self._ledger_window = timing.window()
                self._ledger_thread = ledger_thread
            ledger_thread.start()
        with self._lock:
            names = [r.name for r in self._replicas]
            up = sum(1 for r in self._replicas if r.link is not None)
        self._log.info(
            f"ccs router up: {len(names)} replica(s) "
            f"[{', '.join(names)}], {up} connected")
        return self

    def close(self, drain: bool = True,
              deadline_s: float | None = None) -> bool:
        """Stop admission; with drain (default) wait for in-flight
        routed requests -- failover keeps working during the drain, so a
        replica dying mid-drain does not strand its requests.  Past
        ``deadline_s`` the remainder fail with a structured `closed`
        error.  Returns True when everything completed normally."""
        with self._lock:
            if self._down and not self._accepting:
                return True
            self._accepting = False
            pending0 = len(self._requests)
        drained = drain or pending0 == 0
        if drain:
            give_up_at = (time.monotonic() + deadline_s
                          if deadline_s else None)
            while True:
                with self._lock:
                    if not self._requests:
                        break
                    pending = len(self._requests)
                if give_up_at is not None and time.monotonic() > give_up_at:
                    drained = False
                    self._log.warn(
                        f"router drain deadline ({deadline_s}s) exceeded "
                        f"with {pending} request(s) pending: aborting")
                    break
                time.sleep(0.01)
        # stop any live capture while the replica links still exist: the
        # trace-stop fan-out must reach the replicas or their globally-
        # installed tracers outlive the router (accumulating spans until
        # max_spans, and refusing the next router's trace start).  The
        # dumps themselves are discarded -- a short bound keeps shutdown
        # from waiting on a sick replica.
        self.trace_stop(timeout_s=2.0)
        self._stop.set()
        with self._lock:
            health_thread = self._health_thread
            self._health_thread = None
        if health_thread is not None:
            health_thread.join(timeout=10.0)
        # fleet ledger: stop the loop, take one FINAL merged snapshot
        # while the replica links still exist (they close just below)
        with self._lock:
            ledger = self._ledger
            ledger_thread = self._ledger_thread
            self._ledger = None
            self._ledger_thread = None
        if ledger_thread is not None:
            ledger_thread.join(timeout=10.0)
        if ledger is not None:
            try:
                self._append_fleet_records(ledger, timeout_s=2.0)
            except Exception as e:  # noqa: BLE001 -- the ledger must
                # never block or break shutdown
                self._log.debug(f"final fleet ledger tick failed: {e!r}")
            ledger.close()
        with self._lock:
            self._down = True
            leftovers = [r for r in self._requests.values() if not r.done]
            for req in leftovers:
                req.done = True
            self._requests.clear()
            links = []
            for replica in self._replicas:
                replica.inflight.clear()
                replica.m_inflight.set(0)
                if replica.link is not None:
                    links.append(replica.link)
                    replica.link = None
        for req in leftovers:
            self._emit(req, protocol.error_to_wire(
                None, protocol.ERR_CLOSED, "router is shutting down"))
        # fair-queue stragglers (parked, never dispatched -- not in
        # _requests): fail them with the same structured closed error
        if self._fair is not None:
            for _tenant, req in self._fair.flush():
                if not req.done:
                    req.done = True
                    self._emit(req, protocol.error_to_wire(
                        None, protocol.ERR_CLOSED,
                        "router is shutting down"))
        for link in links:
            link.close()
        with self._lock:
            emit_queue, self._emit_queue = self._emit_queue, None
            emit_thread, self._emit_thread = self._emit_thread, None
        if emit_queue is not None:
            emit_queue.put(None)   # behind every queued reply
        if emit_thread is not None:
            emit_thread.join(timeout=10.0)
        # unblock any fleet-call waiters (their links are gone)
        with self._lock:
            waits = list(self._fleet_waits.values())
            self._fleet_waits.clear()
        for event, _slot in waits:
            event.set()
        self._log.info("ccs router down")
        return drained

    def __enter__(self) -> "CcsRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------- dynamic membership

    def set_supervisor(self, supervisor) -> None:
        """Install the fleet supervisor (serve/supervisor.py, or None to
        clear): its status_block() rides every status reply under
        FIELD_SUPERVISOR, and the fleet verb's restart/readmit actions
        delegate to it."""
        with self._lock:
            self._supervisor = supervisor

    def get_supervisor(self):
        with self._lock:
            return self._supervisor

    def pending_count(self) -> int:
        """Requests admitted but not yet answered (the autoscaler's
        queue-depth signal; cheaper than a full status())."""
        with self._lock:
            return len(self._requests)

    def replica_names(self) -> list[str]:
        with self._lock:
            return [r.name for r in self._replicas]

    def add_replica(self, spec) -> str:
        """Admit a new member (fleet verb `add` / supervisor respawn).
        The connect is attempted inline (bounded by connect_timeout_s);
        a member that is not up yet simply stays down until a health
        tick reaches it.  Returns the member name; raises ValueError on
        a bad spec or duplicate membership, RouterClosed after close()."""
        host, port = parse_replica_spec(spec)
        name = f"{host}:{port}"
        with self._lock:
            if self._down:
                raise RouterClosed("router is shutting down")
            if name in self._by_name:
                raise ValueError(f"replica {name} is already a member")
            self._replica_seq += 1
            replica = _Replica(self._replica_seq - 1, host, port)
            self._replicas.append(replica)
            self._by_name[name] = replica
        self._try_connect(replica)
        self._log.info(f"router: replica {name} joined the fleet")
        return name

    def remove_replica(self, name: str, drain: bool = True,
                       timeout_s: float = 30.0) -> dict:
        """Retire a member through the proven drain path: routing to it
        stops immediately, its sticky homes migrate, and its in-flight
        requests complete in place (bounded by `timeout_s`) -- anything
        still parked past the deadline (or with drain=False) fails over
        to the rest of the fleet via the shared sweep transaction, so
        removal never loses a request.  Refuses to remove the last
        member unless the router allows an empty fleet (supervised
        mode).  Returns {"replica", "drained", "failed_over"}."""
        with self._lock:
            replica = self._by_name.get(name)
            if replica is None:
                raise ValueError(f"replica {name} is not a member")
            if len(self._replicas) <= 1 and not self.config.allow_empty:
                raise ValueError(
                    "cannot remove the last replica (in-flight work "
                    "would have no failover target)")
            replica.draining = True            # no new routes from here on
            self._sticky.forget_member(name)   # homes migrate now
        drained = True
        if drain:
            deadline = time.monotonic() + max(float(timeout_s), 0.0)
            while True:
                with self._lock:
                    if not replica.inflight:
                        break
                if time.monotonic() > deadline:
                    drained = False
                    break
                time.sleep(0.01)
        with self._lock:
            # the remainder (drain=False, deadline hit, or replies that
            # raced the sweep) moves to the surviving members
            moved = self._sweep_inflight_locked(replica)
            if self._by_name.get(name) is replica:
                del self._by_name[name]
            try:
                self._replicas.remove(replica)
            except ValueError:
                pass
            link, replica.link = replica.link, None
            if link is not None:
                # the close below FINs the reader thread into
                # _on_link_lost; marking the link failed here makes that
                # sweep a no-op (the member is already gone -- a health
                # strike now would haunt a future member of this name)
                link.failed = True
            replica.probe_id = None
            self._health.forget(name)
        for req in moved:
            self._dispatch(req)
        if link is not None:
            link.close()
        self._log.info(
            f"router: replica {name} left the fleet "
            f"({'drained clean' if drained else 'drain deadline hit'}, "
            f"{len(moved)} request(s) failed over)")
        return {"replica": name, "drained": drained,
                "failed_over": len(moved)}

    # ------------------------------------------------------------ submission

    def submit_routed(self, wire_zmw: dict, key, deadline_ms,
                      emit: Callable[[dict], None],
                      trace: dict | None = None,
                      tenant: str | None = None) -> RoutedRequest:
        """Route one validated wire-shaped ZMW; `emit` receives exactly
        one reply dict (result or structured error; the caller rewrites
        the id).  `trace` is the request's validated trace context
        (client-sent, or edge-minted by the session when a capture is
        live); `tenant` the session's resolved identity.  With a token
        directory configured the request passes the shed gate (SLO burn
        x priority class) and the fair queue before routing.  Raises
        RouterClosed after close()."""
        with self._lock:
            if not self._accepting:
                raise RouterClosed("router is not accepting requests")
            self._seq += 1
            rid = f"q{self._seq}"
        req = RoutedRequest(rid, key, wire_zmw, deadline_ms, emit,
                            trace=trace, tenant=tenant)
        fair = self._fair
        if fair is None or tenant is None:
            self._dispatch(req)
            return req
        tenancy.count_request(tenant)
        cfg = self.config
        row = self._tenants.get(tenant)
        # shed gate first: under SLO burn, best-effort classes are
        # rejected BEFORE they can occupy queue slots (priority 0 is
        # never shed -- it rides straight into fair admission)
        # per-tenant SLO target when the token map declares one, else
        # the fleet-wide --shedBurnRate (a latency-tolerant tenant can
        # carry a loose threshold while the fleet sheds at its default)
        threshold = cfg.shed_burn_threshold
        if row is not None and row.shed_burn_rate is not None:
            threshold = row.shed_burn_rate
        burn = self._burn.rate() if threshold > 0 else 0.0
        if (threshold > 0 and row is not None
                and row.priority >= 1
                and burn >= threshold):
            fair.record_shed(tenant)
            with self._lock:
                self._shed_total += 1
            req.done = True
            self._emit(req, protocol.error_to_wire(
                None, protocol.ERR_OVERLOADED,
                f"shedding priority-{row.priority} work: fleet SLO burn "
                f"{burn:.3f} >= {threshold:g}; retry later",
                retry_after_ms=cfg.retry_after_ms))
            return req
        verdict = fair.try_admit(tenant, req)
        if verdict == "dispatch":
            self._dispatch(req)
        elif verdict == "rejected":
            req.done = True
            self._emit(req, protocol.error_to_wire(
                None, protocol.ERR_OVERLOADED,
                f"tenant {tenant!r} over quota with a full fair queue "
                f"({cfg.fair_queue_depth} parked); retry later",
                retry_after_ms=cfg.retry_after_ms))
        # "queued": parked under the tenant's bound; a freed slot
        # releases it through _pump_fair in DRR order
        return req

    def _pump_fair(self) -> None:
        """Dispatch whatever the fair queue releases.  Non-reentrant:
        a dispatch that fails inline completes requests -> frees slots
        -> lands here again; the inner call just raises the flag and the
        active pumper's loop re-drains.  Never called under the router
        lock (dispatch sends block)."""
        fair = self._fair
        if fair is None:
            return
        self._pump_flag.set()
        while self._pump_flag.is_set():
            if not self._pump_lock.acquire(blocking=False):
                return  # the active pumper will observe the flag
            try:
                self._pump_flag.clear()
                for _tenant, req in fair.drain():
                    self._dispatch(req)
            finally:
                self._pump_lock.release()

    def _routable_locked(self, replica: _Replica) -> bool:
        return (replica.link is not None and replica.link.alive
                and not replica.draining
                and self._health.healthy(replica.name))

    def _eligible_locked(self, req: RoutedRequest) -> list[_Replica]:
        return [r for r in self._replicas
                if r.name not in req.attempted and self._routable_locked(r)]

    def _pick_locked(self, req: RoutedRequest) -> _Replica | None:
        eligible = self._eligible_locked(req)
        if not eligible:
            return None

        def load(r: _Replica):
            return (r.effective_depth(),
                    self._sticky.resident_count(r.name), r.index)

        target, _outcome = self._sticky.route(
            req.key, eligible, member_id=lambda r: r.name, load=load,
            depth=lambda r: r.effective_depth(),
            spill_depth=self.config.spill_depth)
        return target

    def _dispatch(self, req: RoutedRequest) -> None:
        """Route + send, retrying across replicas until the frame is on
        a wire or the fleet is exhausted.  Never called under the router
        lock (sends block)."""
        while True:
            with self._lock:
                if req.done:
                    return
                if self._down:
                    fail = protocol.error_to_wire(
                        None, protocol.ERR_CLOSED, "router is shutting down")
                    self._complete_locked(req)
                else:
                    target = self._pick_locked(req)
                    if target is None:
                        code = (protocol.ERR_OVERLOADED
                                if not req.attempted
                                else protocol.ERR_INTERNAL)
                        detail = ("no healthy replica available; retry"
                                  if not req.attempted else
                                  "request failed on every healthy replica "
                                  f"(attempted: {sorted(req.attempted)})")
                        fail = protocol.error_to_wire(None, code, detail)
                        self._complete_locked(req)
                    else:
                        fail = None
                        req.attempted.add(target.name)
                        req.assigned = target.name
                        target.inflight[req.rid] = req
                        target.m_inflight.set(target.depth())
                        self._requests[req.rid] = req
                        self._sticky.note(req.key, target.name)
                        target.routed += 1
                        target.m_routed.inc()
                        self._routed_total += 1
                        link = target.link
            if fail is not None:
                self._emit(req, fail)
                return
            msg: dict[str, Any] = {"verb": protocol.VERB_SUBMIT,
                                   "id": req.rid, "zmw": req.wire}
            if req.deadline_ms is not None:
                msg["deadline_ms"] = req.deadline_ms
            if req.trace is not None:
                # replica hop: same trace_id, span_id rewritten to the
                # router's per-request span (the id-rewrite rule applied
                # to trace context) -- a failover re-dispatch repeats
                # exactly this frame, so the trace follows the request
                msg[protocol.FIELD_TRACE] = {
                    protocol.KEY_TRACE_ID:
                        req.trace[protocol.KEY_TRACE_ID],
                    protocol.KEY_SPAN_ID: req.span_id()}
            if req.tenant is not None:
                # forward the ORIGINAL submitter's identity; the replica
                # honors it because the link token's tenant is trusted
                # (tenancy.resolve_tenant's one exception)
                msg[protocol.FIELD_TENANT] = {
                    protocol.KEY_TENANT_NAME: req.tenant}
            if link.send(msg):
                return
            # the link died under us.  If the request is still parked on
            # this replica, detach it (so the link's failure sweep does
            # not double-dispatch it) and loop to try the next replica;
            # if the sweep got here FIRST the request is already live
            # elsewhere -- touching req.assigned now would orphan the
            # new owner's inflight entry and double-dispatch the request
            with self._lock:
                if req.done:
                    return
                if target.inflight.get(req.rid) is req:
                    del target.inflight[req.rid]
                    target.m_inflight.set(target.depth())
                    req.assigned = None
                    target.failovers += 1
                    target.m_failover.inc()
                    self._failover_total += 1
                    mine = True
                else:
                    mine = False
            self._fail_link(target, link, "send failed")
            if not mine:
                return

    def _record_request_span(self, req: RoutedRequest, msg: dict) -> None:
        """Retroactive per-request router span (recorded at emission:
        the one point every request passes exactly once).  Its exported
        span_id is the `rt-<rid>` the replica hop already named as its
        remote parent, so the merged fleet trace connects client ->
        router -> replica under one trace_id."""
        tracer = obs_trace.get_tracer()
        if tracer is None:
            return
        tracer.add_span(
            "router.request", time.monotonic() - req.submit_t,
            ctx=req.trace, span_id=req.span_id(),
            replica=req.assigned,
            attempts=len(req.attempted),
            outcome=msg.get("type"))

    def _emit(self, req: RoutedRequest, msg: dict) -> None:
        """Hand a completed reply to the dedicated emission thread.
        Emit callbacks write to CLIENT sockets (blocking, bounded only
        by the session armor); run on a replica link's reader thread
        they would starve that link's health-probe replies behind one
        slow client and falsely bench a healthy replica -- the same
        hand-off the serve engine does for batch completions."""
        self._record_request_span(req, msg)
        with self._lock:
            q = self._emit_queue
        if q is not None:
            q.put((req, msg))
            self._pump_fair()   # a completion may have freed a slot
            return
        # router already torn down (or never started): emit inline,
        # best-effort -- there is no reader thread left to protect
        try:
            req.emit(msg)
        except Exception as e:  # noqa: BLE001 -- a dead client must not
            # leak out of the teardown path
            self._log.debug(f"router reply emit failed: {e!r}")
        self._pump_fair()

    def _emit_worker(self, q: queue.Queue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            req, msg = item
            try:
                req.emit(msg)
            except Exception as e:  # noqa: BLE001 -- one dead client
                # must never take the emission worker down
                self._log.debug(f"router reply emit failed: {e!r}")

    def _complete_locked(self, req: RoutedRequest) -> None:
        """Retire a request (caller emits OUTSIDE the lock)."""
        req.done = True
        self._requests.pop(req.rid, None)
        if req.assigned is not None:
            # .get: the owner may have left the fleet (remove_replica)
            # between assignment and this completion
            owner = self._by_name.get(req.assigned)
            if owner is not None \
                    and owner.inflight.pop(req.rid, None) is not None:
                owner.m_inflight.set(owner.depth())
        if req.tenant is not None and self._fair is not None:
            # free the tenant's admission slot (FairQueue has its own
            # lock and never calls back -- safe under the router lock);
            # the emit that follows this completion runs _pump_fair, so
            # the freed slot releases parked work promptly
            self._fair.complete(req.tenant)
        self._completed_total += 1

    # ----------------------------------------------------------- replica IO

    def _on_replica_msg(self, replica: _Replica, link: ReplicaLink,
                        msg: dict) -> None:
        mtype = msg.get("type")
        if mtype == protocol.TYPE_CLOSED:
            # unsolicited drain/idle notice: stop routing there, keep
            # waiting on in-flight replies (they land before the replica
            # closes the socket; a close without them is a link loss and
            # the failover sweep picks them up)
            with self._lock:
                replica.draining = True
            self._log.info(f"router: replica {replica.name} announced "
                           f"close ({msg.get('reason')})")
            return
        rid = msg.get("id")
        if isinstance(rid, str) and rid.startswith("hc"):
            self._on_probe_reply(replica, msg)
            return
        if isinstance(rid, str) and rid.startswith("fl"):
            # fleet-call reply (trace fan-out / metrics federation):
            # complete the waiter, never the request path
            with self._lock:
                waiter = self._fleet_waits.pop(rid, None)
            if waiter is not None:
                event, slot = waiter
                slot.append(msg)
                event.set()
            return
        resubmit = None
        with self._lock:
            req = self._requests.get(rid)
            if req is None or req.done:
                # reply/failover race resolved in the other reply's
                # favor (or a stale id): drop, exactly-once held
                self._dedup_total += 1
                _m_dedup.inc()
                return
            retryable = (mtype == protocol.TYPE_ERROR
                         and msg.get("code") in (protocol.ERR_OVERLOADED,
                                                 protocol.ERR_CLOSED))
            if retryable and msg.get("code") == protocol.ERR_CLOSED:
                replica.draining = True
            owns = replica.inflight.get(rid) is req
            if not owns and mtype == protocol.TYPE_ERROR:
                # a STALE error from a replica this request already
                # failed over from (probe-timeout sweep detached it):
                # the current owner will answer; completing or
                # re-routing on it would emit a spurious error for a
                # request another replica is serving, or clobber that
                # replica's ownership (the same still-parked rule
                # _dispatch's send-failure path applies).  A stale
                # RESULT, by contrast, is a valid answer and wins the
                # race below.
                self._dedup_total += 1
                _m_dedup.inc()
                return
            if owns and retryable and self._eligible_locked(req):
                # replica-side backpressure/drain: move the request to a
                # replica that can absorb it instead of surfacing an
                # error the rest of the fleet could have served
                del replica.inflight[rid]
                replica.m_inflight.set(replica.depth())
                req.assigned = None
                replica.failovers += 1
                replica.m_failover.inc()
                self._failover_total += 1
                resubmit = req
            else:
                self._complete_locked(req)
        if resubmit is not None:
            self._dispatch(resubmit)
        else:
            self._emit(req, msg)

    def _on_link_lost(self, replica: _Replica, link: ReplicaLink) -> None:
        with self._lock:
            if self._down:
                return
        self._fail_link(replica, link, "connection lost")

    def _sweep_inflight_locked(self,
                               replica: _Replica) -> list[RoutedRequest]:
        """Detach every not-yet-done in-flight request from `replica`,
        counting the failovers.  Caller holds the router lock and
        re-dispatches the returned requests AFTER releasing it (the one
        move-a-replica's-work transaction, shared by the link-failure
        and probe-timeout-bench paths)."""
        moved = [r for r in replica.inflight.values() if not r.done]
        replica.inflight.clear()
        replica.m_inflight.set(0)
        for req in moved:
            req.assigned = None
        if moved:
            replica.failovers += len(moved)
            replica.m_failover.inc(len(moved))
            # caller holds self._lock (the _locked-suffix contract)
            # ccs-analyze: ignore[CONC001]
            self._failover_total += len(moved)
        return moved

    def _fail_link(self, replica: _Replica, link: ReplicaLink,
                   why: str) -> None:
        """One dead link: detach it, strike the replica's health, and
        re-dispatch its unanswered requests elsewhere.  Idempotent per
        link object (send failures and the reader's EOF both land
        here)."""
        with self._lock:
            if link.failed:
                return
            link.failed = True
            if replica.link is link:
                replica.link = None
            moved = self._sweep_inflight_locked(replica)
            replica.probe_id = None
            replica.external_backlog = 0   # stale once the link is gone
            benched = self._health.record_failure(replica.name)
            if benched:
                replica.m_unhealthy.inc()
                self._sticky.forget_member(replica.name)
        self._log.warn(
            f"router: replica {replica.name} link down ({why}); "
            f"failing over {len(moved)} in-flight request(s)")
        link.close()
        for req in moved:
            self._dispatch(req)

    # --------------------------------------------------------------- health

    def _try_connect(self, replica: _Replica) -> bool:
        """One blocking connect attempt; False ONLY on a refused/failed
        connect (the signal the reconnect backoff doubles on) -- a stale
        attempt (already connected, shut down, or the member left the
        fleet) is not a failure."""
        try:
            sock = socket.create_connection(
                (replica.host, replica.port),
                timeout=self.config.connect_timeout_s)
        except OSError:
            return False  # stays down; the next due tick retries
        if self._link_ssl is not None:
            # TLS replica hop: handshake under the same connect bound; a
            # failed handshake (plaintext replica, cert the CA rejects)
            # is a failed connect -- backoff doubles, no traceback
            try:
                sock = self._link_ssl.wrap_socket(
                    sock, server_hostname=replica.host)
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                return False
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        link = ReplicaLink(self, replica, sock)
        with self._lock:
            if self._down or replica.link is not None \
                    or self._by_name.get(replica.name) is not replica:
                stale = True
            else:
                stale = False
                replica.link = link
                # a fresh connection says nothing about engine health; a
                # reconnect after drain must also clear the drain flag so
                # the next probe can re-admit a restarted replica (and a
                # restarted replica's backlog figure starts clean)
                replica.draining = False
                replica.probe_id = None
                replica.external_backlog = 0
        if stale:
            link.close()
            return True
        link.start()
        self._log.info(f"router: connected to replica {replica.name}")
        return True

    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.health_interval_s):
            # snapshot under the lock: membership changes mid-tick
            # (fleet add/remove) must not race this iteration
            with self._lock:
                replicas = list(self._replicas)
            for replica in replicas:
                self._probe(replica)

    def _probe(self, replica: _Replica) -> None:
        now = time.monotonic()
        with self._lock:
            if self._down:
                return
            link = replica.link
            outstanding = replica.probe_id
            sent_t = replica.probe_t
        if link is None or not link.alive:
            # reconnect OFF the health thread: a blocking connect() to a
            # down replica (up to connect_timeout_s) would stretch the
            # probe cadence for every HEALTHY replica behind it
            with self._lock:
                if replica.connecting or self._down \
                        or self._by_name.get(replica.name) is not replica:
                    return  # busy, shutting down, or left the fleet
                if now < replica.reconnect_at:
                    # exponential backoff window still open: count the
                    # skipped attempt, don't hammer a dead port
                    replica.m_reconnect_backoff.inc()
                    return
                replica.connecting = True

            def attempt(replica=replica):
                ok = False
                try:
                    ok = self._try_connect(replica)
                finally:
                    with self._lock:
                        replica.connecting = False
                        if ok:
                            replica.reconnect_backoff_s = 0.0
                            replica.reconnect_at = 0.0
                        else:
                            base = self.config.reconnect_backoff_base_s
                            replica.reconnect_backoff_s = min(
                                self.config.reconnect_backoff_cap_s,
                                max(base, replica.reconnect_backoff_s * 2))
                            replica.reconnect_at = (
                                time.monotonic()
                                + replica.reconnect_backoff_s)

            threading.Thread(
                target=attempt, daemon=True,
                name=f"ccs-router-connect-{replica.name}").start()
            return
        if outstanding is not None:
            if now - sent_t < self.config.health_timeout_s:
                return  # still within the reply window
            # unanswered probe: one strike; benching moves the in-flight
            # requests but KEEPS the link open, so a late reply still
            # wins the exactly-once race instead of being torn down
            moved: list[RoutedRequest] = []
            with self._lock:
                replica.probe_id = None
                benched = self._health.record_failure(replica.name)
                if benched:
                    replica.m_unhealthy.inc()
                    self._sticky.forget_member(replica.name)
                    moved = self._sweep_inflight_locked(replica)
            replica.m_hc_fail.inc()
            if benched:
                self._log.warn(
                    f"router: replica {replica.name} unhealthy (probe "
                    f"timeout); failing over {len(moved)} request(s)")
            for req in moved:
                self._dispatch(req)
            return
        self._probe_seq += 1
        pid = f"hc{self._probe_seq}"
        with self._lock:
            replica.probe_id = pid
            replica.probe_t = now
        if not link.send({"verb": protocol.VERB_STATUS, "id": pid}):
            self._fail_link(replica, link, "health probe send failed")

    def _on_probe_reply(self, replica: _Replica, msg: dict) -> None:
        if msg.get("type") == protocol.TYPE_ERROR:
            # a replica ANSWERING probes with structured errors (e.g.
            # rejecting the router's link token as unauthorized) is not
            # healthy: strike it like a timeout, with the reason logged
            # -- a token misconfiguration must surface, not read as ok
            moved: list[RoutedRequest] = []
            with self._lock:
                if msg.get("id") != replica.probe_id:
                    return
                replica.probe_id = None
                benched = self._health.record_failure(replica.name)
                if benched:
                    replica.m_unhealthy.inc()
                    self._sticky.forget_member(replica.name)
                    moved = self._sweep_inflight_locked(replica)
            replica.m_hc_fail.inc()
            self._log.warn(
                f"router: replica {replica.name} rejected a health probe "
                f"({msg.get('code')}: {msg.get('message')})")
            for req in moved:
                self._dispatch(req)
            return
        # SLO burn signal: every probe reply's `slo` block (lifetime
        # requests/violations) feeds the shed policy's windowed meter
        self._burn.observe(replica.name, msg.get("slo"))
        self._m_burn.set(round(self._burn.rate(), 6))
        accepting = bool(msg.get("accepting", True))
        try:
            pending = max(0, int(msg.get("pending", 0)))
        except (TypeError, ValueError):
            pending = 0
        with self._lock:
            if msg.get("id") != replica.probe_id:
                # a STALE probe reply (its timeout already struck, or it
                # belongs to a previous link): crediting it would reset
                # the strike count of a replica that persistently
                # answers slower than health_timeout_s, and count toward
                # re-admission of a benched one -- only the outstanding
                # probe's reply is evidence of current health
                return
            replica.probe_id = None
            replica.draining = not accepting
            # admission weighting: the engine's pending figure minus
            # what WE have in flight there is load other clients (or an
            # engine backlog) put on it; fold it into routing depth
            replica.external_backlog = max(0, pending - replica.depth())
            recovered = self._health.record_success(replica.name)
        replica.m_hc_ok.inc()
        if recovered:
            self._log.info(f"router: replica {replica.name} recovered; "
                           "re-admitted to routing")

    # ------------------------------------------------------- fleet calls

    def _fleet_call(self, frame: dict, timeout_s: float = 5.0
                    ) -> dict[str, dict]:
        """Send one verb frame to every CONNECTED replica and collect
        the replies: {replica_name: reply}.  Replies use `fl<N>` ids so
        the link reader routes them to waiters, never the request path;
        a replica that cannot answer within the timeout (or whose link
        died) is simply absent from the result -- fleet introspection
        must degrade, not block behind a sick replica forever."""
        waiters: list[tuple[str, _Replica, threading.Event, list]] = []
        with self._lock:
            targets = [(r, r.link) for r in self._replicas
                       if r.link is not None and r.link.alive]
        for replica, link in targets:
            with self._lock:
                self._fleet_seq += 1
                fid = f"fl{self._fleet_seq}"
                event: threading.Event = threading.Event()
                slot: list = []
                self._fleet_waits[fid] = (event, slot)
            if not link.send(dict(frame, id=fid)):
                with self._lock:
                    self._fleet_waits.pop(fid, None)
                continue
            waiters.append((fid, replica, event, slot))
        out: dict[str, dict] = {}
        deadline = time.monotonic() + timeout_s
        for _fid, replica, event, slot in waiters:
            if event.wait(max(deadline - time.monotonic(), 0.0)) and slot:
                out[replica.name] = slot[0]
        # drop THIS call's straggler waiters so the map cannot grow
        # unbounded (concurrent fleet calls -- an HTTP scrape racing a
        # trace stop -- own their fids; never touch theirs)
        with self._lock:
            for fid, _replica, event, _slot in waiters:
                if not event.is_set():
                    self._fleet_waits.pop(fid, None)
        return out

    # ------------------------------------------------------ trace fan-out

    def trace_start(self) -> bool:
        """Install a router-side span capture AND fan a trace-start out
        to every connected replica (the protocol's `trace` verb at the
        router tier).  Returns False when a capture is already live."""
        with self._trace_lock:
            if self._capture is not None:
                return False
            cap = obs_trace.Tracer(tag="router")
            if not obs_trace.install_tracer(cap):
                return False
            self._capture = cap
        self._fleet_call({"verb": protocol.VERB_TRACE, "action": "start"},
                         timeout_s=5.0)
        return True

    def trace_stop(self, timeout_s: float = 10.0) -> dict | None:
        """Stop the capture: collect each replica's span dump (trace
        verb, action=stop), stop the router's own, and return
        {"trace": <router chrome>, "replicas": {name: chrome}} -- the
        inputs tools/trace_merge.py assembles into one fleet timeline.
        None when no capture was running."""
        with self._trace_lock:
            cap, self._capture = self._capture, None
            if cap is None:
                return None
            obs_trace.clear_tracer(cap)
        replies = self._fleet_call(
            {"verb": protocol.VERB_TRACE, "action": "stop"},
            timeout_s=timeout_s)
        replicas = {name: msg["trace"] for name, msg in replies.items()
                    if isinstance(msg.get("trace"), dict)}
        return {"trace": cap.to_chrome(), "replicas": replicas}

    # --------------------------------------------- fleet perf ledger

    def _ledger_loop(self, ledger) -> None:
        interval = max(self.config.perf_ledger_interval_s, 0.1)
        while not self._stop.wait(interval):
            try:
                self._append_fleet_records(ledger)
            except Exception as e:  # noqa: BLE001 -- observability must
                # degrade, never take the router down
                self._log.debug(f"fleet ledger tick failed: {e!r}")

    def _append_fleet_records(self, ledger, timeout_s: float = 5.0) -> None:
        """One fleet ledger tick: the router's own snapshot plus one
        replica_snapshot per reachable replica.  A replica that writes
        its own ledger contributes its newest record (the status verb's
        `perf` block); one that does not contributes a live-state record
        from its status reply.  Unreachable replicas are absent."""
        from pbccs_tpu_torch.obs import ledger as obs_ledger

        with self._lock:
            window = self._ledger_window
            pending = len(self._requests)
            completed = self._completed_total
        if window is not None:
            ledger.append(obs_ledger.run_record(
                window, kind="router_snapshot", source="ccs-router",
                extra={
                    "uptime_s": round(time.monotonic() - self._start_t, 3),
                    "pending": pending,
                    "completed": completed,
                }))
        replies = self._fleet_call({"verb": protocol.VERB_STATUS},
                                   timeout_s=timeout_s)
        for name, msg in sorted(replies.items()):
            perf = msg.get(protocol.FIELD_PERF)
            last = (perf or {}).get(protocol.KEY_PERF_LAST) \
                if isinstance(perf, dict) else None
            if isinstance(last, dict):
                rec = {k: v for k, v in last.items()
                       if k in obs_ledger.LEDGER_FIELDS
                       and k not in ("schema_version", "t_unix")}
            else:
                rec = {}
            rec.update(kind="replica_snapshot", source="ccs-router",
                       replica=name)
            for wire_key, field in (("pending", "pending"),
                                    ("completed", "completed"),
                                    ("errors", "errors"),
                                    ("in_flight_zmws", "in_flight_zmws"),
                                    ("uptime_s", "uptime_s"),
                                    ("queue_depth", "queue_depth")):
                v = msg.get(wire_key)
                if isinstance(v, (int, float)):
                    rec[field] = v
            ledger.append(rec)
        if self._fair is not None:
            # one tenant_snapshot per tenant per tick: the per-tenant
            # ledger plane the perf tooling reads
            for row in self._fair.rows():
                ledger.append({
                    "kind": "tenant_snapshot", "source": "ccs-router",
                    "tenant": row["name"],
                    "tenant_priority": row["priority"],
                    "tenant_inflight": row["inflight"],
                    "tenant_queued": row["queued"],
                    "tenant_completed": row["completed"],
                    "tenant_sheds": row["shed"],
                    "tenant_rejects": row["rejected"],
                })

    # ------------------------------------------- status / metrics (session)

    def accepting(self) -> bool:
        """Cheap liveness for /healthz: False once a drain began."""
        with self._lock:
            return self._accepting

    def status(self) -> dict:
        with self._lock:
            replicas = [{
                "replica": r.name,
                "connected": r.link is not None and r.link.alive,
                "healthy": self._health.healthy(r.name),
                "draining": r.draining,
                "inflight": r.depth(),
                "external_backlog": r.external_backlog,
                "routed": r.routed,
                "failovers": r.failovers,
            } for r in self._replicas]
            ledger = self._ledger
            supervisor = self._supervisor
            perf = {protocol.FIELD_PERF: ledger.perf_block()} \
                if ledger is not None else {}
            out = {
                "engine": "ccs-router",
                **perf,
                "accepting": self._accepting,
                "uptime_s": round(time.monotonic() - self._start_t, 3),
                "pending": len(self._requests),
                "routed": self._routed_total,
                "completed": self._completed_total,
                "failovers": self._failover_total,
                "deduped": self._dedup_total,
                "shed": self._shed_total,
                "replicas": replicas,
            }
        if supervisor is not None:
            # OUTSIDE the router lock: supervisor threads call
            # add_replica/remove_replica (which take the router lock)
            # while holding their own -- nesting the other way here
            # would be a lock-order inversion
            out[protocol.FIELD_SUPERVISOR] = supervisor.status_block()
        if self._fair is not None:
            # per-tenant accounting (FairQueue's own lock; outside the
            # router lock): `ccs top` renders this block verbatim
            burn = self._burn.rate()
            out[protocol.FIELD_TENANCY] = {
                protocol.KEY_TEN_TENANTS: self._fair.rows(),
                protocol.KEY_TEN_BURN: round(burn, 6),
                protocol.KEY_TEN_SHEDDING: bool(
                    self.config.shed_burn_threshold > 0
                    and burn >= self.config.shed_burn_threshold),
            }
        return out

    def metrics_text(self) -> str:
        """FEDERATED fleet exposition: the router's own registry plus
        every reachable replica's `metrics` verb body relabeled under
        `replica="host:port"`, merged into one valid exposition -- a
        single Prometheus target (the router's --metricsPort, or its
        NDJSON metrics verb) sees the whole fleet.  Unreachable replicas
        degrade to absence, never to a blocked scrape."""
        parts = [_reg.render_prometheus()]
        replies = self._fleet_call({"verb": protocol.VERB_METRICS},
                                   timeout_s=5.0)
        for name, msg in sorted(replies.items()):
            body = msg.get("body")
            if isinstance(body, str) and body:
                parts.append(relabel_exposition(body, replica=name))
        return merge_expositions(parts)


class _RouterSession(_FramedSession):
    """A framed session bound to the replica router: submits are
    validated at the edge, then fanned out; replica replies pass through
    verbatim with the id rewritten back to the client's."""

    def _on_submit(self, msg: dict) -> None:
        rid = msg.get("id")
        if not self._try_acquire_slot(rid):
            return
        parsed = self._parse_submit(msg)
        if parsed is None:
            self._release_slot()
            return
        chunk, deadline_ms, trace_ctx, tenant = parsed
        directory = self.server.tenants
        if directory is not None and tenant is not None \
                and directory.get(tenant) is None:
            # a trusted peer forwarded an identity the token file does
            # not know: refuse rather than route unaccounted work (the
            # fair queue has no state for it)
            self._release_slot()
            tenancy.count_auth_failure("unknown_tenant")
            self.send(protocol.error_to_wire(
                rid, protocol.ERR_UNAUTHORIZED,
                f"unknown tenant {tenant!r}"))
            return
        if trace_ctx is None and obs_trace.get_tracer() is not None:
            # edge-minted trace id: with a capture live, every request
            # gets a fleet-wide identity even when the client sent none
            trace_ctx = {protocol.KEY_TRACE_ID: obs_trace.new_trace_id(),
                         protocol.KEY_SPAN_ID: None}

        def on_reply(reply: dict) -> None:
            self._release_slot()
            out = dict(reply)
            out["id"] = rid
            self.send(out)

        try:
            # forward the NORMALIZED wire form (defaults filled, floats
            # coerced): both hops then carry the exact payload the
            # validation accepted
            self.server.engine.submit_routed(
                protocol.chunk_to_wire(chunk), route_key(chunk),
                deadline_ms, on_reply, trace=trace_ctx, tenant=tenant)
        except RouterClosed as e:
            self._release_slot()
            self.send(protocol.error_to_wire(rid, protocol.ERR_CLOSED,
                                             str(e)))

    def _on_trace(self, msg: dict) -> None:
        """Router-tier trace verb: start/stop fan out to the replica
        fleet; stop returns the router's own capture plus each
        replica's under `replicas` (tools/trace_merge.py merges them)."""
        rid = msg.get("id")
        action = msg.get("action")
        if action == "start":
            started = self.server.engine.trace_start()
            self.send({"type": protocol.TYPE_TRACE, "id": rid,
                       "state": "started" if started
                       else "already_running"})
        elif action == "stop":
            bundle = self.server.engine.trace_stop()
            reply = {"type": protocol.TYPE_TRACE, "id": rid,
                     "state": "stopped" if bundle is not None
                     else "not_running"}
            if bundle is not None:
                reply["trace"] = bundle["trace"]
                reply["replicas"] = bundle["replicas"]
            self.send(reply)
        else:
            self.send(protocol.error_to_wire(
                rid, protocol.ERR_BAD_REQUEST,
                'trace.action must be "start" or "stop"'))

    def _on_fleet(self, msg: dict) -> None:
        self.send(self._fleet_reply(msg))

    def _fleet_reply(self, msg: dict) -> dict:
        """Compute (never send) the reply to a fleet admin verb --
        membership surgery on the live router: list / add / remove run
        directly against the routing table; restart / readmit need the
        supervising control plane (`ccs fleet`) and are refused on an
        unsupervised router."""
        rid = msg.get("id")
        action = msg.get("action")
        router: CcsRouter = self.server.engine
        if action == "list":
            status = router.status()
            reply = {"type": protocol.TYPE_FLEET, "id": rid,
                     "action": action, "ok": True,
                     "replicas": status["replicas"]}
            if protocol.FIELD_SUPERVISOR in status:
                reply[protocol.FIELD_SUPERVISOR] = \
                    status[protocol.FIELD_SUPERVISOR]
            return reply
        if action == "add":
            spec = msg.get("replica")
            if not isinstance(spec, str):
                return protocol.error_to_wire(
                    rid, protocol.ERR_BAD_REQUEST,
                    "fleet.add needs a replica HOST:PORT string")
            try:
                name = router.add_replica(spec)
            except RouterClosed as e:
                return protocol.error_to_wire(
                    rid, protocol.ERR_CLOSED, str(e))
            except ValueError as e:
                return protocol.error_to_wire(
                    rid, protocol.ERR_BAD_REQUEST, str(e))
            return {"type": protocol.TYPE_FLEET, "id": rid,
                    "action": action, "ok": True, "replica": name}
        if action == "remove":
            spec = msg.get("replica")
            if not isinstance(spec, str):
                return protocol.error_to_wire(
                    rid, protocol.ERR_BAD_REQUEST,
                    "fleet.remove needs a replica HOST:PORT string")
            timeout_s = msg.get("timeout_s", 30.0)
            if not isinstance(timeout_s, (int, float)) \
                    or isinstance(timeout_s, bool):
                return protocol.error_to_wire(
                    rid, protocol.ERR_BAD_REQUEST,
                    "fleet.timeout_s must be a number")
            try:
                out = router.remove_replica(
                    spec, drain=bool(msg.get("drain", True)),
                    timeout_s=float(timeout_s))
            except ValueError as e:
                return protocol.error_to_wire(
                    rid, protocol.ERR_BAD_REQUEST, str(e))
            return {"type": protocol.TYPE_FLEET, "id": rid,
                    "action": action, "ok": True, **out}
        if action in ("restart", "readmit"):
            supervisor = router.get_supervisor()
            if supervisor is None:
                return protocol.error_to_wire(
                    rid, protocol.ERR_BAD_REQUEST,
                    f"fleet.{action} needs a fleet supervisor "
                    "(`ccs fleet`); this router is unsupervised")
            if action == "restart":
                started = supervisor.request_rolling_restart()
                return {"type": protocol.TYPE_FLEET, "id": rid,
                        "action": action, "ok": True,
                        "state": "started" if started
                        else "already_running"}
            slot = msg.get("slot")
            if not isinstance(slot, int) or isinstance(slot, bool):
                return protocol.error_to_wire(
                    rid, protocol.ERR_BAD_REQUEST,
                    "fleet.readmit needs an integer slot")
            try:
                supervisor.readmit(slot)
            except ValueError as e:
                return protocol.error_to_wire(
                    rid, protocol.ERR_BAD_REQUEST, str(e))
            return {"type": protocol.TYPE_FLEET, "id": rid,
                    "action": action, "ok": True, "slot": slot}
        return protocol.error_to_wire(
            rid, protocol.ERR_BAD_REQUEST,
            'fleet.action must be "list", "add", "remove", '
            '"restart" or "readmit"')


class RouterServer(CcsServer):
    """The router's TCP front: the serve accept loop + session armor
    over a CcsRouter instead of a local engine."""

    session_class = _RouterSession
    name = "ccs router"


# ------------------------------------------------------------------ ccs router

def build_router_parser() -> argparse.ArgumentParser:
    defaults = RouterConfig()
    p = argparse.ArgumentParser(
        prog="ccs router",
        description="Health-checked front door spreading CCS serve "
                    "sessions across N `ccs serve` replicas with sticky "
                    "bucket routing and zero-loss failover.")
    p.add_argument("--host", default="127.0.0.1",
                   help="Bind address. Default = %(default)s")
    p.add_argument("--port", type=int, default=7330,
                   help="Bind port (0 = ephemeral). Default = %(default)s")
    p.add_argument("--replica", action="append", required=True,
                   metavar="HOST:PORT",
                   help="One `ccs serve` backend (repeatable).")
    p.add_argument("--routerHealthInterval", type=float,
                   default=defaults.health_interval_s,
                   help="Seconds between status-verb health probes per "
                        "replica. Default = %(default)s")
    p.add_argument("--routerHealthTimeout", type=float,
                   default=defaults.health_timeout_s,
                   help="Probe unanswered this long = one strike. "
                        "Default = %(default)s")
    p.add_argument("--routerBenchAfter", type=int,
                   default=defaults.bench_after,
                   help="Consecutive strikes before a replica is marked "
                        "unhealthy (in-flight requests fail over). "
                        "Default = %(default)s")
    p.add_argument("--routerReadmitAfter", type=int,
                   default=defaults.readmit_after,
                   help="Consecutive good probes before an unhealthy "
                        "replica is re-admitted. Default = %(default)s")
    p.add_argument("--routerSpillDepth", type=int, default=None,
                   help="In-flight depth past which a sticky bucket "
                        "spills off its home replica. Default: the "
                        "applied --tuneProfile's router_spill_depth, "
                        f"else {defaults.spill_depth}")
    p.add_argument("--tuneProfile", default=None, metavar="PATH|auto",
                   help="ccs-tune host profile (runtime/tuning.py): "
                        "supplies a --routerSpillDepth default when the "
                        "explicit flag is absent.  'auto' scans the "
                        "profiles/ directory for a fingerprint match; "
                        "failures degrade to built-in defaults with a "
                        "logged note.  Default: PBCCS_TUNE_PROFILE, "
                        "else no profile.")
    # the same wire armor the replicas enforce, applied at the edge
    p.add_argument("--maxLineBytes", type=int,
                   default=defaults.max_line_bytes,
                   help="Longest accepted NDJSON frame. "
                        "Default = %(default)s")
    p.add_argument("--maxInflightPerSession", type=int,
                   default=defaults.max_inflight_per_session,
                   help="Per-session in-flight submit cap. "
                        "Default = %(default)s")
    p.add_argument("--idleTimeout", type=float,
                   default=defaults.idle_timeout_s,
                   help="Reap idle sessions after this many seconds; "
                        "0 disables. Default = %(default)s")
    p.add_argument("--drainTimeout", type=float, default=30.0,
                   help="On SIGTERM/SIGINT, wait this long for routed "
                        "in-flight requests before failing the rest. "
                        "Default = %(default)s")
    p.add_argument("--metricsPort", type=int, default=0,
                   help="Serve the FEDERATED fleet exposition (router + "
                        "every replica under a replica label) on a "
                        "stdlib-HTTP /metrics endpoint (-1 = ephemeral, "
                        "printed as CCS-METRICS-READY; 0 disables). "
                        "Default = %(default)s")
    p.add_argument("--perfLedger", default=None, metavar="PATH",
                   help="Append the FLEET-WIDE performance ledger to "
                        "PATH: per interval, the router's own snapshot "
                        "plus one replica_snapshot per reachable "
                        "replica (its own ledger record when it runs "
                        "--perfLedger, else its live status figures). "
                        "Default: off.")
    p.add_argument("--perfLedgerInterval", type=float,
                   default=defaults.perf_ledger_interval_s,
                   help="Seconds between fleet ledger ticks. "
                        "Default = %(default)s")
    # ---- multi-tenant edge (serve/tenancy.py) ----
    p.add_argument("--tlsCert", default=None, metavar="PEM",
                   help="TLS certificate chain for the front door AND "
                        "the metrics endpoint (with --tlsKey). "
                        "Default: plaintext.")
    p.add_argument("--tlsKey", default=None, metavar="PEM",
                   help="TLS private key (with --tlsCert).")
    p.add_argument("--authTokens", default=None, metavar="FILE",
                   help="JSON token->tenant map; turns on edge token "
                        "auth, per-tenant fair queuing, and SLO-burn "
                        "shedding. Default: open front door.")
    p.add_argument("--tlsCa", default=None, metavar="PEM",
                   help="CA bundle to verify REPLICA certificates; also "
                        "switches replica links to TLS. Default: "
                        "plaintext links.")
    p.add_argument("--tlsReplicas", action="store_true",
                   help="Wrap replica links in TLS without CA pinning "
                        "(encrypted, unauthenticated; prefer --tlsCa).")
    p.add_argument("--authToken", default=None, metavar="TOKEN",
                   help="Bearer token the router presents on every "
                        "replica-link frame (submits, health probes, "
                        "fleet calls) to token-guarded replicas.")
    p.add_argument("--shedBurnRate", type=float,
                   default=defaults.shed_burn_threshold,
                   help="Fleet SLO burn rate (violating fraction over "
                        "--shedWindow) past which priority >= 1 tenants "
                        "are shed with a retry hint; 0 disables. "
                        "Default = %(default)s")
    p.add_argument("--shedWindow", type=float,
                   default=defaults.shed_window_s,
                   help="Burn-rate sliding window, seconds. "
                        "Default = %(default)s")
    p.add_argument("--shedRetryMs", type=float,
                   default=defaults.retry_after_ms,
                   help="retry_after_ms hint on shed/quota rejections. "
                        "Default = %(default)s")
    p.add_argument("--tenantQueueDepth", type=int,
                   default=defaults.fair_queue_depth,
                   help="Parked submits per tenant before rejection. "
                        "Default = %(default)s")
    p.add_argument("--noFairQueue", action="store_true",
                   help="Disable weighted-fair admission even with "
                        "--authTokens (auth only; legacy direct "
                        "dispatch).")
    p.add_argument("--logLevel", default="INFO")
    return p


def run_router(argv: list[str] | None = None) -> int:
    """`ccs router` entry point (dispatched from pbccs_tpu_torch.cli)."""
    args = build_router_parser().parse_args(argv)
    log = Logger.default(Logger(level=LogLevel.from_string(args.logLevel)))
    from pbccs_tpu_torch.runtime import tuning

    tuning.configure(args.tuneProfile, logger=log)
    if args.routerSpillDepth is None:
        # explicit flag > applied host profile > RouterConfig default
        tuned = tuning.knob_int("router_spill_depth")
        args.routerSpillDepth = (tuned if tuned is not None
                                 else RouterConfig().spill_depth)
    from pbccs_tpu_torch.serve.server import load_edge_config

    edge = load_edge_config(args, "ccs router")
    if edge is None:
        return 2
    ssl_ctx, tenants = edge
    link_ssl = (tenancy.client_ssl_context(args.tlsCa)
                if args.tlsCa or args.tlsReplicas else None)
    try:
        config = RouterConfig(
            health_interval_s=args.routerHealthInterval,
            health_timeout_s=args.routerHealthTimeout,
            bench_after=args.routerBenchAfter,
            readmit_after=args.routerReadmitAfter,
            spill_depth=args.routerSpillDepth,
            max_line_bytes=args.maxLineBytes,
            max_inflight_per_session=args.maxInflightPerSession,
            idle_timeout_s=args.idleTimeout,
            perf_ledger_path=args.perfLedger,
            perf_ledger_interval_s=args.perfLedgerInterval,
            fair_queue=not args.noFairQueue,
            fair_queue_depth=args.tenantQueueDepth,
            shed_burn_threshold=args.shedBurnRate,
            shed_window_s=args.shedWindow,
            retry_after_ms=args.shedRetryMs)
        router = CcsRouter(args.replica, config, logger=log,
                           tenants=tenants, link_ssl=link_ssl,
                           link_token=args.authToken)
    except ValueError as e:
        # a knob or replica spec the dataclass/router rejected: a clean
        # usage error, not a traceback (the message names the field)
        print(f"ccs router: {e}", file=sys.stderr)
        return 2
    with router:
        server = RouterServer(router, args.host, args.port, logger=log,
                              ssl_context=ssl_ctx, tenants=tenants)
        server.start()
        from pbccs_tpu_torch.serve.server import start_metrics_endpoint

        metrics_http = start_metrics_endpoint(
            args.metricsPort, router.metrics_text, args.host, log,
            health=router.accepting, ssl_context=ssl_ctx)
        # machine-readable ready line for wrappers (mirrors CCS-SERVE-READY)
        print(f"CCS-ROUTER-READY {server.host} {server.port}", flush=True)

        stop = threading.Event()

        def _on_signal(signum, frame):
            print(f"CCS-ROUTER-DRAINING "
                  f"signal={signal.Signals(signum).name}", flush=True)
            stop.set()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _on_signal)
            except ValueError:  # not the main thread (embedded router)
                pass
        try:
            stop.wait()
        except KeyboardInterrupt:
            pass
        log.info("ccs router draining: admission stopped, waiting for "
                 f"routed requests (deadline {args.drainTimeout}s)")
        server.stop_accepting()
        server.notify_draining()
        drained = router.close(drain=True, deadline_s=args.drainTimeout)
        server.shutdown()
        if metrics_http is not None:
            metrics_http.shutdown()
        log.info("ccs router drained cleanly" if drained
                 else "ccs router drain deadline hit; failed remainder")
    log.flush()
    return 0
