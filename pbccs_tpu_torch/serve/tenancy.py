"""Multi-tenant edge: identity, fairness, and accounting.

Port of pbccs_tpu.serve.tenancy, unchanged but for its imports (no
device code); the router that fair-queues across replicas with it is
not ported yet, `ccs serve` uses its identity and TLS planes.

Three small planes, deliberately transport-free so router/server own the
sockets and this module owns the policy (mirroring protocol.py):

Identity -- a token file (`--authTokens FILE`, JSON) maps bearer tokens
to tenants.  Every frame at an authenticated front door must carry an
`auth` token (protocol.FIELD_AUTH); the session resolves it ONCE through
TenantDirectory.authenticate and caches the tenant.  The token is the
identity: a client-supplied `tenant` wire field is IGNORED unless the
authenticated tenant is marked `trusted` (the router's own link token),
which is how the router forwards the ORIGINAL tenant to replicas without
letting ordinary clients spoof each other.

Fairness -- FairQueue: per-tenant in-flight quotas with deficit-round-
robin drain.  A tenant under its quota dispatches immediately; over
quota its requests park in a bounded per-tenant queue (one flooding
tenant fills only its OWN queue, never another tenant's slots); past the
queue bound it gets a structured `overloaded` with a retry_after_ms
hint.  Freed capacity is granted to parked tenants in weighted DRR
order, so sustained contention converges to the configured weights
rather than to whoever submits fastest.

Accounting -- every admission outcome lands in the obs registry under
`ccs_tenant_*` (REG001-policed), and FairQueue.rows() feeds the status
verb's `tenancy` block, `ccs top`, and `tenant_snapshot` ledger records.

TLS helpers live here too (stdlib `ssl` only): one server context shape
shared by `ccs serve`/`ccs router`/the metrics endpoint, one client
context shape shared by CcsClient, router replica links, and the fleet
admin path.  Certificate verification is against the operator-provided
CA bundle (`--tlsCa`); hostname checking is off because fleets address
replicas by ephemeral host:port, not by certificate names -- the CA
pinning is the trust anchor.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import ssl
import threading
from typing import Any, Callable

from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.serve import protocol

_reg = default_registry()

# armor bound on bearer tokens (mirrors protocol._TRACE_VALUE_MAX): the
# edge must not hash/compare attacker-chosen megabyte strings per frame
TOKEN_MAX_CHARS = 256


def count_auth_failure(reason: str) -> None:
    """One rejected frame at an authenticated front door, by reason
    (missing_token / bad_token / unknown_tenant)."""
    _reg.counter("ccs_tenant_auth_failures_total",
                 "Frames rejected by edge token auth, by reason",
                 reason=reason).inc()


def count_request(tenant: str) -> None:
    """One submit attributed to a tenant (counted at every tier that
    resolves an identity: router edge and, via the forwarded tenant
    field, each replica -- the federated exposition keeps them apart
    with the replica label)."""
    _reg.counter("ccs_tenant_requests_total",
                 "Submits attributed to a tenant", tenant=tenant).inc()


# ------------------------------------------------------------------ identity

@dataclasses.dataclass(frozen=True)
class Tenant:
    """One row of the token->tenant map.

    priority is a shed CLASS, 0 = highest: under SLO-burn shedding the
    router rejects work from priority >= 1 tenants first and NEVER
    sheds priority 0 (see CcsRouter).  weight scales the DRR quantum --
    a weight-2 tenant drains twice as fast as a weight-1 tenant when
    both are parked.  trusted marks infrastructure tokens (the router's
    replica-link token): only a trusted peer may forward another
    tenant's identity in the wire `tenant` field.  shed_burn_rate is an
    optional PER-TENANT SLO burn threshold: when set, this tenant is
    shed at its own rate instead of the fleet-wide --shedBurnRate (a
    latency-tolerant batch tenant can carry 0.5 while interactive
    tenants shed at the fleet default)."""

    name: str
    token: str
    max_inflight: int = 8
    priority: int = 1
    weight: int = 1
    trusted: bool = False
    shed_burn_rate: float | None = None


class TenantDirectory:
    """Immutable token->tenant map parsed from the --authTokens file.

    File format (README "Multi-tenant quickstart"):

        {"tenants": [
          {"name": "alpha", "token": "<secret>", "max_inflight": 8,
           "priority": 1, "weight": 1},
          {"name": "_router", "token": "<secret>", "priority": 0,
           "trusted": true}
        ]}

    max_inflight/priority/weight/trusted are optional with the Tenant
    defaults above.  Names and tokens must be unique; a malformed file
    is a startup error (ValueError), never a half-loaded directory.
    """

    def __init__(self, tenants: list[Tenant]):
        if not tenants:
            raise ValueError("token file declares no tenants")
        by_name: dict[str, Tenant] = {}
        by_token: dict[str, Tenant] = {}
        for t in tenants:
            if t.name in by_name:
                raise ValueError(f"duplicate tenant name {t.name!r}")
            if t.token in by_token:
                raise ValueError(f"duplicate token (tenant {t.name!r})")
            by_name[t.name] = t
            by_token[t.token] = t
        self._by_name = by_name
        self._by_token = by_token

    @classmethod
    def from_file(cls, path: str) -> "TenantDirectory":
        with open(path, encoding="utf-8") as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"token file is not JSON: {e}") from None
        if not isinstance(doc, dict) or not isinstance(doc.get("tenants"),
                                                       list):
            raise ValueError('token file must be {"tenants": [...]}')
        tenants = []
        for i, row in enumerate(doc["tenants"]):
            if not isinstance(row, dict):
                raise ValueError(f"tenants[{i}] must be an object")
            name, token = row.get("name"), row.get("token")
            if not isinstance(name, str) or not name:
                raise ValueError(f"tenants[{i}].name must be a non-empty "
                                 "string")
            if (not isinstance(token, str) or not token
                    or len(token) > TOKEN_MAX_CHARS):
                raise ValueError(
                    f"tenants[{i}].token must be a non-empty string "
                    f"(<= {TOKEN_MAX_CHARS} chars)")
            max_inflight = row.get("max_inflight", Tenant.max_inflight)
            priority = row.get("priority", Tenant.priority)
            weight = row.get("weight", Tenant.weight)
            trusted = row.get("trusted", Tenant.trusted)
            if (not isinstance(max_inflight, int) or max_inflight < 1
                    or isinstance(max_inflight, bool)):
                raise ValueError(f"tenants[{i}].max_inflight must be an "
                                 "int >= 1")
            if (not isinstance(priority, int) or priority < 0
                    or isinstance(priority, bool)):
                raise ValueError(f"tenants[{i}].priority must be an "
                                 "int >= 0 (0 = highest, never shed)")
            if (not isinstance(weight, int) or weight < 1
                    or isinstance(weight, bool)):
                raise ValueError(f"tenants[{i}].weight must be an int >= 1")
            if not isinstance(trusted, bool):
                raise ValueError(f"tenants[{i}].trusted must be a bool")
            burn = row.get("shed_burn_rate")
            if burn is not None:
                if (isinstance(burn, bool)
                        or not isinstance(burn, (int, float))
                        or not 0.0 <= burn <= 1.0):
                    raise ValueError(
                        f"tenants[{i}].shed_burn_rate must be a number "
                        "in [0, 1] (a violation fraction; omit to use "
                        "the fleet-wide --shedBurnRate)")
                burn = float(burn)
            tenants.append(Tenant(name=name, token=token,
                                  max_inflight=max_inflight,
                                  priority=priority, weight=weight,
                                  trusted=trusted, shed_burn_rate=burn))
        return cls(tenants)

    def authenticate(self, token: Any) -> Tenant | None:
        """Resolve a frame's bearer token; None on anything that is not
        a known token (the caller answers ERR_UNAUTHORIZED)."""
        if not isinstance(token, str) or not token \
                or len(token) > TOKEN_MAX_CHARS:
            return None
        return self._by_token.get(token)

    def get(self, name: str) -> Tenant | None:
        return self._by_name.get(name)

    def tenants(self) -> list[Tenant]:
        return list(self._by_name.values())


class ReloadableTenantDirectory:
    """A TenantDirectory that follows its --authTokens file online.

    Wraps the immutable directory with the reload policy ROADMAP item
    4's follow-on asks for: the map is re-read on SIGHUP
    (``install_sighup``) or when the file's mtime changes (checked at
    most once per ``recheck_s`` on the access path, so the per-frame
    auth cost is one monotonic-clock compare).  Semantics:

      * the FIRST load happens in the constructor and raises like
        ``TenantDirectory.from_file`` -- a malformed file is still a
        loud startup error;
      * a malformed or unreadable file at RELOAD time keeps the
        previous map (one warning + a
        ``ccs_tenant_map_reloads_total{outcome=error}`` count) -- an
        operator mid-edit must never take the front door down;
      * in-flight sessions keep their resolved identity (the session
        caches its Tenant); NEW frames resolve against the new map, so
        deleting a token revokes on the next frame (the per-frame
        re-auth in server._authenticate);
      * listeners registered with ``add_listener`` run after every
        successful swap (outside the lock) -- the router points
        ``FairQueue.refresh`` here so new tenants get admission state
        without a restart.
    """

    def __init__(self, path: str, *, recheck_s: float = 1.0,
                 logger=None, clock: Callable[[], float] | None = None):
        import time
        self._path = path
        self._recheck_s = recheck_s
        self._log = logger
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._inner = TenantDirectory.from_file(path)
        self._mtime = self._stat_mtime()
        self._next_check = self._clock() + recheck_s
        self._listeners: list[Callable[[TenantDirectory], None]] = []
        # written from the signal handler WITHOUT the lock (a handler
        # interrupting a lock holder on the main thread must not block)
        self._sighup = False

    def _stat_mtime(self) -> int | None:
        try:
            import os
            return os.stat(self._path).st_mtime_ns
        except OSError:
            return None

    def _logger(self):
        if self._log is not None:
            return self._log
        # load_edge_config builds the directory before the run installs
        # its leveled logger; resolve the process default lazily so
        # reload notes land in the real log, not a throwaway
        from pbccs_tpu_torch.runtime.logging import Logger
        return Logger.default()

    def _warn(self, msg: str) -> None:
        self._logger().warn(msg)

    def add_listener(self, cb: Callable[[TenantDirectory], None]) -> None:
        with self._lock:
            self._listeners.append(cb)

    def install_sighup(self) -> bool:
        """Arm SIGHUP -> reload-on-next-access; False where signals are
        unavailable (non-main thread, platforms without SIGHUP)."""
        import signal
        if not hasattr(signal, "SIGHUP"):
            return False

        def _handler(signum, frame):
            self._sighup = True

        try:
            signal.signal(signal.SIGHUP, _handler)
        except ValueError:   # not the main thread
            return False
        return True

    def maybe_reload(self) -> bool:
        """One throttled reload check; True when a new map was swapped
        in.  Called from the access path (authenticate/get/tenants) and
        safe to call from anywhere -- failures degrade to the previous
        map, never to an exception."""
        now = self._clock()
        fresh = None
        with self._lock:
            hup, self._sighup = self._sighup, False
            if not hup and now < self._next_check:
                return False
            self._next_check = now + self._recheck_s
            mtime = self._stat_mtime()
            if not hup and (mtime is None or mtime == self._mtime):
                return False
            try:
                fresh = TenantDirectory.from_file(self._path)
            except (OSError, ValueError) as e:
                # remember the bad mtime so a broken edit warns once,
                # not once per recheck window
                self._mtime = mtime
                _reg.counter(
                    "ccs_tenant_map_reloads_total",
                    "Online --authTokens map reloads, by outcome",
                    outcome="error").inc()
                self._warn(f"--authTokens reload failed; keeping the "
                           f"previous map: {e}")
                return False
            self._inner = fresh
            self._mtime = mtime
            listeners = list(self._listeners)
        _reg.counter("ccs_tenant_map_reloads_total",
                     "Online --authTokens map reloads, by outcome",
                     outcome="ok").inc()
        self._logger().info(f"--authTokens map reloaded: "
                            f"{len(fresh.tenants())} tenant(s)")
        for cb in listeners:   # outside the lock: FairQueue.refresh
            cb(fresh)          # takes its own lock
        return True

    # -- the TenantDirectory surface, behind the reload check --------

    def authenticate(self, token: Any) -> Tenant | None:
        self.maybe_reload()
        with self._lock:
            inner = self._inner
        return inner.authenticate(token)

    def get(self, name: str) -> Tenant | None:
        self.maybe_reload()
        with self._lock:
            inner = self._inner
        return inner.get(name)

    def tenants(self) -> list[Tenant]:
        self.maybe_reload()
        with self._lock:
            inner = self._inner
        return inner.tenants()


def resolve_tenant(session_tenant: Tenant | None,
                   wire_tenant: dict[str, Any] | None) -> str | None:
    """The spoofing rule, in one place: the authenticated token's tenant
    IS the identity; the wire `tenant` field is honored only from a
    trusted peer (the router forwarding the original submitter to a
    replica).  Returns the effective tenant name, or None when the
    front door runs open (no token file)."""
    if session_tenant is None:
        return None
    if wire_tenant is not None and session_tenant.trusted:
        return wire_tenant[protocol.KEY_TENANT_NAME]
    return session_tenant.name


# ----------------------------------------------------------------------- TLS

def server_ssl_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    """TLS context for an accepting front door (`--tlsCert/--tlsKey`):
    raises on unreadable/mismatched PEMs at startup, never mid-accept."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


def client_ssl_context(cafile: str | None) -> ssl.SSLContext:
    """TLS context for a connecting tier (`--tlsCa`): the CA bundle is
    the trust anchor (hostname checking off -- fleet members are
    addressed by ephemeral host:port, not certificate names).  With no
    CA the channel is encrypted but unauthenticated; operators should
    always pin the CA outside tests."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.check_hostname = False
    if cafile:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(cafile)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


# ------------------------------------------------------------------ fairness

class _TenantState:
    """Mutable per-tenant admission state, owned by FairQueue's lock."""

    __slots__ = ("tenant", "inflight", "queue", "deficit", "completed",
                 "queued_total", "rejected", "shed")

    def __init__(self, tenant: Tenant):
        self.tenant = tenant
        self.inflight = 0
        self.queue: collections.deque = collections.deque()
        self.deficit = 0
        self.completed = 0
        self.queued_total = 0
        self.rejected = 0
        self.shed = 0


class FairQueue:
    """Weighted deficit-round-robin admission across tenants.

    Sits in FRONT of the router's sticky/spill routing: try_admit either
    grants a slot (tenant under quota), parks the item (bounded
    per-tenant queue), or rejects (queue full).  complete() returns a
    freed slot; drain() then hands parked items back out in DRR order --
    each round a parked tenant's deficit grows by weight * quantum and
    it releases items while deficit and quota allow, so weights govern
    drain share under contention and no tenant is ever starved (every
    tenant with backlog is visited every round).

    The queue has its own lock and never calls back into the router, so
    the router may use it under OR outside its own lock without
    inversion; dispatching drained items is the caller's job (outside
    any lock -- sends block)."""

    def __init__(self, directory: TenantDirectory, *,
                 queue_depth: int = 64, quantum: int = 4):
        self._lock = threading.Lock()
        self._queue_depth = max(1, queue_depth)
        self._quantum = max(1, quantum)
        self._states = {t.name: _TenantState(t)
                        for t in directory.tenants()}
        # DRR visiting order (fixed; leftover deficits, not the order,
        # carry fairness across rounds)
        self._ring = list(self._states)
        self._m_inflight = {
            n: _reg.gauge("ccs_tenant_inflight",
                          "Requests a tenant has in flight past admission",
                          tenant=n) for n in self._states}
        self._m_qdepth = {
            n: _reg.gauge("ccs_tenant_queue_depth",
                          "Requests parked in a tenant's fair queue",
                          tenant=n) for n in self._states}

    def _state(self, tenant: str) -> _TenantState | None:
        return self._states.get(tenant)

    def refresh(self, directory: "TenantDirectory") -> None:
        """Follow a reloaded token map (ReloadableTenantDirectory
        listener): NEW tenants get admission state + gauges so their
        first submit cannot KeyError; EXISTING tenants keep their
        counters, queue, and banked deficit but adopt the new quota/
        weight/priority on the next admission decision.  Tenants
        REMOVED from the map keep their state until it drains -- their
        tokens no longer authenticate, so no new work arrives, and
        in-flight completions still need the slot accounting."""
        with self._lock:
            for t in directory.tenants():
                st = self._states.get(t.name)
                if st is None:
                    self._states[t.name] = _TenantState(t)
                    self._ring.append(t.name)
                    self._m_inflight[t.name] = _reg.gauge(
                        "ccs_tenant_inflight",
                        "Requests a tenant has in flight past admission",
                        tenant=t.name)
                    self._m_qdepth[t.name] = _reg.gauge(
                        "ccs_tenant_queue_depth",
                        "Requests parked in a tenant's fair queue",
                        tenant=t.name)
                else:
                    st.tenant = t

    def try_admit(self, tenant: str, item: Any) -> str:
        """Admission verdict for one request: "dispatch" (slot granted,
        caller routes it now), "queued" (parked; drain() will release
        it), or "rejected" (per-tenant queue full -- caller answers
        overloaded + retry_after_ms)."""
        with self._lock:
            st = self._states[tenant]
            if st.inflight < st.tenant.max_inflight:
                st.inflight += 1
                self._m_inflight[tenant].set(st.inflight)
                return "dispatch"
            if len(st.queue) < self._queue_depth:
                st.queue.append(item)
                st.queued_total += 1
                self._m_qdepth[tenant].set(len(st.queue))
                _reg.counter("ccs_tenant_queued_total",
                             "Submits parked in the fair queue (over "
                             "quota, under queue bound)",
                             tenant=tenant).inc()
                return "queued"
            st.rejected += 1
            _reg.counter("ccs_tenant_rejects_total",
                         "Submits rejected at admission, by reason",
                         tenant=tenant, reason="quota").inc()
            return "rejected"

    def record_shed(self, tenant: str) -> None:
        with self._lock:
            st = self._states.get(tenant)
            if st is not None:
                st.shed += 1
        _reg.counter("ccs_tenant_rejects_total",
                     "Submits rejected at admission, by reason",
                     tenant=tenant, reason="shed").inc()

    def complete(self, tenant: str) -> None:
        """One admitted request finished (any outcome): free its slot.
        The caller should then drain() and dispatch what comes back."""
        with self._lock:
            st = self._states.get(tenant)
            if st is None:
                return
            st.inflight = max(0, st.inflight - 1)
            st.completed += 1
            self._m_inflight[tenant].set(st.inflight)
        _reg.counter("ccs_tenant_completed_total",
                     "Admitted requests completed, per tenant",
                     tenant=tenant).inc()

    def drain(self) -> list[tuple[str, Any]]:
        """Release parked items that now fit their tenant's quota, in
        weighted-DRR order; returns [(tenant, item), ...] for the
        caller to dispatch OUTSIDE any lock."""
        released: list[tuple[str, Any]] = []
        with self._lock:
            # rounds continue while any visit releases work: one freed
            # slot usually releases one item, a burst of completions
            # more.  Every backlogged tenant is visited every round, so
            # leftover deficit -- not visiting order -- carries fairness
            # across rounds AND across drain() calls.
            progressed = True
            while progressed:
                progressed = False
                for name in self._ring:
                    st = self._states[name]
                    if not st.queue:
                        st.deficit = 0   # no backlog -> no banked credit
                        continue
                    if st.inflight >= st.tenant.max_inflight:
                        # quota-bound, not bandwidth-bound: banking
                        # credit here would burst unfairly on free-up
                        continue
                    st.deficit += st.tenant.weight * self._quantum
                    while (st.queue and st.deficit > 0
                           and st.inflight < st.tenant.max_inflight):
                        st.inflight += 1
                        st.deficit -= 1
                        released.append((name, st.queue.popleft()))
                        progressed = True
                    self._m_inflight[name].set(st.inflight)
                    self._m_qdepth[name].set(len(st.queue))
        return released

    def flush(self) -> list[tuple[str, Any]]:
        """Empty every queue (router close): the caller fails the items
        with a structured `closed`."""
        out: list[tuple[str, Any]] = []
        with self._lock:
            for name, st in self._states.items():
                while st.queue:
                    out.append((name, st.queue.popleft()))
                self._m_qdepth[name].set(0)
        return out

    def rows(self) -> list[dict[str, Any]]:
        """Per-tenant accounting snapshot: the status verb's `tenancy`
        block, `ccs top`'s tenant table, and the router's
        tenant_snapshot ledger records all render these rows."""
        with self._lock:
            return [{
                "name": name,
                "priority": st.tenant.priority,
                "weight": st.tenant.weight,
                "max_inflight": st.tenant.max_inflight,
                "inflight": st.inflight,
                "queued": len(st.queue),
                "completed": st.completed,
                "queued_total": st.queued_total,
                "rejected": st.rejected,
                "shed": st.shed,
            } for name, st in sorted(self._states.items())]


# ------------------------------------------------------------- SLO burn meter

class BurnMeter:
    """Windowed fleet SLO burn rate from health-probe status replies.

    Each probe reply's `slo` block carries lifetime requests/violations
    counters; the meter differences them per replica and keeps the
    deltas in a sliding window, so rate() is the fleet-wide fraction of
    recent requests that violated the SLO -- the signal the router's
    shed policy thresholds on.  A replica restart (counters moving
    backwards) resets that replica's baseline instead of producing
    negative deltas."""

    def __init__(self, window_s: float = 30.0,
                 clock: Callable[[], float] | None = None):
        import time
        self._window_s = window_s
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._prev: dict[str, tuple[int, int]] = {}
        self._events: collections.deque = collections.deque()

    def observe(self, replica: str, slo_block: Any) -> None:
        if not isinstance(slo_block, dict):
            return
        req, vio = slo_block.get("requests"), slo_block.get("violations")
        if not isinstance(req, int) or not isinstance(vio, int):
            return
        now = self._clock()
        with self._lock:
            preq, pvio = self._prev.get(replica, (req, vio))
            self._prev[replica] = (req, vio)
            dreq, dvio = req - preq, vio - pvio
            if dreq < 0 or dvio < 0:   # replica restarted; re-baseline
                return
            if dreq > 0:
                self._events.append((now, dreq, dvio))
            self._trim_locked(now)

    def forget(self, replica: str) -> None:
        with self._lock:
            self._prev.pop(replica, None)

    def _trim_locked(self, now: float) -> None:
        while self._events and now - self._events[0][0] > self._window_s:
            self._events.popleft()

    def rate(self) -> float:
        """Fleet burn over the window: violations/requests in [0, 1];
        0.0 when the window is empty (no signal = no shedding)."""
        now = self._clock()
        with self._lock:
            self._trim_locked(now)
            req = sum(e[1] for e in self._events)
            vio = sum(e[2] for e in self._events)
        return (vio / req) if req > 0 else 0.0
