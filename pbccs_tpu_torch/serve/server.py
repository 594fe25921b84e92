"""TCP front end of the serving engine: NDJSON sessions over sockets.

Port of pbccs_tpu.serve.server: the same sessions, armor, verbs, flags
and ready/drain lines.  `run_serve(argv, device=...)` polishes on the
card unless `device` names another (the tests pass device="cpu").
`--compileCache DIR` points the kernel builds at DIR (runtime/cache.py),
so replicas and restarts pointed at one DIR share its libraries.

One accept loop, one reader thread per client session.  Replies are
written by whichever thread completes them (engine polish workers via
the request callback, the session reader for status/ping/errors) under a
per-session write lock, so per-ZMW results STREAM back as they complete
-- out of order across requests, interleaved across the session's
in-flight submissions.

Failure containment: a malformed frame gets a structured `bad_request`
reply and the session lives on; an engine-side raise gets `internal` and
the server lives on; a client that disconnects mid-stream only kills its
own session (its in-flight requests complete engine-side and their
replies are dropped on the closed socket).

Wire-protocol armor (ServeConfig knobs): the session reader enforces a
max frame length (oversized -> `bad_request` + close), an idle read
timeout (slow-loris sessions with nothing in flight are reaped with a
`closed` notice), and a per-session in-flight cap (excess submits are
rejected `overloaded` without touching the engine).  Every abnormal
session end is counted under ccs_serve_session_aborts_total{cause} and
logged at debug with peer + direction, so a fleet saturating the armor
is visible before it is a problem.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import ssl
import sys
import threading

from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.runtime.logging import Logger, LogLevel
from pbccs_tpu_torch.serve import protocol, tenancy
from pbccs_tpu_torch.serve.engine import (
    CcsEngine,
    EngineClosed,
    EngineOverloaded,
    Request,
    ServeConfig,
)

_reg = default_registry()
_m_cap_rejects = _reg.counter(
    "ccs_serve_inflight_cap_rejects_total",
    "Submits rejected by the per-session in-flight cap")


def _count_abort(cause: str) -> None:
    _reg.counter("ccs_serve_session_aborts_total",
                 "Sessions ended abnormally, by cause",
                 cause=cause).inc()


class _FramedSession:
    """One connected client: a reader loop + a locked writer.

    Owns everything front-door-generic -- the bounded NDJSON framing
    loop, the wire-protocol armor (max frame length, idle reap,
    per-session in-flight cap), abort accounting, and the status /
    metrics / ping verbs -- against any `engine`-shaped front
    (`server.engine` must expose .config with the armor fields,
    .status(), and .metrics_text()).  `_Session` binds it to a local
    CcsEngine; pbccs_tpu's replica router session binds the SAME armor
    to its fan-out front door, so the hostile-input guarantees hold
    identically at both tiers (tools/fuzz_inputs.py
    points the same wire legs at each)."""

    _RECV = 1 << 16

    def __init__(self, server: "CcsServer", conn: socket.socket, peer):
        self.server = server
        self.conn = conn
        self.peer = peer
        self.alive = True
        self.closing = False      # server-initiated close (drain/shutdown)
        self._wlock = threading.RLock()
        # alive transitions get their OWN lock: _wlock is held across a
        # blocking sendall (frame atomicity), so taking it just to flip
        # the flag would let one wedged completer stall the reader's
        # teardown (and with --idleTimeout 0, stall it forever)
        self._slock = threading.Lock()
        self._ilock = threading.Lock()
        self._inflight = 0
        # resolved ONCE per session from the first authenticated frame's
        # bearer token (tenancy.TenantDirectory); None on an open front
        # door.  Written only by the reader thread (_authenticate).
        self.tenant: tenancy.Tenant | None = None

    def inflight(self) -> int:
        with self._ilock:
            return self._inflight

    def send(self, msg: dict) -> None:
        """Best-effort reply: a dead socket marks the session closed but
        never raises into the completer (engine callbacks must survive
        client disconnects)."""
        data = protocol.encode_msg(msg)
        try:
            with self._wlock:
                self.conn.sendall(data)
        except OSError as e:
            # `alive` is read/written by the reader thread and every
            # completer that replies here: transition it under the state
            # lock so exactly one path logs the death (ccs-analyze CONC001)
            with self._slock:
                was_alive, self.alive = self.alive, False
            if was_alive and not self.closing:
                self.server.log.debug(
                    f"session {self.peer}: send failed ({e!r}); "
                    "marking session dead")
                _count_abort("send_failed")

    # ------------------------------------------------------------- armor

    def _try_acquire_slot(self, rid) -> bool:
        """Reserve one in-flight slot for a submit; a capped session gets
        a structured `overloaded` reply BEFORE parsing/admission (one
        hostile session can neither monopolize the engine pool nor make
        it parse unbounded payloads it will reject anyway)."""
        cap = self.server.engine.config.max_inflight_per_session
        with self._ilock:
            if self._inflight >= cap:
                capped = True
            else:
                capped = False
                self._inflight += 1
        if capped:
            _m_cap_rejects.inc()
            self.send(protocol.error_to_wire(
                rid, protocol.ERR_OVERLOADED,
                f"per-session in-flight cap ({cap}) reached; "
                "wait for results before submitting more"))
            return False
        return True

    def _release_slot(self) -> None:
        with self._ilock:
            self._inflight -= 1

    # ------------------------------------------------------------- verbs

    def _on_submit(self, msg: dict) -> None:
        raise NotImplementedError   # front-door specific (_Session/router)

    def _on_trace(self, msg: dict) -> None:
        self.send(protocol.error_to_wire(
            msg.get("id"), protocol.ERR_BAD_REQUEST,
            "trace is not supported by this front door"))

    def _on_fleet(self, msg: dict) -> None:
        # fleet membership administration is a ROUTER verb; the local
        # serve front door rejects it structurally (the router session
        # subclass overrides this with the real implementation)
        self.send(protocol.error_to_wire(
            msg.get("id"), protocol.ERR_BAD_REQUEST,
            "fleet is not supported by this front door"))

    def _parse_submit(self, msg: dict):
        """Shared submit decode: validated (chunk, deadline, trace
        context, effective tenant name), or None after a structured
        `bad_request` reply (the caller already released its
        slot-acquire responsibilities via the returned sentinel).  The
        tenant is the AUTHENTICATED identity (tenancy.resolve_tenant):
        the wire `tenant` field only matters from a trusted token."""
        rid = msg.get("id")
        try:
            chunk = protocol.chunk_from_wire(msg.get("zmw"))
            trace_ctx = protocol.trace_from_wire(
                msg.get(protocol.FIELD_TRACE))
            wire_tenant = protocol.tenant_from_wire(
                msg.get(protocol.FIELD_TENANT))
        except protocol.ProtocolError as e:
            self.send(protocol.error_to_wire(
                rid, protocol.ERR_BAD_REQUEST, str(e)))
            return None
        deadline_ms = msg.get("deadline_ms")
        if deadline_ms is not None and not isinstance(deadline_ms,
                                                      (int, float)):
            self.send(protocol.error_to_wire(
                rid, protocol.ERR_BAD_REQUEST, "deadline_ms must be a number"))
            return None
        tenant = tenancy.resolve_tenant(self.tenant, wire_tenant)
        return chunk, deadline_ms, trace_ctx, tenant

    def _on_status(self, msg: dict) -> None:
        status = self.server.engine.status()
        status.update(type=protocol.TYPE_STATUS, id=msg.get("id"),
                      sessions=self.server.session_count(),
                      protocol_version=protocol.PROTOCOL_VERSION)
        self.send(status)

    def _on_metrics(self, msg: dict) -> None:
        self.send({"type": protocol.TYPE_METRICS, "id": msg.get("id"),
                   "content_type": protocol.METRICS_CONTENT_TYPE,
                   "body": self.server.engine.metrics_text()})

    # ------------------------------------------------------------- reader

    def _authenticate(self, msg: dict) -> bool:
        """Token auth gate, ahead of verb dispatch: on an authenticated
        front door (--authTokens) every frame must carry a known `auth`
        bearer token.  Failure answers a structured ERR_UNAUTHORIZED --
        the session survives, exactly like bad_request, but the frame is
        never parsed further (no verb, no payload).  The resolved tenant
        is cached on the session; per-frame tokens are still checked so
        an interleaved bad frame cannot ride an earlier good one."""
        directory = self.server.tenants
        if directory is None:
            return True
        token = msg.get(protocol.FIELD_AUTH)
        if token is None:
            reason = "missing_token"
        else:
            tenant = directory.authenticate(token)
            if tenant is not None:
                self.tenant = tenant
                return True
            reason = "bad_token"
        tenancy.count_auth_failure(reason)
        self.send(protocol.error_to_wire(
            msg.get("id"), protocol.ERR_UNAUTHORIZED,
            f"auth failed ({reason}): this front door requires a known "
            f"`{protocol.FIELD_AUTH}` bearer token on every frame"))
        return False

    def _dispatch(self, line: bytes) -> None:
        try:
            msg = protocol.decode_line(line)
        except protocol.ProtocolError as e:
            self.send(protocol.error_to_wire(
                None, protocol.ERR_BAD_REQUEST, str(e)))
            return
        if not self._authenticate(msg):
            return
        verb = msg.get("verb")
        if verb == protocol.VERB_SUBMIT:
            self._on_submit(msg)
        elif verb == protocol.VERB_STATUS:
            self._on_status(msg)
        elif verb == protocol.VERB_METRICS:
            self._on_metrics(msg)
        elif verb == protocol.VERB_TRACE:
            self._on_trace(msg)
        elif verb == protocol.VERB_FLEET:
            self._on_fleet(msg)
        elif verb == protocol.VERB_PING:
            self.send({"type": protocol.TYPE_PONG, "id": msg.get("id")})
        else:
            self.send(protocol.error_to_wire(
                msg.get("id"), protocol.ERR_BAD_REQUEST,
                f"unknown verb: {verb!r}"))

    def run(self) -> None:
        log = self.server.log
        cfg = self.server.engine.config
        log.debug(f"session open: {self.peer}")
        cause = None
        try:
            self.conn.settimeout(cfg.idle_timeout_s or None)
            buf = bytearray()
            while True:
                nl = buf.find(b"\n")
                # the current frame's length so far -- complete (up to
                # the newline) or still accumulating (whole buffer, the
                # only per-session allocation an untrusted peer controls)
                if (nl if nl >= 0 else len(buf)) > cfg.max_line_bytes:
                    self.send(protocol.error_to_wire(
                        None, protocol.ERR_BAD_REQUEST,
                        f"frame exceeds max_line_bytes="
                        f"{cfg.max_line_bytes}; closing session"))
                    cause = "oversized_frame"
                    return
                if nl < 0:
                    try:
                        data = self.conn.recv(self._RECV)
                    except socket.timeout:
                        if self.inflight() > 0:
                            continue  # quiet but waiting on results
                        self.send({"type": protocol.TYPE_CLOSED,
                                   "reason": "idle_timeout"})
                        cause = "idle_timeout"
                        return
                    except OSError as e:
                        if not self.closing:
                            log.debug(f"session {self.peer}: recv failed "
                                      f"({e!r}); treating as peer reset")
                            cause = "peer_reset"
                        return
                    if not data:
                        if buf.strip():
                            # peer sent half a frame then FIN
                            cause = "torn_frame"
                        return
                    buf += data
                    continue
                line = bytes(buf[:nl])
                del buf[: nl + 1]
                if line.strip():
                    self._dispatch(line)
        finally:
            with self._slock:
                self.alive = False
            if cause is not None:
                _count_abort(cause)
                log.debug(f"session {self.peer} aborted: {cause}")
            try:
                self.conn.close()
            except OSError:
                pass
            self.server._forget(self)
            log.debug(f"session closed: {self.peer}")


class _Session(_FramedSession):
    """A framed session bound to a LOCAL CcsEngine (the `ccs serve`
    front door): submits admit into the engine, trace drives the
    engine's span capture."""

    def _on_submit(self, msg: dict) -> None:
        rid = msg.get("id")
        if not self._try_acquire_slot(rid):
            return
        parsed = self._parse_submit(msg)
        if parsed is None:
            self._release_slot()
            return
        chunk, deadline_ms, trace_ctx, tenant = parsed
        if tenant is not None:
            # replica-side per-tenant accounting: the router forwards the
            # original submitter on the hop, so the federated exposition
            # shows each tenant's load per replica
            tenancy.count_request(tenant)

        def on_done(req: Request) -> None:
            if req.error is not None:
                msg = protocol.error_to_wire(rid, protocol.ERR_INTERNAL,
                                             req.error)
            else:
                msg = protocol.result_to_wire(rid, req.chunk.id,
                                              req.failure, req.result,
                                              req.latency_ms)
            # slot freed and reply written under the write lock: a
            # draining server's `closed` notice (notify_draining sees no
            # slot held) cannot go out, and shut the socket, in between
            with self._wlock:
                self._release_slot()
                self.send(msg)

        try:
            self.server.engine.submit(chunk, deadline_ms=deadline_ms,
                                      callback=on_done,
                                      trace_ctx=trace_ctx)
        except EngineOverloaded as e:
            self._release_slot()
            self.send(protocol.error_to_wire(
                rid, protocol.ERR_OVERLOADED, str(e)))
        except EngineClosed as e:
            self._release_slot()
            self.send(protocol.error_to_wire(rid, protocol.ERR_CLOSED,
                                             str(e)))

    def _on_trace(self, msg: dict) -> None:
        rid = msg.get("id")
        action = msg.get("action")
        if action == "start":
            started = self.server.engine.trace_start()
            self.send({"type": protocol.TYPE_TRACE, "id": rid,
                       "state": "started" if started
                       else "already_running"})
        elif action == "stop":
            chrome = self.server.engine.trace_stop()
            reply = {"type": protocol.TYPE_TRACE, "id": rid,
                     "state": "stopped" if chrome is not None
                     else "not_running"}
            if chrome is not None:
                reply["trace"] = chrome
            self.send(reply)
        else:
            self.send(protocol.error_to_wire(
                rid, protocol.ERR_BAD_REQUEST,
                'trace.action must be "start" or "stop"'))


class CcsServer:
    """Threaded NDJSON-over-TCP server fronting one CcsEngine.

    Subclasses swap `session_class`/`name` to front a different
    engine-shaped object with the same accept loop + armor (the replica
    router's RouterServer does)."""

    session_class: type = _Session
    name = "ccs serve"

    # a stalled TLS handshake occupies ITS bring-up thread this long at
    # most; the accept loop is never behind it
    handshake_timeout_s = 10.0

    def __init__(self, engine: CcsEngine, host: str = "127.0.0.1",
                 port: int = 0, logger: Logger | None = None,
                 ssl_context: ssl.SSLContext | None = None,
                 tenants: "tenancy.TenantDirectory | None" = None):
        self.engine = engine
        self.log = logger or Logger.default()
        self.ssl_context = ssl_context
        self.tenants = tenants
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        # closing a socket does not reliably wake a blocking accept() on
        # Linux; a short accept timeout lets the loop observe shutdown
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()[:2]
        self._sessions: set[_Session] = set()
        self._slock = threading.Lock()
        self._accept_thread: threading.Thread | None = None
        self._shutdown = threading.Event()

    def session_count(self) -> int:
        with self._slock:
            return len(self._sessions)

    def _forget(self, session: _Session) -> None:
        with self._slock:
            self._sessions.discard(session)

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, peer = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listening socket closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # keepalive reaps sessions whose peer vanished without FIN
            # (power loss, NAT timeout): without it the reader thread and
            # fd of every half-open session leak for the server's lifetime
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            # per-connection bring-up happens OFF this loop: with TLS on,
            # the handshake blocks, and one stalled/hostile handshake
            # must never stop the fleet accepting (slow-loris armor)
            threading.Thread(target=self._run_session, args=(conn, peer),
                             daemon=True,
                             name=f"ccs-serve-session-{peer}").start()

    def _run_session(self, conn: socket.socket, peer) -> None:
        """Bring one accepted connection up (TLS handshake when
        configured) and run its session.  A failed handshake is a
        counted structured abort (ccs_serve_session_aborts_total
        {cause="tls_handshake"}) -- a plaintext client probing a TLS'd
        port, a bad cert, or a stalled handshake never tracebacks and
        never reaches the framing layer."""
        if self.ssl_context is not None:
            conn.settimeout(self.handshake_timeout_s)
            try:
                conn = self.ssl_context.wrap_socket(conn, server_side=True)
            except (OSError, ssl.SSLError) as e:
                _count_abort("tls_handshake")
                self.log.debug(
                    f"session {peer}: TLS handshake failed ({e!r})")
                try:
                    conn.close()
                except OSError:
                    pass
                return
        conn.settimeout(None)  # sessions block; the reader sets idle reap
        session = self.session_class(self, conn, peer)
        with self._slock:
            if self._shutdown.is_set():
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self._sessions.add(session)
        session.run()

    def start(self) -> "CcsServer":
        """Start accepting in the background; returns immediately."""
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ccs-serve-accept")
        self._accept_thread.start()
        self.log.info(f"{self.name} listening on {self.host}:{self.port}")
        return self

    def serve_forever(self) -> None:
        self.start()
        try:
            self._shutdown.wait()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def stop_accepting(self) -> None:
        """Close the listening socket: existing sessions live on, new
        connects fail (the graceful-drain first step)."""
        try:
            self._sock.close()
        except OSError:
            pass

    def notify_draining(self) -> None:
        """Graceful-drain second step: tell every idle session (nothing
        in flight) the server is going away via a `closed` notice and
        close it; sessions with in-flight requests stay open so their
        streamed results can land before shutdown()."""
        with self._slock:
            sessions = list(self._sessions)
        for s in sessions:
            if s.inflight() > 0:
                continue
            s.closing = True
            s.send({"type": protocol.TYPE_CLOSED, "reason": "draining"})
            try:
                # shutdown (not close): the reader thread still holds the
                # fd in recv, and only shutdown() FINs the peer + wakes
                # the reader while it does
                s.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def shutdown(self) -> None:
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        self.stop_accepting()
        with self._slock:
            sessions = list(self._sessions)
        for s in sessions:
            s.closing = True
            try:
                s.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.conn.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    def __enter__(self) -> "CcsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ------------------------------------------------------------------- ccs serve

def build_serve_parser() -> argparse.ArgumentParser:
    defaults = ServeConfig()  # one source of defaults (engine.ServeConfig)
    p = argparse.ArgumentParser(
        prog="ccs serve",
        description="Serve CCS consensus over a streaming NDJSON/TCP "
                    "protocol (long-lived engine, dynamic batching).")
    p.add_argument("--host", default="127.0.0.1",
                   help="Bind address. Default = %(default)s")
    p.add_argument("--port", type=int, default=7331,
                   help="Bind port (0 = ephemeral). Default = %(default)s")
    p.add_argument("--maxBatch", type=int, default=None,
                   help="ZMWs per polish batch (bucket fill-flush size). "
                        "Default: the applied --tuneProfile's "
                        "serve_max_batch, else "
                        f"{defaults.max_batch}")
    p.add_argument("--maxWaitMs", type=float, default=None,
                   help="Max time a request waits to be batched before a "
                        "deadline flush. Default: the applied "
                        "--tuneProfile's serve_max_wait_ms, else "
                        f"{defaults.max_wait_ms}")
    p.add_argument("--maxPending", type=int, default=defaults.max_pending,
                   help="Admission bound: requests in the system before "
                        "submits are rejected as overloaded. "
                        "Default = %(default)s")
    p.add_argument("--prepWorkers", type=int, default=defaults.prep_workers,
                   help="Host draft/mapping threads. Default = %(default)s")
    p.add_argument("--devices", type=int, default=defaults.devices,
                   help="Polish across a device fleet (pbccs_tpu_torch.sched): "
                        "N>1 uses the first N visible devices, 0 all of "
                        "them, 1 the legacy single-device polish "
                        "executor. Default = %(default)s")
    p.add_argument("--schedPolicy",
                   choices=("sticky", "least", "roundrobin"),
                   default=defaults.sched_policy,
                   help="Device-fleet routing: sticky keeps a shape "
                        "bucket on the device that already ran it "
                        "(least-loaded otherwise). "
                        "Default = %(default)s")
    p.add_argument("--deadlineMs", type=float,
                   default=defaults.default_deadline_ms,
                   help="Default per-request deadline. Default = %(default)s")
    # wire-protocol armor + drain (the input-hardening knobs; see
    # protocol.py "Protocol armor")
    p.add_argument("--maxLineBytes", type=int,
                   default=defaults.max_line_bytes,
                   help="Longest accepted NDJSON frame; oversized frames "
                        "get bad_request and the session closes. "
                        "Default = %(default)s")
    p.add_argument("--maxInflightPerSession", type=int,
                   default=defaults.max_inflight_per_session,
                   help="Submits one session may have in flight before "
                        "rejection as overloaded. Default = %(default)s")
    p.add_argument("--idleTimeout", type=float,
                   default=defaults.idle_timeout_s,
                   help="Reap sessions idle (no bytes, nothing in flight) "
                        "this many seconds; 0 disables. "
                        "Default = %(default)s")
    p.add_argument("--drainTimeout", type=float, default=30.0,
                   help="On SIGTERM/SIGINT, wait this long for in-flight "
                        "requests before fast-aborting the rest. "
                        "Default = %(default)s")
    # multi-tenant edge (serve/tenancy.py): TLS on the front door + the metrics scrape, and a
    # token->tenant map that turns on per-frame bearer-token auth
    p.add_argument("--tlsCert", default=None, metavar="PEM",
                   help="Serve the NDJSON front door (and --metricsPort) "
                        "over TLS with this certificate chain; requires "
                        "--tlsKey.  Default: plaintext.")
    p.add_argument("--tlsKey", default=None, metavar="PEM",
                   help="Private key for --tlsCert.")
    p.add_argument("--authTokens", default=None, metavar="FILE",
                   help="JSON token->tenant map (tenancy.TenantDirectory): "
                        "when set, every frame must carry a known `auth` "
                        "bearer token or gets a structured `unauthorized`. "
                        "Default: open front door.")
    # observability plane (obs/): the HTTP scrape surface + SLO target
    p.add_argument("--metricsPort", type=int, default=0,
                   help="Serve a stdlib-HTTP Prometheus /metrics scrape "
                        "endpoint on this port (-1 = ephemeral, printed "
                        "as CCS-METRICS-READY; 0 disables). "
                        "Default = %(default)s")
    p.add_argument("--sloP99Ms", type=float, default=defaults.slo_p99_ms,
                   help="Per-request latency objective in ms: slower "
                        "requests count into ccs_slo_violations_total "
                        "and the status verb's slo block (0 disables). "
                        "Default = %(default)s")
    p.add_argument("--perfLedger", default=None, metavar="PATH",
                   help="Append schema-versioned NDJSON performance "
                        "records (obs/ledger.py) to PATH: one snapshot "
                        "per --perfLedgerInterval plus a final record "
                        "at drain; the status verb grows a `perf` "
                        "block the router federates.  Default: off.")
    p.add_argument("--perfLedgerInterval", type=float,
                   default=defaults.perf_ledger_interval_s,
                   help="Seconds between perf-ledger snapshots. "
                        "Default = %(default)s")
    p.add_argument("--compileCache", default=None, metavar="DIR",
                   help="Kernel build-cache directory shared across "
                        "replicas/restarts: a rolling restart loads the "
                        "kernel libraries from disk instead of building "
                        "them (default: build/kernels/ of the checkout, "
                        "else ~/.cache/pbccs_tpu_torch/kernels).")
    p.add_argument("--tuneProfile", default=None, metavar="PATH|auto",
                   help="ccs-tune host profile (runtime/tuning.py): "
                        "supplies defaults for --maxBatch/--maxWaitMs "
                        "plus the batch knobs (band width, dense "
                        "blocking) when the explicit flag/env is absent. "
                        "'auto' scans the profiles/ directory for a "
                        "fingerprint match; a missing/corrupt/mismatched "
                        "profile degrades to built-in defaults with a "
                        "logged note.  Default: PBCCS_TUNE_PROFILE, "
                        "else no profile.")
    # consensus + resilience knobs shared (definition and defaults) with
    # the offline CLI; serve maps --polishTimeout to the ENGINE-level
    # watchdog (ServeConfig.polish_timeout_ms) rather than the ambient
    # per-dispatch one, so a single timer governs each polish batch
    from pbccs_tpu_torch.cli import add_consensus_args, add_resilience_args

    add_consensus_args(p)
    add_resilience_args(p)
    p.add_argument("--logLevel", default="INFO")
    return p


def run_serve(argv: list[str] | None = None, *, device=None) -> int:
    """`ccs serve` entry point (dispatched from pbccs_tpu_torch.cli).
    `device` as the CLI's run() takes it: None polishes on the card (exit
    1 when there is none), "cpu" runs the kernels' plain versions.  The
    fault injector and tune profile it arms are restored when it
    returns, as cli.run restores them."""
    args = build_serve_parser().parse_args(argv)
    from pbccs_tpu_torch.resilience import faults
    from pbccs_tpu_torch.runtime import tuning

    prev_injector = faults.get()
    try:
        with tuning.scope():
            return _run_serve(args, device)
    finally:
        faults.install(prev_injector)


def _run_serve(args, device) -> int:
    if args.devices < 0:
        print(f"option --devices: must be >= 0, got {args.devices}",
              file=sys.stderr)
        return 2
    edge = load_edge_config(args, "ccs serve")
    if edge is None:
        return 2
    ssl_ctx, tenants = edge

    from pbccs_tpu_torch.resilience import faults

    if args.faults is not None:
        faults.configure(args.faults, seed=args.faultSeed)
    # fault site: fires before the engine exists, so an armed
    # `serve.start:crashloop` spec kills the replica instantly (the
    # supervisor's quarantine path is chaos-testable without a broken
    # build).  Keys on the fleet slot the supervisor exports, so a
    # `~N` modifier targets one slot of a homogeneous fleet.
    faults.maybe_fail("serve.start",
                      keys=(os.environ.get("PBCCS_FLEET_SLOT", ""),))

    from pbccs_tpu_torch.runtime.cache import enable_compilation_cache

    enable_compilation_cache(args.compileCache)
    log = Logger.default(Logger(level=LogLevel.from_string(args.logLevel)))

    from pbccs_tpu_torch.cli import band_width_refused
    from pbccs_tpu_torch.device import resolve_device
    from pbccs_tpu_torch.runtime import tuning

    tuning.configure(args.tuneProfile, logger=log, device=device)
    if args.model == "arrow" and band_width_refused(device):
        return 2
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(f"ccs serve: {e}", file=sys.stderr)
        return 1
    serve_defaults = ServeConfig()
    # resolution ladder: explicit flag >
    # applied host profile > ServeConfig default
    max_batch = (args.maxBatch
                 if args.maxBatch is not None
                 else tuning.knob_int("serve_max_batch")
                 or serve_defaults.max_batch)
    max_wait_ms = (args.maxWaitMs
                   if args.maxWaitMs is not None
                   else tuning.knob_float("serve_max_wait_ms")
                   or serve_defaults.max_wait_ms)

    from pbccs_tpu_torch.cli import consensus_settings_from_args

    settings = consensus_settings_from_args(args)
    config = ServeConfig(
        max_batch=max_batch,
        max_wait_ms=max_wait_ms,
        max_pending=args.maxPending,
        prep_workers=args.prepWorkers,
        devices=args.devices,
        sched_policy=args.schedPolicy,
        default_deadline_ms=args.deadlineMs,
        min_read_score=args.minReadScore,
        polish_timeout_ms=(args.polishTimeout or 0) * 1e3,
        max_line_bytes=args.maxLineBytes,
        max_inflight_per_session=args.maxInflightPerSession,
        idle_timeout_s=args.idleTimeout,
        slo_p99_ms=args.sloP99Ms,
        perf_ledger_path=args.perfLedger,
        perf_ledger_interval_s=args.perfLedgerInterval)

    with CcsEngine(settings, config, logger=log, device=device) as engine:
        server = CcsServer(engine, args.host, args.port, logger=log,
                           ssl_context=ssl_ctx, tenants=tenants)
        server.start()
        metrics_http = start_metrics_endpoint(
            args.metricsPort, engine.metrics_text, args.host, log,
            health=engine.accepting, ssl_context=ssl_ctx)
        # machine-readable ready line for wrappers (ccs tune --serveLeg
        # and chip_smoke.py poll it)
        print(f"CCS-SERVE-READY {server.host} {server.port}", flush=True)

        # graceful drain: a k8s-style TERM (or ^C) stops admission,
        # finishes what is in flight (bounded by --drainTimeout, falling
        # back to fast abort), and exits 0 -- never a mid-batch kill
        stop = threading.Event()

        def _on_signal(signum, frame):
            # machine-readable line for wrappers (mirrors CCS-SERVE-READY)
            print(f"CCS-SERVE-DRAINING "
                  f"signal={signal.Signals(signum).name}", flush=True)
            stop.set()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _on_signal)
            except ValueError:  # not the main thread (embedded serve)
                pass
        try:
            stop.wait()
        except KeyboardInterrupt:
            pass
        log.info("ccs serve draining: admission stopped, waiting for "
                 f"in-flight requests (deadline {args.drainTimeout}s)")
        server.stop_accepting()
        server.notify_draining()
        drained = engine.close(drain=True, deadline_s=args.drainTimeout)
        server.shutdown()
        if metrics_http is not None:
            metrics_http.shutdown()
        log.info("ccs serve drained cleanly" if drained
                 else "ccs serve drain deadline hit; aborted remainder")
    log.flush()
    return 0


def load_edge_config(args, prog: str):
    """Shared `--tlsCert/--tlsKey/--authTokens` resolution for `ccs
    serve` / `ccs router` / `ccs fleet`: returns (ssl_context | None,
    TenantDirectory | None), or None after printing a structured usage
    error (the caller exits 2).  Bad PEMs and malformed token files are
    startup errors, never a half-secured listener."""
    if bool(args.tlsCert) != bool(args.tlsKey):
        print(f"{prog}: --tlsCert and --tlsKey must be given together",
              file=sys.stderr)
        return None
    ssl_ctx = None
    if args.tlsCert:
        try:
            ssl_ctx = tenancy.server_ssl_context(args.tlsCert, args.tlsKey)
        except (OSError, ssl.SSLError) as e:
            print(f"{prog}: cannot load TLS cert/key: {e}", file=sys.stderr)
            return None
    tenants = None
    if args.authTokens:
        try:
            # online-reloadable (SIGHUP or mtime change): an edited
            # token map takes effect on the next frame without a
            # rolling restart.  The FIRST load still fails loud.
            tenants = tenancy.ReloadableTenantDirectory(args.authTokens)
        except (OSError, ValueError) as e:
            print(f"{prog}: --authTokens: {e}", file=sys.stderr)
            return None
        tenants.install_sighup()
    return ssl_ctx, tenants


def start_metrics_endpoint(port: int, render, host: str, log,
                           health=None, ssl_context=None):
    """Shared `--metricsPort` wiring for `ccs serve` and `ccs router`:
    0 disables, -1 binds an ephemeral port; the bound port is printed as
    a machine-readable CCS-METRICS-READY line (wrappers/smokes poll it,
    mirroring CCS-SERVE-READY).  `health` backs /healthz (engine/router
    `accepting`), so a draining process probes 503 before its socket
    ever closes.  `ssl_context` (the front door's --tlsCert context)
    makes the scrape endpoint HTTPS -- a TLS'd fleet has NO plaintext
    surface, including metrics."""
    if port == 0:
        return None
    from pbccs_tpu_torch.obs.httpexp import start_metrics_http

    server = start_metrics_http(render, host=host,
                                port=0 if port < 0 else port,
                                health=health, ssl_context=ssl_context)
    print(f"CCS-METRICS-READY {host} {server.server_port}", flush=True)
    scheme = "https" if ssl_context is not None else "http"
    log.info(f"metrics scrape endpoint on "
             f"{scheme}://{host}:{server.server_port}/metrics")
    return server
