"""Python client for the CCS serving protocol.

Port of pbccs_tpu.serve.client, unchanged but for its imports (no
device code): it speaks the same wire, so it serves either package's
`ccs serve`.

One TCP session, many concurrent in-flight requests: `submit*` returns a
PendingReply immediately, a background reader thread re-associates the
out-of-order streamed replies by request id, and `.reply()` blocks the
caller until that request's result lands.  Thread-safe: any number of
caller threads may share one client (the load generator runs many).

Security: `tls_ca`/`tls` wrap the session in TLS (tenancy.
client_ssl_context -- CA-pinned verification, no hostname check), and
`auth_token` rides every frame as the `auth` bearer token an
authenticated front door requires.

Resilience: `submit_with_retry` rides out BOTH `overloaded`
backpressure (jittered exponential backoff, or the server's
`retry_after_ms` hint when a shed reply carries one) and connection
loss -- a
dropped socket fails the in-flight attempt with ConnectionError, the
next attempt reconnects to the same endpoint and RESUBMITS the payload
under a fresh request id (an unacknowledged submit is the client's to
replay; the server/router side dedups nothing because a new id is a new
request and polish is pure).  Every attempt cleans up after itself: a
reply that never came (timeout, exhaustion) discards its pending handle,
so no id dangles in the reply map holding a session in-flight slot."""

from __future__ import annotations

import socket
import threading
import time
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np

from pbccs_tpu_torch.pipeline import Chunk
from pbccs_tpu_torch.serve import protocol

if TYPE_CHECKING:
    from pbccs_tpu_torch.resilience.retry import RetryPolicy


class ServeError(RuntimeError):
    """A structured error reply from the server.  `retry_after_ms`
    carries the server's backoff hint when the reply had one (shed /
    over-quota rejections); None otherwise."""

    def __init__(self, code: str, message: str,
                 retry_after_ms: float | None = None):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.retry_after_ms = retry_after_ms


class PendingReply:
    """Handle for one in-flight request."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._event = threading.Event()
        self._msg: dict[str, Any] | None = None
        self._gen = 0   # connection generation (set at registration)

    def _complete(self, msg: dict[str, Any]) -> None:
        self._msg = msg
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def reply(self, timeout: float | None = None,
              check: bool = True) -> dict[str, Any]:
        """The raw reply message; with check (default), error replies
        raise ServeError and a dropped connection raises ConnectionError."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"no reply for request {self.request_id!r}")
        msg = self._msg
        if check and msg.get("type") == protocol.TYPE_ERROR:
            hint = msg.get(protocol.FIELD_RETRY_AFTER)
            if not isinstance(hint, (int, float)) or isinstance(hint, bool) \
                    or hint < 0:
                hint = None
            raise ServeError(msg.get("code", "unknown"),
                             msg.get("error", ""), retry_after_ms=hint)
        if check and msg.get("type") == "__disconnected__":
            raise ConnectionError("server connection closed mid-stream")
        return msg


class CcsClient:
    """NDJSON/TCP client for `ccs serve` / `ccs router`
    (context-manager friendly)."""

    def __init__(self, host: str, port: int, timeout: float | None = None,
                 tls_ca: str | None = None, tls: bool = False,
                 auth_token: str | None = None):
        """`tls_ca` (a CA bundle path) connects over TLS and verifies
        the server against it; `tls=True` alone encrypts without
        verification (tests).  `auth_token` attaches the bearer token to
        EVERY outgoing frame -- the client-side half of the server's
        --authTokens contract."""
        self._host, self._port = host, port
        self._timeout = timeout
        self._auth_token = auth_token
        self._ssl_context = None
        if tls_ca is not None or tls:
            from pbccs_tpu_torch.serve import tenancy

            self._ssl_context = tenancy.client_ssl_context(tls_ca)
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: dict[str, PendingReply] = {}
        self._seq = 0
        self._gen = 0            # bumps on every (re)connect
        self._closed = False
        # serializes connect/reconnect (never held across a reply wait)
        self._conn_lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._reader: threading.Thread | None = None
        with self._conn_lock:
            self._open_locked()

    # ----------------------------------------------------------- plumbing

    def _open_locked(self) -> None:
        """(Re)open the transport; caller holds _conn_lock.  Any previous
        socket is closed DETERMINISTICALLY first (no half-open fd
        lingers behind a failed retry loop) and its reader joined, so
        its leftover handles fail before new ones register."""
        old_sock, old_reader = self._sock, self._reader
        self._sock = None
        if old_sock is not None:
            try:
                old_sock.close()
            except OSError:
                pass
        if old_reader is not None:
            old_reader.join(timeout=5.0)
        sock = socket.create_connection((self._host, self._port),
                                        timeout=30.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._ssl_context is not None:
            # handshake under the connect timeout; a TLS failure surfaces
            # as the same ConnectionError shape a refused connect does
            try:
                sock = self._ssl_context.wrap_socket(
                    sock, server_hostname=self._host)
            except OSError as e:  # ssl.SSLError is an OSError
                try:
                    sock.close()
                except OSError:
                    pass
                raise ConnectionError(f"TLS handshake failed: {e}") from None
        sock.settimeout(self._timeout)
        self._gen += 1
        self._sock = sock
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock, self._gen), daemon=True,
            name=f"ccs-client-reader-{self._gen}")
        self._reader.start()

    def _ensure_connected(self) -> None:
        """Reconnect when the transport died (reader exited).  Used by
        submit_with_retry between attempts; plain submits keep the
        original fail-fast behavior."""
        with self._conn_lock:
            if self._closed:
                raise ConnectionError("client is closed")
            if (self._sock is not None and self._reader is not None
                    and self._reader.is_alive()):
                return
            self._open_locked()

    def _next_id(self) -> str:
        with self._plock:
            self._seq += 1
            return f"r{self._seq}"

    def _discard(self, handle: PendingReply) -> None:
        """Drop a handle whose reply will never be consumed (timeout /
        retry exhaustion): a late reply then falls on the floor instead
        of completing into a map nobody reads, and the map cannot grow
        without bound under a retry loop."""
        with self._plock:
            self._pending.pop(handle.request_id, None)

    def _send(self, msg: dict[str, Any], handle: PendingReply) -> None:
        if self._auth_token is not None:
            # every frame authenticates (the server checks per-frame);
            # one injection point covers every verb
            msg.setdefault(protocol.FIELD_AUTH, self._auth_token)
        try:
            with self._wlock:
                # capture (sock, gen) and REGISTER under the write lock:
                # registering before it with a stale generation would let
                # a racing reconnect's leftover sweep fail this handle as
                # __disconnected__ even though the frame then goes out on
                # the NEW connection (_open_locked bumps _gen before
                # publishing the new socket, so a new sock implies the
                # matching gen here)
                sock = self._sock
                if sock is None:
                    raise OSError("no connection")
                if self._reader is not None and not self._reader.is_alive():
                    # the transport is known dead: a sendall could still
                    # "succeed" into the kernel buffer and park this
                    # handle forever (no reader will ever fail it)
                    raise OSError("connection closed")
                with self._plock:
                    handle._gen = self._gen
                    self._pending[handle.request_id] = handle
                sock.sendall(protocol.encode_msg(msg))
        except OSError as e:
            with self._plock:
                self._pending.pop(handle.request_id, None)
            raise ConnectionError(f"send failed: {e}") from None

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        try:
            with sock.makefile("rb") as rf:
                for line in rf:
                    if not line.strip():
                        continue
                    try:
                        msg = protocol.decode_line(line)
                    except protocol.ProtocolError:
                        continue  # never kill the reader on one bad frame
                    rid = msg.get("id")
                    with self._plock:
                        handle = self._pending.pop(rid, None)
                    if handle is not None:
                        handle._complete(msg)
        except OSError:
            pass
        finally:
            # fail whatever THIS connection still owes so callers
            # unblock; handles registered on a newer connection (a
            # racing reconnect) are someone else's to answer
            with self._plock:
                leftovers = [h for h in self._pending.values()
                             if h._gen <= gen]
                for h in leftovers:
                    self._pending.pop(h.request_id, None)
            for handle in leftovers:
                handle._complete({"type": "__disconnected__",
                                  "id": handle.request_id})

    # ------------------------------------------------------------- verbs

    def submit_wire(self, zmw: dict[str, Any],
                    deadline_ms: float | None = None,
                    trace: dict[str, Any] | None = None) -> PendingReply:
        """Submit an already-wire-shaped ZMW dict.  `trace` attaches a
        distributed-trace context ({"trace_id", "span_id"}) to the
        frame; when omitted and a span capture is live on THIS process,
        the calling thread's innermost span's context is attached
        automatically, so a traced load generator's requests carry their
        trace across the wire with no per-call plumbing."""
        if trace is None:
            from pbccs_tpu_torch.obs import trace as obs_trace

            trace = obs_trace.current_context()
        handle = PendingReply(self._next_id())
        msg: dict[str, Any] = {"verb": protocol.VERB_SUBMIT,
                               "id": handle.request_id, "zmw": zmw}
        if deadline_ms is not None:
            msg["deadline_ms"] = deadline_ms
        if trace is not None:
            msg[protocol.FIELD_TRACE] = trace
        self._send(msg, handle)
        return handle

    def submit_chunk(self, chunk: Chunk,
                     deadline_ms: float | None = None,
                     trace: dict[str, Any] | None = None) -> PendingReply:
        return self.submit_wire(protocol.chunk_to_wire(chunk), deadline_ms,
                                trace)

    def submit(self, zmw_id: str, reads: Sequence[str],
               snr: Sequence[float] | None = None,
               deadline_ms: float | None = None) -> PendingReply:
        """Convenience: sequences as strings, default full-pass flags."""
        snr = [8.0] * 4 if snr is None else [float(s) for s in np.asarray(snr)]
        zmw = {"id": zmw_id, "snr": snr,
               "reads": [{"seq": s} for s in reads]}
        return self.submit_wire(zmw, deadline_ms)

    def submit_with_retry(self, zmw: Chunk | dict[str, Any],
                          deadline_ms: float | None = None,
                          policy: "RetryPolicy | None" = None,
                          reply_timeout: float | None = 600.0,
                          trace: dict[str, Any] | None = None
                          ) -> dict[str, Any]:
        """Submit one ZMW, riding out `overloaded` backpressure AND
        connection loss: an overloaded rejection re-submits with
        jittered exponential backoff (resilience.retry.OVERLOADED_RETRY
        by default -- bounded attempts AND a wall deadline); a dropped
        connection reconnects and resubmits the unacknowledged payload
        under a fresh request id.  Blocks until the final reply; returns
        the reply message.  Non-retryable errors raise immediately;
        exhausted retries raise retry.RetriesExhausted from the last
        structured error, with no request id left dangling in the reply
        map in any exit path."""
        from pbccs_tpu_torch.resilience import retry as retry_mod

        policy = policy or retry_mod.OVERLOADED_RETRY
        wire = protocol.chunk_to_wire(zmw) if isinstance(zmw, Chunk) else zmw

        def attempt() -> dict[str, Any]:
            self._ensure_connected()
            # the retry attempt reuses the SAME trace context: a
            # resubmitted payload is the same logical request, and one
            # trace_id must tell its whole retry story
            handle = self.submit_wire(wire, deadline_ms, trace)
            try:
                return handle.reply(reply_timeout)
            finally:
                if not handle.done():
                    # timed out / interrupted: never leave the id parked
                    # in the reply map (it would pin a server-session
                    # in-flight slot to a reply nobody consumes)
                    self._discard(handle)

        def hint(e: BaseException) -> float | None:
            # honor the server's shed/over-quota pacing hint (seconds);
            # RetryPolicy caps + jitters it, so a hostile hint cannot
            # park the client and a fleet of clients decorrelates
            ms = getattr(e, "retry_after_ms", None)
            return ms / 1e3 if ms is not None else None

        return policy.run(
            attempt,
            # a deliberately-closed client must fail fast, not burn the
            # retry budget reconnect-looping against itself
            retry_on=lambda e: (isinstance(e, ConnectionError)
                                and not self._closed)
            or (isinstance(e, ServeError)
                and e.code == protocol.ERR_OVERLOADED),
            site="client.submit", delay_hint=hint)

    def status(self, timeout: float | None = 30.0) -> dict[str, Any]:
        handle = PendingReply(self._next_id())
        self._send({"verb": protocol.VERB_STATUS, "id": handle.request_id},
                   handle)
        return handle.reply(timeout)

    def metrics(self, timeout: float | None = 30.0) -> str:
        """Prometheus text-format metrics scrape (the `metrics` verb)."""
        handle = PendingReply(self._next_id())
        self._send({"verb": protocol.VERB_METRICS,
                    "id": handle.request_id}, handle)
        return handle.reply(timeout).get("body", "")

    def trace(self, action: str,
              timeout: float | None = 30.0) -> dict[str, Any]:
        """Start/stop a server-side span capture; a stop reply carries
        the Chrome-trace JSON under "trace"."""
        handle = PendingReply(self._next_id())
        self._send({"verb": protocol.VERB_TRACE, "id": handle.request_id,
                    "action": action}, handle)
        return handle.reply(timeout)

    def ping(self, timeout: float | None = 30.0) -> None:
        handle = PendingReply(self._next_id())
        self._send({"verb": protocol.VERB_PING, "id": handle.request_id},
                   handle)
        handle.reply(timeout)

    # ---------------------------------------------------------- lifecycle

    def close(self) -> None:
        with self._conn_lock:
            if self._closed:
                return
            self._closed = True
            sock, reader = self._sock, self._reader
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if reader is not None:
            reader.join(timeout=5.0)

    def __enter__(self) -> "CcsClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


READY_LINES = ("CCS-METRICS-READY", "CCS-SERVE-READY")


def wait_for_ready(proc, timeout_s: float, lines: list | None = None
                   ) -> dict[str, tuple[str, int]] | None:
    """Wait for a `ccs serve` child process (stdout a text pipe) to print
    CCS-SERVE-READY: {"CCS-SERVE-READY": (host, port)} plus
    "CCS-METRICS-READY" when it printed that line first, or None when it
    exits or stays silent past timeout_s.  The child's stdout is read on
    a thread of its own to its end, so a silent child cannot hold the
    caller past the bound and a chatty one never fills the pipe; every
    line read is appended to `lines` when given (the drain notice
    arrives after this returns)."""
    import queue

    found: dict[str, tuple[str, int]] = {}
    q: queue.Queue = queue.Queue()

    def drain():
        for line in proc.stdout:
            if lines is not None:
                lines.append(line)
            q.put(line)
        q.put(None)

    threading.Thread(target=drain, daemon=True,
                     name="ccs-serve-stdout").start()
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            line = q.get(timeout=max(deadline - time.monotonic(), 0.0))
        except queue.Empty:
            return None
        if line is None:
            return None
        parts = line.split()
        if len(parts) == 3 and parts[0] in READY_LINES:
            found[parts[0]] = (parts[1], int(parts[2]))
            if parts[0] == "CCS-SERVE-READY":
                return found
