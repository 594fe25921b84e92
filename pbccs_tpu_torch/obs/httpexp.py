"""Stdlib-HTTP Prometheus scrape endpoint (`--metricsPort`).

Port of pbccs_tpu.obs.httpexp, unchanged (no device code).

The NDJSON `metrics` verb serves tooling that already speaks the serve
protocol; a real Prometheus deployment wants a plain HTTP GET.  This is
the thinnest possible adapter: a ThreadingHTTPServer on its own daemon
thread serving

    GET /metrics   the render callback's text exposition
                   (`ccs serve` renders its process registry; `ccs
                   router` renders the FEDERATED fleet exposition, so
                   one scrape target sees every replica)
    GET /healthz   liveness + readiness: 200 "ok" while the health
                   callback (engine/router `accepting`) says yes,
                   503 "draining" once it says no -- a load balancer
                   sees a draining replica before its socket closes

No dependencies.  With the multi-tenant edge's `--tlsCert/--tlsKey`
(serve/tenancy.py), the scrape endpoint serves HTTPS with the SAME
certificate as the NDJSON front door -- a TLS'd fleet has no plaintext
surface -- and the per-connection TLS handshake runs in the handler
thread (never the accept loop), so a plaintext scraper probing the
HTTPS port costs one thread a failed handshake, not the endpoint.
Render errors return 500 with the error text rather than killing the
serving thread, and a scrape racing server shutdown gets a connection
error on its own socket, never a traceback out of the server.
"""

from __future__ import annotations

import http.server
import ssl
import threading
from typing import Callable


class _Handler(http.server.BaseHTTPRequestHandler):
    # set per-server via functools.partial-style subclassing in
    # start_metrics_http; annotated here for clarity
    render: Callable[[], str]
    health: Callable[[], bool] | None

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.split("?", 1)[0] == "/healthz":
            # the health callback keeps /healthz honest during a drain:
            # the engine stops accepting before its socket ever closes,
            # and the probe must say so.  A raising callback reads as
            # not-healthy (a dying process must not probe "ok").
            try:
                ok = self.health is None or bool(type(self).health())
            except Exception:  # noqa: BLE001 -- see comment above
                ok = False
            body = b"ok\n" if ok else b"draining\n"
            self.send_response(200 if ok else 503)
            self.send_header("Content-Type", "text/plain")
        elif self.path.split("?", 1)[0] == "/metrics":
            try:
                body = type(self).render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
            except Exception as e:  # noqa: BLE001 -- a render error must
                # answer 500, never kill the scrape thread
                body = f"metrics render failed: {e!r}\n".encode()
                self.send_response(500)
                self.send_header("Content-Type", "text/plain")
        else:
            body = b"not found\n"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def handle_one_request(self):
        try:
            super().handle_one_request()
        except (OSError, ValueError):
            # a request racing server shutdown (listening socket closed,
            # fd torn down mid-reply) fails ITS connection only -- the
            # client sees a reset, the serving thread never tracebacks
            self.close_connection = True

    def log_message(self, fmt, *args):  # scrapes are not log traffic
        pass


class _TLSHTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer whose per-connection TLS handshake happens in
    the handler thread: finish_request (already off the accept loop via
    ThreadingMixIn) wraps the socket, and a failed handshake -- a
    plaintext client, a bad cert probe, a stall -- quietly closes that
    one connection.  No traceback, no accept-loop stall."""

    ssl_context: ssl.SSLContext | None = None
    handshake_timeout_s = 10.0

    def finish_request(self, request, client_address):
        ctx = self.ssl_context
        if ctx is not None:
            request.settimeout(self.handshake_timeout_s)
            try:
                request = ctx.wrap_socket(request, server_side=True)
            except (OSError, ssl.SSLError):
                try:
                    request.close()
                except OSError:
                    pass
                return
            request.settimeout(None)
        try:
            super().finish_request(request, client_address)
        finally:
            # wrap_socket detached the fd from the socket object the
            # server will shutdown_request(); close the wrapped one here
            # or it leaks until GC
            try:
                request.close()
            except OSError:
                pass


def start_metrics_http(render: Callable[[], str], host: str = "127.0.0.1",
                       port: int = 0,
                       health: Callable[[], bool] | None = None,
                       ssl_context: ssl.SSLContext | None = None):
    """Serve `render()` on GET /metrics in a daemon thread; returns the
    started server (``.server_port`` carries the bound port for port=0,
    ``.shutdown()`` stops it).  `health` (optional) backs /healthz:
    True -> 200 "ok", False/raise -> 503 "draining".  `ssl_context`
    (optional) serves HTTPS instead of HTTP."""
    handler = type("MetricsHandler", (_Handler,),
                   {"render": staticmethod(render),
                    "health": staticmethod(health) if health is not None
                    else None})
    server = _TLSHTTPServer((host, port), handler)
    server.ssl_context = ssl_context
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name=f"ccs-metrics-http-{server.server_port}").start()
    return server
