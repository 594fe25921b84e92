"""The port's multi-tenant edge (pbccs_tpu_torch/serve/tenancy.py) on
the CPU.

Counterparts of tests/test_tenancy.py's cases that need no router (the
router tier is not ported): TenantDirectory parsing, the resolve_tenant
spoofing rule, FairQueue's weighted-DRR admission, the BurnMeter,
RetryPolicy's server-hint backoff, an authenticated `ccs serve` front
door (missing/bad token, spoofing), TLS (the local openssl makes a
self-signed certificate; handshake aborts, a pinned CA, the HTTPS
metrics endpoint), the online token-map reload and per-tenant shed
rates.  The serve stacks run stub prep/polish functions on device="cpu"
engines.  Parity with pbccs_tpu: both directories accept and refuse the
same token files with the same tenants, and both fair queues admit and
drain the same scripted traffic in the same order.  Every wait has a
bound.
"""

import json
import socket
import subprocess
import time

import pytest

from pbccs_tpu_torch.obs.metrics import MeasurementScope, default_registry
from pbccs_tpu_torch.resilience.retry import RetriesExhausted, RetryPolicy
from pbccs_tpu_torch.serve import protocol, tenancy
from pbccs_tpu_torch.serve.client import CcsClient
from pbccs_tpu_torch.serve.server import CcsServer
from pbccs_tpu_torch.serve.tenancy import (
    BurnMeter,
    FairQueue,
    Tenant,
    TenantDirectory,
    resolve_tenant,
)
from tests.test_torch_serve import stub_engine

ZMW = {"id": "m/1", "reads": [{"seq": "ACGTACGT"}] * 4}


def wait_until(fn, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(step)
    return False


# ---------------------------------------------------------------- helpers


def directory(*tenants):
    return TenantDirectory(list(tenants))


def edge_directory():
    """The serve-tier cast: two ordinary tenants + the trusted router."""
    return directory(
        Tenant("alpha", "tok-alpha"),
        Tenant("beta", "tok-beta"),
        Tenant("_router", "tok-router", priority=0, trusted=True))


def wire_call(port, frames, n_replies=1, timeout=5.0):
    """Raw NDJSON exchange: send `frames`, read `n_replies` replies."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.settimeout(timeout)
        for f in frames:
            s.sendall(protocol.encode_msg(f))
        rf = s.makefile("rb")
        return [protocol.decode_line(rf.readline()) for _ in range(n_replies)]


@pytest.fixture(scope="session")
def tls_certs(tmp_path_factory):
    """Self-signed EC cert (its own CA: issuer == subject)."""
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
         "ec_paramgen_curve:prime256v1", "-nodes", "-keyout", key,
         "-out", cert, "-days", "2", "-subj", "/CN=localhost"],
        check=True, capture_output=True)
    return cert, key


# ------------------------------------------------------------- token file


class TestTokenFile:
    def write(self, tmp_path, doc):
        p = tmp_path / "tokens.json"
        p.write_text(doc if isinstance(doc, str) else json.dumps(doc))
        return str(p)

    def test_parse_defaults_and_overrides(self, tmp_path):
        d = TenantDirectory.from_file(self.write(tmp_path, {"tenants": [
            {"name": "a", "token": "ta"},
            {"name": "r", "token": "tr", "max_inflight": 2, "priority": 0,
             "weight": 3, "trusted": True}]}))
        a, r = d.get("a"), d.get("r")
        assert (a.max_inflight, a.priority, a.weight, a.trusted) == \
            (8, 1, 1, False)
        assert (r.max_inflight, r.priority, r.weight, r.trusted) == \
            (2, 0, 3, True)
        assert d.authenticate("ta") is a
        assert d.authenticate("nope") is None
        assert d.authenticate("") is None
        assert d.authenticate(42) is None
        assert d.authenticate("x" * (tenancy.TOKEN_MAX_CHARS + 1)) is None

    @pytest.mark.parametrize("doc", [
        "not json",
        {"tenants": {}},
        {"tenants": ["row"]},
        {"tenants": [{"token": "t"}]},
        {"tenants": [{"name": "a"}]},
        {"tenants": [{"name": "a", "token": ""}]},
        {"tenants": [{"name": "a", "token": "x" * 300}]},
        {"tenants": [{"name": "a", "token": "t", "max_inflight": 0}]},
        {"tenants": [{"name": "a", "token": "t", "priority": -1}]},
        {"tenants": [{"name": "a", "token": "t", "weight": 0}]},
        {"tenants": [{"name": "a", "token": "t", "trusted": "yes"}]},
        {"tenants": [{"name": "a", "token": "t", "priority": True}]},
        {"tenants": []},
        {"tenants": [{"name": "a", "token": "t"},
                     {"name": "a", "token": "u"}]},
        {"tenants": [{"name": "a", "token": "t"},
                     {"name": "b", "token": "t"}]},
    ])
    def test_malformed_files_raise(self, tmp_path, doc):
        with pytest.raises(ValueError):
            TenantDirectory.from_file(self.write(tmp_path, doc))

    def test_resolve_tenant_spoofing_rule(self):
        alpha = Tenant("alpha", "ta")
        router = Tenant("_router", "tr", trusted=True)
        # open front door: no identity at all
        assert resolve_tenant(None, {"name": "beta"}) is None
        # an ordinary tenant cannot impersonate another
        assert resolve_tenant(alpha, {"name": "beta"}) == "alpha"
        # the trusted link forwards the original submitter
        assert resolve_tenant(router, {"name": "beta"}) == "beta"
        assert resolve_tenant(router, None) == "_router"


# ------------------------------------------------------------- fair queue


class TestFairQueue:
    def test_admission_verdicts(self):
        fq = FairQueue(directory(Tenant("a", "t", max_inflight=1)),
                       queue_depth=2)
        assert fq.try_admit("a", "r1") == "dispatch"
        assert fq.try_admit("a", "r2") == "queued"
        assert fq.try_admit("a", "r3") == "queued"
        assert fq.try_admit("a", "r4") == "rejected"
        # nothing fits while the slot is held
        assert fq.drain() == []
        fq.complete("a")
        assert fq.drain() == [("a", "r2")]
        row = fq.rows()[0]
        assert (row["inflight"], row["queued"], row["completed"],
                row["queued_total"], row["rejected"]) == (1, 1, 1, 2, 1)

    def test_weighted_drr_drain_order(self):
        fq = FairQueue(directory(Tenant("a", "ta", max_inflight=99),
                                 Tenant("b", "tb", max_inflight=99,
                                        weight=2)),
                       queue_depth=99, quantum=1)
        # park a backlog directly (quota high, so drain order is pure DRR)
        for st in fq._states.values():
            st.inflight = st.tenant.max_inflight
        for i in range(6):
            assert fq.try_admit("a", f"a{i}") == "queued"
            assert fq.try_admit("b", f"b{i}") == "queued"
        for st in fq._states.values():
            st.inflight = 0
        order = [name for name, _ in fq.drain()]
        # weight 2 drains twice per round: a,b,b repeating
        assert order[:6] == ["a", "b", "b", "a", "b", "b"]
        assert order.count("a") == 6 and order.count("b") == 6

    def test_flush_empties_queues(self):
        fq = FairQueue(directory(Tenant("a", "t", max_inflight=1)),
                       queue_depth=8)
        fq.try_admit("a", "r1")
        fq.try_admit("a", "r2")
        fq.try_admit("a", "r3")
        assert fq.flush() == [("a", "r2"), ("a", "r3")]
        assert fq.rows()[0]["queued"] == 0

    def test_shed_accounting(self):
        fq = FairQueue(directory(Tenant("a", "t")))
        fq.record_shed("a")
        fq.record_shed("a")
        assert fq.rows()[0]["shed"] == 2


class TestBurnMeter:
    def test_rate_from_deltas(self):
        clock = [0.0]
        m = BurnMeter(window_s=30.0, clock=lambda: clock[0])
        assert m.rate() == 0.0
        m.observe("r1", {"requests": 0, "violations": 0})
        m.observe("r1", {"requests": 10, "violations": 4})
        assert m.rate() == pytest.approx(0.4)
        m.observe("r1", {"requests": 20, "violations": 4})
        assert m.rate() == pytest.approx(0.2)

    def test_window_expiry(self):
        clock = [0.0]
        m = BurnMeter(window_s=10.0, clock=lambda: clock[0])
        m.observe("r1", {"requests": 0, "violations": 0})
        m.observe("r1", {"requests": 10, "violations": 10})
        assert m.rate() == 1.0
        clock[0] = 11.0
        assert m.rate() == 0.0

    def test_restart_rebaselines(self):
        clock = [0.0]
        m = BurnMeter(window_s=30.0, clock=lambda: clock[0])
        m.observe("r1", {"requests": 0, "violations": 0})
        m.observe("r1", {"requests": 100, "violations": 0})
        # counters moved backwards: a restart, not -98 violations
        m.observe("r1", {"requests": 2, "violations": 1})
        assert m.rate() == 0.0
        m.observe("r1", {"requests": 4, "violations": 2})
        assert m.rate() == pytest.approx(1 / 102)

    def test_malformed_slo_ignored(self):
        m = BurnMeter()
        m.observe("r1", None)
        m.observe("r1", "slo")
        m.observe("r1", {"requests": "many", "violations": 1})
        assert m.rate() == 0.0


# ------------------------------------------------------------ retry hints


class TestRetryHint:
    def run_failing(self, policy, hint):
        sleeps = []

        def boom():
            raise RuntimeError("shed")

        with pytest.raises(RetriesExhausted):
            policy.run(boom, retry_on=lambda e: True, sleep=sleeps.append,
                       delay_hint=lambda e: hint)
        return sleeps

    def test_hint_overrides_schedule(self):
        policy = RetryPolicy(max_attempts=3, base_delay_s=0.001,
                             max_delay_s=0.5, jitter=0.0)
        assert self.run_failing(policy, 0.2) == [0.2, 0.2]

    def test_hostile_hint_capped(self):
        policy = RetryPolicy(max_attempts=3, base_delay_s=0.001,
                             max_delay_s=0.5, jitter=0.0)
        assert self.run_failing(policy, 3600.0) == [0.5, 0.5]

    def test_no_hint_keeps_exponential(self):
        policy = RetryPolicy(max_attempts=3, base_delay_s=0.001,
                             max_delay_s=0.5, jitter=0.0)
        assert self.run_failing(policy, None) == \
            pytest.approx([0.001, 0.002])


# ------------------------------------------------- authenticated ccs serve


@pytest.fixture
def auth_stack():
    eng = stub_engine(max_batch=2, max_wait_ms=20.0, max_pending=16)
    eng.start()
    srv = CcsServer(eng, port=0, tenants=edge_directory())
    srv.start()
    yield srv
    srv.shutdown()
    eng.close()


class TestServeAuth:
    def test_missing_token_rejected_session_survives(self, auth_stack):
        scope = MeasurementScope(default_registry())
        frames = [
            {"verb": "submit", "id": "s1", "zmw": ZMW},
            {"verb": "submit", "id": "s2", "zmw": ZMW,
             "auth": "tok-alpha"},
        ]
        r1, r2 = wire_call(auth_stack.port, frames, n_replies=2)
        assert r1["type"] == "error"
        assert r1["code"] == protocol.ERR_UNAUTHORIZED
        assert r1["id"] == "s1"
        # the same session works once it presents the token
        assert r2["type"] == "result" and r2["id"] == "s2"
        assert scope.counter_value("ccs_tenant_auth_failures_total",
                                   reason="missing_token") == 1

    def test_bad_token_rejected(self, auth_stack):
        scope = MeasurementScope(default_registry())
        (r,) = wire_call(auth_stack.port,
                         [{"verb": "status", "id": "s1",
                           "auth": "tok-wrong"}])
        assert r["code"] == protocol.ERR_UNAUTHORIZED
        assert scope.counter_value("ccs_tenant_auth_failures_total",
                                   reason="bad_token") == 1

    def test_every_verb_is_gated(self, auth_stack):
        for verb in ("status", "metrics", "ping", "submit"):
            (r,) = wire_call(auth_stack.port,
                             [{"verb": verb, "id": "x", "zmw": ZMW}])
            assert r["code"] == protocol.ERR_UNAUTHORIZED, verb

    def test_client_auth_token_rides_every_frame(self, auth_stack):
        scope = MeasurementScope(default_registry())
        with CcsClient("127.0.0.1", auth_stack.port,
                       auth_token="tok-alpha") as cli:
            reply = cli.submit("m/77", ["ACGTACGT"] * 4).reply(10.0)
            assert reply["type"] == "result"
            assert cli.status(10.0)["type"] == "status"
        assert scope.counter_value("ccs_tenant_requests_total",
                                   tenant="alpha") == 1

    def test_untrusted_tenant_field_ignored(self, auth_stack):
        scope = MeasurementScope(default_registry())
        (r,) = wire_call(auth_stack.port,
                         [{"verb": "submit", "id": "s1", "zmw": ZMW,
                           "auth": "tok-alpha",
                           "tenant": {"name": "beta"}}])
        assert r["type"] == "result"
        # attributed to the TOKEN's tenant, not the spoofed wire field
        assert scope.counter_value("ccs_tenant_requests_total",
                                   tenant="alpha") == 1
        assert scope.counter_value("ccs_tenant_requests_total",
                                   tenant="beta") == 0

    def test_trusted_token_forwards_tenant(self, auth_stack):
        scope = MeasurementScope(default_registry())
        (r,) = wire_call(auth_stack.port,
                         [{"verb": "submit", "id": "s1", "zmw": ZMW,
                           "auth": "tok-router",
                           "tenant": {"name": "beta"}}])
        assert r["type"] == "result"
        assert scope.counter_value("ccs_tenant_requests_total",
                                   tenant="beta") == 1


class TestServeTLS:
    @pytest.fixture
    def tls_stack(self, tls_certs):
        cert, key = tls_certs
        eng = stub_engine(max_batch=2, max_wait_ms=20.0, max_pending=16)
        eng.start()
        srv = CcsServer(eng, port=0,
                        ssl_context=tenancy.server_ssl_context(cert, key))
        srv.start()
        yield srv, cert
        srv.shutdown()
        eng.close()

    def test_tls_round_trip(self, tls_stack):
        srv, cert = tls_stack
        with CcsClient("127.0.0.1", srv.port, tls_ca=cert) as cli:
            reply = cli.submit("m/1", ["ACGTACGT"] * 4).reply(10.0)
            assert reply["type"] == "result"

    def test_plaintext_client_aborts_cleanly(self, tls_stack):
        srv, cert = tls_stack
        scope = MeasurementScope(default_registry())
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=5.0) as s:
            s.settimeout(5.0)
            s.sendall(protocol.encode_msg(
                {"verb": "status", "id": "s1"}))
            # the handshake fails server-side; no frame is ever
            # accepted -- the socket just dies (FIN or RST)
            try:
                assert s.recv(4096) == b""
            except OSError:
                pass
        assert wait_until(lambda: scope.counter_value(
            "ccs_serve_session_aborts_total", cause="tls_handshake") == 1)
        # the listener survives for real TLS clients
        with CcsClient("127.0.0.1", srv.port, tls_ca=cert) as cli:
            assert cli.status(10.0)["type"] == "status"

    def test_wrong_ca_rejected_client_side(self, tls_stack, tmp_path):
        srv, _cert = tls_stack
        other = tmp_path / "other-ca.pem"
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
             "ec_paramgen_curve:prime256v1", "-nodes", "-keyout",
             str(tmp_path / "other-key.pem"), "-out", str(other),
             "-days", "2", "-subj", "/CN=evil"],
            check=True, capture_output=True)
        with pytest.raises(ConnectionError, match="TLS handshake failed"):
            CcsClient("127.0.0.1", srv.port, tls_ca=str(other))

    def test_metrics_endpoint_tls_only(self, tls_certs):
        from pbccs_tpu_torch.obs.httpexp import start_metrics_http

        cert, key = tls_certs
        httpd = start_metrics_http(
            lambda: "ccs_test_metric 1\n", port=0,
            ssl_context=tenancy.server_ssl_context(cert, key))
        port = httpd.server_port
        try:
            # plaintext scrape: the handshake kills the connection
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=5.0) as s:
                s.settimeout(5.0)
                s.sendall(b"GET /metrics HTTP/1.0\r\n\r\n")
                try:
                    assert b"200 OK" not in s.recv(4096)
                except OSError:
                    pass
            # TLS scrape works against the pinned CA
            ctx = tenancy.client_ssl_context(cert)
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=5.0) as s:
                with ctx.wrap_socket(s, server_hostname="localhost") as w:
                    w.sendall(b"GET /metrics HTTP/1.0\r\n\r\n")
                    data = b""
                    while True:
                        chunk = w.recv(4096)
                        if not chunk:
                            break
                        data += chunk
            assert b"200 OK" in data and b"ccs_test_metric" in data
        finally:
            httpd.shutdown()


# ------------------------------------------- online token-map reload

def write_tokens(path, rows):
    path.write_text(json.dumps({"tenants": rows}))
    return str(path)


class TestReloadableDirectory:
    """ReloadableTenantDirectory: the --authTokens file followed online
    (SIGHUP or mtime change) without a rolling restart."""

    def make(self, tmp_path, rows, **kw):
        p = tmp_path / "tokens.json"
        write_tokens(p, rows)
        clock = [0.0]
        rd = tenancy.ReloadableTenantDirectory(
            str(p), clock=lambda: clock[0], **kw)
        return rd, p, clock

    def test_first_load_fails_loud(self, tmp_path):
        p = tmp_path / "tokens.json"
        p.write_text("{broken")
        with pytest.raises(ValueError):
            tenancy.ReloadableTenantDirectory(str(p))

    def test_mtime_reload_revokes_and_admits(self, tmp_path):
        rd, p, clock = self.make(
            tmp_path, [{"name": "a", "token": "ta"}])
        assert rd.authenticate("ta").name == "a"
        time.sleep(0.01)
        write_tokens(p, [{"name": "b", "token": "tb"}])
        # inside the recheck window the old map still answers
        assert rd.authenticate("ta") is not None
        clock[0] = 5.0
        assert rd.authenticate("ta") is None      # revoked
        assert rd.authenticate("tb").name == "b"  # admitted
        assert rd.get("b") is not None and rd.get("a") is None

    def test_malformed_reload_keeps_previous_map(self, tmp_path):
        scope = MeasurementScope(default_registry())
        rd, p, clock = self.make(
            tmp_path, [{"name": "a", "token": "ta"}])
        time.sleep(0.01)
        p.write_text("{broken")
        clock[0] = 5.0
        assert rd.authenticate("ta").name == "a"
        assert scope.counter_value("ccs_tenant_map_reloads_total",
                                   outcome="error") == 1
        # a later GOOD edit recovers
        time.sleep(0.01)
        write_tokens(p, [{"name": "a", "token": "ta2"}])
        clock[0] = 10.0
        assert rd.authenticate("ta") is None
        assert rd.authenticate("ta2").name == "a"

    def test_sighup_bypasses_recheck_window(self, tmp_path):
        import signal
        rd, p, clock = self.make(
            tmp_path, [{"name": "a", "token": "ta"}])
        prev = signal.getsignal(signal.SIGHUP)
        try:
            assert rd.install_sighup() is True
            time.sleep(0.01)
            write_tokens(p, [{"name": "b", "token": "tb"}])
            # clock never advances: only the signal can trigger reload
            assert rd.authenticate("tb") is None
            signal.raise_signal(signal.SIGHUP)
            assert rd.authenticate("tb").name == "b"
        finally:
            signal.signal(signal.SIGHUP, prev)

    def test_listener_and_fair_queue_refresh(self, tmp_path):
        rd, p, clock = self.make(
            tmp_path, [{"name": "a", "token": "ta", "max_inflight": 1}])
        fq = FairQueue(rd)
        rd.add_listener(fq.refresh)
        assert fq.try_admit("a", 1) == "dispatch"
        assert fq.try_admit("a", 2) == "queued"   # quota 1
        time.sleep(0.01)
        write_tokens(p, [
            {"name": "a", "token": "ta", "max_inflight": 4},
            {"name": "b", "token": "tb"}])
        clock[0] = 5.0
        rd.maybe_reload()
        # new tenant has admission state (no KeyError) and the existing
        # tenant adopted the raised quota without losing its counters
        assert fq.try_admit("b", 3) == "dispatch"
        assert fq.try_admit("a", 4) == "dispatch"
        rows = {r["name"]: r for r in fq.rows()}
        assert rows["a"]["max_inflight"] == 4
        assert rows["a"]["queued"] == 1           # parked item survives

    def test_token_revoked_mid_session(self, tmp_path):
        """Regression: revoking a token must reject the session's NEXT
        frame while the session itself (and its in-flight identity)
        survives the reload."""
        p = tmp_path / "tokens.json"
        write_tokens(p, [{"name": "alpha", "token": "tok-alpha"},
                         {"name": "beta", "token": "tok-beta"}])
        clock = [0.0]
        rd = tenancy.ReloadableTenantDirectory(
            str(p), clock=lambda: clock[0])
        eng = stub_engine(max_batch=2, max_wait_ms=20.0, max_pending=16)
        eng.start()
        srv = CcsServer(eng, port=0, tenants=rd)
        srv.start()
        try:
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=5.0) as s:
                s.settimeout(5.0)
                rf = s.makefile("rb")

                def call(frame):
                    s.sendall(protocol.encode_msg(frame))
                    return protocol.decode_line(rf.readline())

                r = call({"verb": "submit", "id": "s1", "zmw": ZMW,
                          "auth": "tok-alpha"})
                assert r["type"] == "result"
                time.sleep(0.01)
                write_tokens(p, [{"name": "beta", "token": "tok-beta"}])
                clock[0] = 5.0
                # same session, same token: the revocation bites on the
                # next frame...
                r = call({"verb": "submit", "id": "s2", "zmw": ZMW,
                          "auth": "tok-alpha"})
                assert r["type"] == "error"
                assert r["code"] == protocol.ERR_UNAUTHORIZED
                # ...but the session survives and a still-valid token
                # keeps working over it
                r = call({"verb": "submit", "id": "s3", "zmw": ZMW,
                          "auth": "tok-beta"})
                assert r["type"] == "result"
        finally:
            srv.shutdown()
            eng.close()


# --------------------------------------------- per-tenant SLO burn rate


class TestPerTenantShedRate:
    def test_token_file_round_trip(self, tmp_path):
        p = tmp_path / "tokens.json"
        write_tokens(p, [
            {"name": "a", "token": "ta", "shed_burn_rate": 0.5},
            {"name": "b", "token": "tb"}])
        d = TenantDirectory.from_file(str(p))
        assert d.get("a").shed_burn_rate == 0.5
        assert d.get("b").shed_burn_rate is None

    @pytest.mark.parametrize("bad", [-0.1, 1.5, "half", True])
    def test_bad_rates_rejected(self, tmp_path, bad):
        p = tmp_path / "tokens.json"
        write_tokens(p, [{"name": "a", "token": "ta",
                          "shed_burn_rate": bad}])
        with pytest.raises(ValueError, match="shed_burn_rate"):
            TenantDirectory.from_file(str(p))


# ------------------------------------------------ parity with pbccs_tpu

TOKEN_DOCS = [
    {"tenants": [{"name": "a", "token": "ta"},
                 {"name": "r", "token": "tr", "max_inflight": 2,
                  "priority": 0, "weight": 3, "trusted": True,
                  "shed_burn_rate": 0.25}]},
    {"tenants": [{"name": "a", "token": "t", "weight": 0}]},
    {"tenants": [{"name": "a", "token": "t"}, {"name": "b", "token": "t"}]},
    {"tenants": [{"name": "a", "token": "x" * 300}]},
    "not json",
]


@pytest.mark.parametrize("doc", TOKEN_DOCS,
                         ids=["valid", "zero_weight", "shared_token",
                              "long_token", "not_json"])
def test_token_files_parse_as_pbccs_tpu(tmp_path, doc):
    """Both TenantDirectory parsers accept the same files with the same
    tenants and refuse the same ones."""
    from pbccs_tpu.serve.tenancy import TenantDirectory as JDirectory

    p = tmp_path / "tokens.json"
    p.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    outcomes = []
    for cls in (TenantDirectory, JDirectory):
        try:
            d = cls.from_file(str(p))
        except ValueError:
            outcomes.append("refused")
            continue
        outcomes.append(sorted(
            (t.name, t.token, t.max_inflight, t.priority, t.weight,
             t.trusted, t.shed_burn_rate)
            for t in (d.get(n) for n in ("a", "b", "r")) if t is not None))
    assert outcomes[0] == outcomes[1]


def test_fair_queue_admits_and_drains_as_pbccs_tpu():
    """The same scripted traffic through both fair queues: the same
    verdicts, drain order and per-tenant rows."""
    from pbccs_tpu.serve import tenancy as jtenancy

    def run(mod):
        d = mod.TenantDirectory([
            mod.Tenant("a", "ta", max_inflight=1),
            mod.Tenant("b", "tb", max_inflight=2, weight=2),
            mod.Tenant("c", "tc", max_inflight=1, weight=3)])
        fq = mod.FairQueue(d, queue_depth=3, quantum=1)
        log = []
        for i in range(12):
            name = "abc"[i % 3] if i % 4 else "b"
            log.append(fq.try_admit(name, f"{name}{i}"))
            if i % 5 == 4:
                fq.complete(name)
                log.append(fq.drain())
        fq.record_shed("c")
        return log, fq.rows(), fq.flush()

    assert run(tenancy) == run(jtenancy)
