"""The port's `ccs top` (pbccs_tpu_torch/obs/console.py) on the CPU.

Counterparts of every case of tests/test_console.py: fleet-view assembly
from synthetic samples, and a live --once --format json frame over a
real 2-replica router fleet (device="cpu" engines with stub prep and
polish) with one replica killed mid-poll (the absent contract).  Then
the view's parity with pbccs_tpu's console on the same samples, and
`ccs top` / `ccs roofline --target` through the port's CLI.  Every wait
has a bound."""

import json
import time

import numpy as np
import pytest

from pbccs_tpu_torch.obs import console
from pbccs_tpu_torch.serve.client import CcsClient


def wait_until(fn, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(step)
    return False


# ------------------------------------------------- fleet_view (synthetic)

def serve_sample(t, completed, pending=3.0, in_flight=1.0,
                 slo=(10.0, 2.0)):
    metrics = {
        ("ccs_serve_completed_total", ()): completed,
        ("ccs_serve_pending", ()): pending,
        ("ccs_serve_in_flight_zmws", ()): in_flight,
        ("ccs_slo_requests_total", ()): slo[0],
        ("ccs_slo_violations_total", ()): slo[1],
        ("ccs_refine_slot_occupancy", ()): 0.5,
        ("ccs_refine_converged_fraction", ()): 0.25,
        ("ccs_refine_padding_waste", ()): 0.125,
    }
    return {"t": t, "metrics": metrics,
            "status": {"engine": "ccs-serve", "accepting": True,
                       "pending": int(pending), "completed": 7}}


class TestFleetView:
    def test_serve_target_rates_and_depths(self):
        prev = serve_sample(10.0, completed=5.0, slo=(10.0, 2.0))
        cur = serve_sample(12.0, completed=9.0, slo=(14.0, 3.0))
        view = console.fleet_view(cur, prev, "x:1")
        assert view["engine"] == "ccs-serve"
        (row,) = view["replicas"]
        assert not row["absent"]
        assert row["throughput_zmws_per_sec"] == 2.0   # 4 done / 2 s
        assert row["queue_depth"] == 2                 # pending - inflight
        assert row["slo"]["violation_rate"] == pytest.approx(3 / 14,
                                                             abs=1e-6)
        assert row["slo"]["window_burn_rate"] == pytest.approx(1 / 4)
        assert row["refine"]["slot_occupancy"] == 0.5
        assert row["refine"]["padding_waste"] == 0.125

    def test_first_frame_has_no_rate_but_all_fields(self):
        view = console.fleet_view(serve_sample(10.0, 5.0), None, "x:1")
        (row,) = view["replicas"]
        assert row["throughput_zmws_per_sec"] is None
        assert row["queue_depth"] == 2

    def test_router_target_splits_replicas_and_marks_absent(self):
        metrics = {
            ("ccs_serve_completed_total",
             (("replica", "a:1"),)): 6.0,
            ("ccs_serve_pending", (("replica", "a:1"),)): 2.0,
            ("ccs_serve_in_flight_zmws", (("replica", "a:1"),)): 0.0,
        }
        status = {"engine": "ccs-router", "accepting": True,
                  "pending": 2, "routed": 9, "completed": 7,
                  "failovers": 1, "deduped": 0,
                  "replicas": [
                      {"replica": "a:1", "connected": True,
                       "healthy": True, "draining": False,
                       "inflight": 2},
                      {"replica": "b:2", "connected": False,
                       "healthy": False, "draining": False,
                       "inflight": 0},
                  ]}
        view = console.fleet_view(
            {"t": 5.0, "status": status, "metrics": metrics}, None,
            "r:9")
        rows = {r["replica"]: r for r in view["replicas"]}
        assert not rows["a:1"]["absent"]
        assert rows["a:1"]["queue_depth"] == 2
        # killed replica: absent row, never a crash
        assert rows["b:2"]["absent"] is True
        assert view["fleet"]["failovers"] == 1

    def test_histogram_bucket_lines_do_not_pollute_sums(self):
        metrics = {
            ("ccs_serve_completed_total", ()): 4.0,
            ("ccs_serve_request_latency_seconds_bucket",
             (("le", "0.1"),)): 99.0,
        }
        row = console._replica_row(None, metrics, None, None)
        assert row["completed"] == 4

    def test_render_text_handles_absent_and_none(self):
        view = {"target": "x:1", "engine": "ccs-router",
                "fleet": {"pending": 0, "completed": 0, "failovers": 0,
                          "accepting": True},
                "replicas": [
                    {"replica": "a:1", "absent": True},
                    {"replica": "b:2", "absent": False, "slo": {},
                     "refine": {}, "queue_depth": 0,
                     "in_flight_zmws": 0,
                     "throughput_zmws_per_sec": None},
                ]}
        text = console.render_text(view)
        assert "(absent)" in text and "b:2" in text


# ---------------------------------------------------- live fleet (--once)

def stub_serve_stack():
    from pbccs_tpu_torch.pipeline import Failure, PreparedZmw
    from pbccs_tpu_torch.serve.engine import CcsEngine, ServeConfig
    from pbccs_tpu_torch.serve.server import CcsServer

    def prep(chunk, settings):
        return None, PreparedZmw(chunk, np.zeros(64, np.int8), [],
                                 len(chunk.reads), 0, 0.0)

    def polish(preps, settings):
        return [(Failure.SUCCESS, None) for _ in preps]

    eng = CcsEngine(config=ServeConfig(max_batch=1, max_wait_ms=20.0),
                    prep_fn=prep, polish_fn=polish, device="cpu").start()
    srv = CcsServer(eng, port=0).start()
    return eng, srv


ZMW = {"id": "m/1", "reads": [{"seq": "ACGTACGT"}] * 4}


class TestTopLiveFleet:
    def test_once_json_two_replicas_then_kill_one(self, capsys):
        from pbccs_tpu_torch.obs import flight
        from pbccs_tpu_torch.serve.router import (CcsRouter, RouterConfig,
                                            RouterServer)

        # real refine gauges so the frame carries occupancy figures
        flight.record_round("console-test", 0, live=3, n_zmws=4, z=8)

        eng1, srv1 = stub_serve_stack()
        eng2, srv2 = stub_serve_stack()
        router = CcsRouter(
            [f"127.0.0.1:{srv1.port}", f"127.0.0.1:{srv2.port}"],
            RouterConfig(health_interval_s=0.2)).start()
        server = RouterServer(router, port=0).start()
        try:
            with CcsClient(server.host, server.port) as cli:
                for i in range(4):
                    assert cli.submit_wire(
                        dict(ZMW, id=f"m/{i}")).reply(10.0)

            rc = console.run_top(
                [f"{server.host}:{server.port}", "--once",
                 "--format", "json", "--interval", "0.3"])
            assert rc == 0
            view = json.loads(capsys.readouterr().out)
            assert view["engine"] == "ccs-router"
            assert len(view["replicas"]) == 2
            for row in view["replicas"]:
                assert row["absent"] is False
                # the acceptance quartet: throughput, queue depth, SLO
                # burn, refine occupancy -- all present per replica
                assert row["throughput_zmws_per_sec"] is not None
                assert "queue_depth" in row
                assert "violation_rate" in row["slo"]
                assert row["refine"]["slot_occupancy"] is not None

            # kill replica 2 mid-poll: the next frame marks it absent
            # (degradation), the live replica keeps reporting
            eng2.close(drain=False)
            srv2.shutdown()
            name2 = f"127.0.0.1:{srv2.port}"
            assert wait_until(lambda: any(
                r["replica"] == name2 and not r["connected"]
                for r in router.status()["replicas"]))
            view2, _ = console.top_frame(
                server.host, server.port,
                f"{server.host}:{server.port}", None, timeout=5.0)
            rows = {r["replica"]: r for r in view2["replicas"]}
            assert rows[name2]["absent"] is True
            live = [r for r in view2["replicas"] if not r["absent"]]
            assert len(live) == 1
        finally:
            server.shutdown()
            router.close(drain=False)
            eng1.close(drain=False)
            srv1.shutdown()
            eng2.close(drain=False)
            srv2.shutdown()

    def test_once_unreachable_target_exits_nonzero(self, capsys):
        rc = console.run_top(["127.0.0.1:1", "--once", "--format",
                              "json", "--timeout", "1.0"])
        assert rc == 1
        out = json.loads(capsys.readouterr().out)
        assert out["error"] == "target unreachable"


# -------------------------------------------------- parity and the CLI


def test_fleet_view_matches_pbccs_tpu():
    """Both consoles build the same frame from the same two samples
    (but for the wall-clock stamp)."""
    from pbccs_tpu.obs import console as jconsole

    prev = serve_sample(10.0, completed=5.0, slo=(10.0, 2.0))
    cur = serve_sample(12.5, completed=9.0, slo=(14.0, 3.0))
    router_status = {
        "engine": "ccs-router", "accepting": True, "pending": 2,
        "routed": 9, "completed": 7, "failovers": 1, "deduped": 0,
        "replicas": [{"replica": "a:1", "connected": True,
                      "healthy": True, "draining": False, "inflight": 2},
                     {"replica": "b:2", "connected": False,
                      "healthy": False, "draining": False, "inflight": 0}],
        "supervisor": {"slots": [{"slot": 0, "state": "up",
                                  "replica": "a:1"},
                                 {"slot": 1, "state": "restarting",
                                  "replica": None, "backoff_s": 0.5}],
                       "events": [{"event": "respawn", "slot": 1}],
                       "rolling_restart": None}}
    routed = {"t": 13.0, "status": router_status, "metrics": {
        ("ccs_serve_completed_total", (("replica", "a:1"),)): 6.0}}
    for c, p in ((cur, prev), (cur, None), (routed, prev)):
        mine = console.fleet_view(c, p, "x:1")
        ref = jconsole.fleet_view(c, p, "x:1")
        mine.pop("t_unix")
        ref.pop("t_unix")
        assert mine == ref
        assert console.render_text(dict(mine, t_unix=0)) == \
            jconsole.render_text(dict(ref, t_unix=0))


def test_top_and_roofline_target_through_the_cli(capsys, monkeypatch,
                                                 tmp_path):
    """`ccs top HOST:PORT --once --format json` and `ccs roofline
    --target HOST:PORT --format json` through the port's CLI against a
    live replica whose status carries a roofline block (one bucket's
    card noted and charged, as a polish does)."""
    from pbccs_tpu_torch.cli import run
    from pbccs_tpu_torch.obs import roofline

    monkeypatch.setenv("PBCCS_ROOFLINE_CARDS", str(tmp_path / "cards.json"))
    eng, srv = stub_serve_stack()
    tracker = roofline.tracker()
    try:
        tracker.reset_for_tests()
        tracker.ensure_card(imax=64, jmax=64, r=4, z=4, width=32,
                            guided_passes=0, device="cpu")
        tracker.charge_execution(imax=64, jmax=64, r=4, z=4)
        target = f"{srv.host}:{srv.port}"
        with CcsClient(srv.host, srv.port) as cli:
            assert cli.submit_wire(dict(ZMW)).reply(10.0)
        assert run(["top", target, "--once", "--format", "json",
                    "--interval", "0.2"]) == 0
        view = json.loads(capsys.readouterr().out)
        assert view["engine"] == "ccs-serve"
        (row,) = view["replicas"]
        assert not row["absent"] and row["completed"] >= 1
        assert row["throughput_zmws_per_sec"] is not None
        assert run(["roofline", "--target", target,
                    "--format", "json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["source"] == "status" and doc["target"] == target
        rows = {r["bucket"]: r for r in doc["rows"]}
        # the charged bucket, beside the one the stub flush dispatched
        assert rows["I64xJ64xR4"]["flops"] == \
            tracker.card("I64xJ64xR4").flops
        assert rows == {r["bucket"]: r for r in
                        roofline._rows_from_block(tracker.status_block())}
    finally:
        tracker.reset_for_tests()
        srv.shutdown()
        eng.close(drain=False)
