"""The port's perf ledger (obs/ledger.py), flight recorder (obs/flight.py)
and the CLI's --perfLedger, against pbccs_tpu's, on the CPU.

Contract: the same schema (field for field and class for class, with
torch_version where pbccs_tpu writes jax_version), the same writer and
reader behaviour (schema refusals, torn tails, write failures degrading
to absence), the same flight-recorder records for the same rounds; and
on the same subread BAM (tests/test_torch_cli.py's), a port `batch_run`
record whose counter and ratio fields equal pbccs_tpu.cli's, except
where the two programs differ by design:

  * refine rounds: the JAX tests run pbccs_tpu's host loop
    (PBCCS_DEVICE_REFINE=0 in conftest.py), the port its device loop, so
    the JAX side's host + device rounds equal the port's device rounds;
  * device_fetches: pbccs_tpu's host loop and the port's device loop
    fetch at different points (the count is the port's own: > 0);
  * roofline_flops / roofline_bytes: pbccs_tpu's card comes from XLA's
    cost analysis of its program, the port's is counted from the shapes
    (obs/roofline.py) -- both charge, neither can equal the other.

tools/perf_gate.py --counters-only passes the port's ledger against a
baseline built from the JAX ledger with exactly those fields exempted
(--ignore), and fails on exactly them without the exemption."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from pbccs_tpu.cli import run as jrun
from pbccs_tpu.obs import flight as jflight
from pbccs_tpu.obs.ledger import LEDGER_CLASSES as J_CLASSES
from pbccs_tpu.obs.ledger import LEDGER_FIELDS as J_FIELDS
from pbccs_tpu.obs.ledger import read_ledger as j_read_ledger

from pbccs_tpu_torch.cli import run
from pbccs_tpu_torch.obs import flight, roofline
from pbccs_tpu_torch.obs.ledger import (
    LEDGER_CLASSES,
    LEDGER_FIELDS,
    LEDGER_SCHEMA_VERSION,
    LedgerSchemaError,
    PerfLedger,
    environment_fields,
    read_ledger,
    run_record,
)
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask
from pbccs_tpu_torch.resilience import quarantine, resources
from pbccs_tpu_torch.simulate import simulate_zmw
from test_torch_cli import COMMON, _bam_input

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

import perf_gate  # noqa: E402  (tools/ module, path-injected above)

torch.set_num_threads(1)
_REG = default_registry()

#: counter fields the two packages count differently by design (module
#: docstring); every other counter and ratio field must be equal
BY_DESIGN = ("refine_rounds_host", "refine_rounds_device", "device_fetches",
             "roofline_flops", "roofline_bytes")


class _Log:
    def __init__(self):
        self.lines = []

    def warn(self, msg):
        self.lines.append(msg)


# ------------------------------------------------------------ flight


class TestFlightRecorder:
    def test_ring_bounds_and_gauges(self):
        rec = flight.FlightRecorder(capacity=4)
        for i in range(10):
            rec.record_round("b0", i, live=8 - i if i < 8 else 0,
                             n_zmws=8, z=16)
        snap = rec.snapshot()
        assert len(snap) == 4
        assert snap[-1]["round"] == 9
        assert snap[-1]["padding_waste"] == 0.5
        values = {k: v for k, (_, v) in _REG.snapshot().items()}
        assert values[("ccs_refine_padding_waste", ())] == 0.5
        assert values[("ccs_refine_slot_occupancy", ())] == 0.0
        assert values[("ccs_refine_converged_fraction", ())] == 1.0

    def test_dump_logs_counts_and_keeps(self):
        rec = flight.FlightRecorder(capacity=8)
        rec.record_round("b1", 0, 4, 4, 8, source="device")
        scope = _REG.scope()
        log = _Log()
        out = rec.dump("test-reason", log)
        assert len(out) == 1
        assert log.lines and "test-reason" in log.lines[0]
        logged = json.loads(log.lines[0].split(": ", 1)[1].split(
            ", last 1: ", 1)[1])
        assert logged[0]["source"] == "device"
        assert rec.snapshot()
        assert scope.counter_value("ccs_flight_dumps_total",
                                   reason="test-reason") == 1

    @pytest.mark.parametrize("source", ["host", "device"])
    def test_records_match_jax(self, source):
        """The same rounds give the same records (bar the sequence number
        of the process-wide ring) and count under the same source."""
        rng = np.random.default_rng(7)
        a, b = jflight.FlightRecorder(16), flight.FlightRecorder(16)
        scope = _REG.scope()
        for i in range(12):
            z = int(rng.integers(1, 33))
            n = int(rng.integers(1, z + 1))
            live = int(rng.integers(0, n + 1))
            a.record_round("m/1+3", i, live, n, z, source)
            b.record_round("m/1+3", i, live, n, z, source)
        assert a.snapshot() == b.snapshot()
        assert scope.counter_value("ccs_refine_rounds_total",
                                   source=source) == 12

    def test_batch_polisher_records_device_rounds(self):
        """BatchPolisher.refine rebuilds its rounds from the fetched
        iteration counts: max(iterations) rounds, each with the ZMWs
        still live, tagged with the first id and the batch size."""
        rng = np.random.default_rng(11)
        tasks = []
        for k in range(2):
            tpl, reads, strands, snr = simulate_zmw(rng, 40, 3)
            tasks.append(ZmwTask(f"m/{k}", tpl, snr, reads, strands,
                                 [0] * 3, [len(tpl)] * 3))
        scope = _REG.scope()
        pol = BatchPolisher(tasks, device="cpu")
        res = pol.refine()
        iters = [r.iterations for r in res]
        recs = [r for r in flight.default_recorder().snapshot()
                if r["batch"] == "m/0+2"][-max(iters):]
        assert [r["round"] for r in recs] == list(range(max(iters)))
        assert [r["live"] for r in recs] == [
            sum(k > rnd for k in iters) for rnd in range(max(iters))]
        assert all(r["source"] == "device" and r["z"] == pol._Z
                   for r in recs)
        assert scope.counter_value("ccs_refine_rounds_total",
                                   source="device") == max(iters)
        assert scope.counter_value("ccs_batch_polishes_total") == 1
        assert scope.counter_value("ccs_batch_slots_total",
                                   axis="read") == pol._Z * pol._R
        assert scope.counter_value("ccs_batch_slots_used_total",
                                   axis="read") == 6

    def test_quarantine_and_ceiling_dump(self):
        """A quarantined ZMW and a governor ceiling each dump the ring
        (pbccs_tpu's two dump sites)."""
        from pbccs_tpu_torch.pipeline import ConsensusSettings, Failure

        scope = _REG.scope()

        class _Prep:
            class chunk:
                id = "m/9"

        out = quarantine.quarantine_outcome(_Prep, ConsensusSettings(),
                                            RuntimeError("poison"))
        assert out == (Failure.OTHER, None)
        resources.MemoryGovernor().record_oom(("shape", 64, 64, 4), 8,
                                              device="test")
        assert scope.counter_value("ccs_flight_dumps_total",
                                   reason="quarantine") == 1
        assert scope.counter_value("ccs_flight_dumps_total",
                                   reason="oom-ceiling") == 1


# ------------------------------------------------------------ the ledger


class TestLedger:
    def test_schema_is_pbccs_tpus(self):
        """Field for field and class for class, torch_version in place of
        jax_version."""
        assert LEDGER_CLASSES == J_CLASSES
        want = {("torch_version" if k == "jax_version" else k): v
                for k, v in J_FIELDS.items()}
        assert LEDGER_FIELDS == want
        assert list(LEDGER_FIELDS) == list(want)

    def test_append_stamps_version_and_time(self, tmp_path):
        path = str(tmp_path / "l.ndjson")
        led = PerfLedger(path)
        assert led.append({"kind": "batch_run", "source": "t"})
        led.close()
        records, skipped = read_ledger(path)
        assert skipped == 0 and len(records) == 1
        assert records[0]["schema_version"] == LEDGER_SCHEMA_VERSION
        assert records[0]["t_unix"] > 0
        # pbccs_tpu's reader (what tools/perf_gate.py uses) reads it too
        assert j_read_ledger(path) == (records, 0)

    @pytest.mark.parametrize("field", ["made_up_field", "jax_version"])
    def test_unknown_field_is_refused(self, tmp_path, field):
        led = PerfLedger(str(tmp_path / "l.ndjson"))
        with pytest.raises(LedgerSchemaError, match=field):
            led.append({"kind": "batch_run", field: 1})

    def test_perf_block_carries_last_record(self, tmp_path):
        led = PerfLedger(str(tmp_path / "l.ndjson"))
        led.append({"kind": "serve_snapshot", "pending": 4})
        block = led.perf_block()
        assert block["schema_version"] == LEDGER_SCHEMA_VERSION
        assert block["records"] == 1
        assert block["last_record"]["pending"] == 4

    def test_torn_tail_skipped_not_raised(self, tmp_path):
        path = str(tmp_path / "l.ndjson")
        led = PerfLedger(path)
        led.append({"kind": "batch_run"})
        led.close()
        with open(path, "a") as f:
            f.write('{"kind": "batch_r')
        records, skipped = read_ledger(path)
        assert len(records) == 1 and skipped == 1

    def test_missing_file_is_empty_not_raise(self, tmp_path):
        assert read_ledger(str(tmp_path / "nope.ndjson")) == ([], 0)

    def test_write_failure_degrades_to_absence(self, tmp_path):
        path = str(tmp_path / "as_dir")
        os.mkdir(path)
        scope = _REG.scope()
        log = _Log()
        led = PerfLedger(path, logger=log)
        assert led.append({"kind": "batch_run"}) is False
        assert led.append({"kind": "batch_run"}) is False
        assert led.records_written() == 0
        assert scope.counter_value("ccs_output_write_errors_total",
                                   sink="perf_ledger") == 1
        assert log.lines and "disabled" in log.lines[0]

    def test_counters_and_ratios_from_scope(self):
        scope = _REG.scope()
        _REG.counter("ccs_polish_dispatches_total").inc(2)
        _REG.counter("ccs_batch_slots_total", axis="zmw").inc(16)
        _REG.counter("ccs_batch_slots_used_total", axis="zmw").inc(12)
        _REG.counter("ccs_watchdog_timeouts_total", site="a").inc(1)
        _REG.counter("ccs_watchdog_timeouts_total", site="b").inc(2)
        rec = run_record(scope, kind="batch_run", source="t",
                         wall_s=2.0, zmws=12, results=11, device="cpu")
        assert rec["polish_dispatches"] == 2
        assert rec["fill_ratio_zmw"] == 0.75
        assert rec["padding_waste"] == 0.25
        assert rec["zmws_per_sec"] == 6.0
        assert rec["results"] == 11
        assert rec["watchdog_timeouts"] == 3
        assert rec["peak_rss_bytes"] > 0
        assert set(rec) <= set(LEDGER_FIELDS)

    def test_region_shares_normalized(self):
        rec = run_record(_REG.scope(), kind="bench_row", source="b",
                         region_shares={"kernels": 30.0, "other": 10.0})
        assert rec["region_shares"] == {"kernels": 0.75, "other": 0.25}

    def test_environment_fields_never_create_a_context(self, monkeypatch):
        """Without a device, the platform comes from a CUDA context that
        already exists; a ledger append never initializes one."""
        called = []
        monkeypatch.setattr(torch.cuda, "init",
                            lambda: called.append("init"))
        monkeypatch.setattr(torch.cuda, "_lazy_init",
                            lambda: called.append("lazy"))
        fields = environment_fields()
        assert fields == {"platform": "cpu", "tuned_profile": "none",
                          "torch_version": torch.__version__}
        assert environment_fields("cuda")["platform"] == "gpu"
        assert environment_fields("cpu")["platform"] == "cpu"
        assert not called


# ------------------------------------------------------------ --perfLedger


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    """Both CLIs with --perfLedger on the same subread BAM; the port's
    run with its card file in the test's directory and its setups'
    shapes recorded."""
    d = str(tmp_path_factory.mktemp("ledger"))
    inp = _bam_input(d)
    out = {"setups": []}
    real_setup = BatchPolisher._setup

    def setup(self):
        out["setups"].append((self._Imax, self._Jmax, self._R, self._Z))
        return real_setup(self)

    cards_env = os.environ.get("PBCCS_ROOFLINE_CARDS")
    for who, fn, kw in (("jax", jrun, {}), ("port", run, {"device": "cpu"})):
        path = os.path.join(d, f"{who}.ndjson")
        argv = [os.path.join(d, f"{who}.bam"), inp, "--reportFile",
                os.path.join(d, f"{who}.csv"), "--perfLedger", path, *COMMON]
        if who == "port":
            os.environ["PBCCS_ROOFLINE_CARDS"] = os.path.join(d, "cards.json")
            BatchPolisher._setup = setup
        try:
            assert fn(argv, **kw) == 0
        finally:
            BatchPolisher._setup = real_setup
            if cards_env is None:
                os.environ.pop("PBCCS_ROOFLINE_CARDS", None)
            else:
                os.environ["PBCCS_ROOFLINE_CARDS"] = cards_env
        (out[who],), skipped = read_ledger(path)
        assert skipped == 0
        out[who + "_path"] = path
    out["dir"] = d
    return out


def test_perf_ledger_record_matches_jax(ledgers):
    """One batch_run record each; every counter and ratio field both
    carry is equal, refine rounds compared as a sum; the meta fields
    name the port's framework and platform."""
    j, p = ledgers["jax"], ledgers["port"]
    assert p["kind"] == j["kind"] == "batch_run"
    assert p["source"] == j["source"] == "ccs"
    assert p["workload"] == j["workload"]
    assert p["platform"] == "cpu" and p["torch_version"] == torch.__version__
    assert "jax_version" not in p and p["tuned_profile"] == "none"
    assert set(p) <= set(LEDGER_FIELDS)
    shared = [k for k in set(j) & set(p)
              if J_FIELDS.get(k) in ("counter", "ratio")
              and k not in BY_DESIGN]
    assert {"zmws", "results", "polish_dispatches", "batch_polishes",
            "zmw_slots", "read_slots_used", "fill_ratio_read",
            "padding_waste"} <= set(shared)
    assert {k: p[k] for k in shared} == {k: j[k] for k in shared}
    assert p["refine_rounds_host"] == 0
    assert p["refine_rounds_device"] == \
        j["refine_rounds_host"] + j["refine_rounds_device"] > 0
    assert p["device_fetches"] > 0
    assert p["roofline_flops"] > 0 and j["roofline_flops"] > 0


def test_perf_ledger_roofline_fields(ledgers):
    """roofline_flops is the sum of the cards' charges over the run's
    setups; the efficiency is achieved over the CPU's nominal peak."""
    p = ledgers["port"]
    tr = roofline.tracker()
    want = sum(tr.card(roofline.bucket_label(i, j, r)).flops_for(z)
               for i, j, r, z in ledgers["setups"])
    assert ledgers["setups"] and p["roofline_flops"] == want
    assert p["roofline_bytes"] == sum(
        tr.card(roofline.bucket_label(i, j, r)).bytes_for(z)
        for i, j, r, z in ledgers["setups"])
    assert p["roofline_efficiency"] == pytest.approx(
        p["roofline_achieved_tflops"] / roofline.CPU_PEAK_TFLOPS, rel=1e-5)


def test_perf_gate_passes_port_ledger_against_jax_baseline(ledgers, capsys):
    """--counters-only --kind batch_run: a baseline built from the JAX
    ledger passes the port's ledger with the by-design fields exempted,
    and fails on exactly those fields without the exemption."""
    base = os.path.join(ledgers["dir"], "baseline.json")
    assert perf_gate.main([ledgers["jax_path"], "--baseline", base,
                           "--kind", "batch_run",
                           "--update-baseline"]) == 0
    gate = [ledgers["port_path"], "--baseline", base, "--counters-only",
            "--kind", "batch_run"]
    ignores = [a for k in BY_DESIGN for a in ("--ignore", k)]
    capsys.readouterr()
    assert perf_gate.main(gate + ignores) == 0
    assert "perf_gate: OK" in capsys.readouterr().out
    assert perf_gate.main(gate) == 1
    failed = {json.loads(line)["perf_gate_violation"]["metric"]
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("{")}
    assert failed and failed <= set(BY_DESIGN)


# ------------------------------------------------ the router's fleet ledger


def test_router_merges_fleet_records(tmp_path):
    """`ccs router --perfLedger`'s fleet tick: its own router_snapshot,
    and one replica_snapshot per reachable replica -- the replica's
    newest ledger record (one replica writes a ledger) or its live
    status figures (the other does not).  Every field is declared; the
    ledger-running replica's record carries its source's platform."""
    import time as time_mod

    from pbccs_tpu_torch.pipeline import Failure, PreparedZmw
    from pbccs_tpu_torch.serve.engine import CcsEngine, ServeConfig
    from pbccs_tpu_torch.serve.router import CcsRouter, RouterConfig
    from pbccs_tpu_torch.serve.server import CcsServer

    def engine(ledger_path=None):
        return CcsEngine(
            config=ServeConfig(max_batch=1, max_wait_ms=20.0,
                               perf_ledger_path=ledger_path,
                               perf_ledger_interval_s=0.1),
            prep_fn=lambda c, s: (None, PreparedZmw(
                c, np.zeros(8, np.int8), [], 1, 0, 0.0)),
            polish_fn=lambda p, s: [(Failure.SUCCESS, None) for _ in p],
            device="cpu").start()

    eng1 = engine(str(tmp_path / "serve_ledger.ndjson"))
    eng2 = engine()
    srv1 = CcsServer(eng1, port=0).start()
    srv2 = CcsServer(eng2, port=0).start()
    fleet_path = str(tmp_path / "fleet_ledger.ndjson")
    names = {f"127.0.0.1:{srv1.port}", f"127.0.0.1:{srv2.port}"}
    router = CcsRouter(sorted(names),
                       RouterConfig(health_interval_s=0.2,
                                    perf_ledger_path=fleet_path,
                                    perf_ledger_interval_s=0.2)).start()

    def replicas_seen():
        return {r.get("replica") for r in read_ledger(fleet_path)[0]
                if r["kind"] == "replica_snapshot"}

    def sourced():
        # replica_snapshots that carry srv1's own ledger record
        return [r for r in read_ledger(fleet_path)[0]
                if r["kind"] == "replica_snapshot"
                and r["replica"] == f"127.0.0.1:{srv1.port}"
                and "platform" in r]

    try:
        deadline = time_mod.monotonic() + 10.0
        while time_mod.monotonic() < deadline:
            kinds = {r["kind"] for r in read_ledger(fleet_path)[0]}
            if "router_snapshot" in kinds and names <= replicas_seen() \
                    and sourced():
                break
            time_mod.sleep(0.05)
    finally:
        router.close(drain=False)
        for srv, eng in ((srv1, eng1), (srv2, eng2)):
            srv.shutdown()
            eng.close(drain=False)
    records, skipped = read_ledger(fleet_path)
    assert skipped == 0
    assert {"router_snapshot", "replica_snapshot"} <= \
        {r["kind"] for r in records}
    assert names <= replicas_seen()
    for rec in records:
        assert set(rec) <= set(LEDGER_FIELDS), set(rec) - set(LEDGER_FIELDS)
    led = sourced()
    assert led and all(r["platform"] == "cpu" and "torch_version" in r
                       for r in led)
