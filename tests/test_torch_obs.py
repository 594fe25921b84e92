"""The port's observability tier against pbccs_tpu's on the CPU: the
metrics registry (counters, gauges, log-bucket histograms, measurement
scopes, Prometheus exposition, the end-of-run summary table), trace
spans with device-wait attribution and their Chrome export, the
device-fetch timer, the torch.profiler capture, and two small modules
of the same slice (runtime/readid.py, contract.py).

Parity: the same operations on a registry of each package render the
same Prometheus text and summary table; the CLI's --trace-out spans on
the same FASTA have the same names and nesting as pbccs_tpu's (its host
refinement loop's per-round `polish.round` spans aside: the port
refines in its device loop, which, like pbccs_tpu's, has none); the
tool contract is the same JSON but for the command it names."""

import json
import os
import threading
from collections import Counter

import numpy as np
import pytest
import torch

import pbccs_tpu.cli as jcli
import pbccs_tpu.contract as jcontract
from pbccs_tpu.obs.metrics import MetricsRegistry as JRegistry
from pbccs_tpu.runtime.readid import ReadId as JReadId

import pbccs_tpu_torch.cli as tcli
from pbccs_tpu_torch import contract
from pbccs_tpu_torch.io.fasta import write_fasta
from pbccs_tpu_torch.models.arrow.params import decode_bases
from pbccs_tpu_torch.obs import metrics as obs_metrics
from pbccs_tpu_torch.obs import profiling
from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.obs.metrics import MetricsRegistry, log_buckets
from pbccs_tpu_torch.runtime import timing
from pbccs_tpu_torch.runtime.readid import ReadId
from pbccs_tpu_torch.simulate import simulate_zmw
from pbccs_tpu_torch.utils.intervals import Interval

torch.set_num_threads(1)


def _exercise(reg):
    """The same updates on a registry of either package."""
    reg.counter("ccs_a_total", "help a", stage="draft").inc(2.5)
    reg.counter("ccs_a_total", stage="polish").inc()
    reg.gauge("ccs_g", "a gauge").set(7)
    h = reg.histogram("ccs_lat_seconds", "latency",
                      buckets=(1e-3, 1e-2, 1.0))
    for v in (5e-4, 1e-3, 0.02, 3.0):
        h.observe(v)
    reg.counter("c_total", stage='we"ird\n').inc()
    reg.histogram("ccs_default_seconds").observe(0.25)


# ---------------------------------------------------------------- metrics


class TestRegistryParity:
    def test_prometheus_text_matches(self):
        mine, ref = MetricsRegistry(), JRegistry()
        _exercise(mine)
        _exercise(ref)
        assert mine.render_prometheus() == ref.render_prometheus()
        assert 'stage="we\\"ird\\n"' in mine.render_prometheus()

    def test_summary_table_and_deltas_match(self):
        mine, ref = MetricsRegistry(), JRegistry()
        ms, rs = mine.scope(), ref.scope()
        _exercise(mine)
        _exercise(ref)
        assert mine.summary_table(ms) == ref.summary_table(rs)
        assert mine.summary_table() == ref.summary_table()
        assert ms.delta() == rs.delta()
        assert "ccs_a_total{stage=draft}" in mine.summary_table(ms)
        assert "ccs_g" not in mine.summary_table(ms)   # gauges skipped

    @pytest.mark.parametrize("lo,hi,f", [(1.0, 100.0, 10.0),
                                         (1e-4, 300.0, 10 ** 0.5),
                                         (1e-5, 30.0, 2.0)])
    def test_log_buckets_match(self, lo, hi, f):
        from pbccs_tpu.obs.metrics import log_buckets as jlog_buckets

        assert log_buckets(lo, hi, f) == jlog_buckets(lo, hi, f)

    def test_series_cap_matches(self):
        mine, ref = MetricsRegistry(2), JRegistry(2)
        for reg in (mine, ref):
            for i in range(4):
                reg.counter("ccs_x_total", peer=str(i)).inc()
        assert mine.render_prometheus() == ref.render_prometheus()


class TestCounters:
    def test_inc_and_negative_rejected(self):
        c = MetricsRegistry().counter("t_total")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_get_or_create_and_kind_collision(self):
        reg = MetricsRegistry()
        a = reg.counter("t_total", stage="draft")
        assert a is reg.counter("t_total", stage="draft")
        assert a is not reg.counter("t_total", stage="polish")
        with pytest.raises(TypeError):
            reg.gauge("t_total", stage="draft")

    def test_concurrent_increments_exact(self):
        reg = MetricsRegistry()
        c, g = reg.counter("t_total"), reg.gauge("t_gauge")
        h = reg.histogram("h", buckets=(0.5,))
        n, per = 8, 3000

        def worker():
            for _ in range(per):
                c.inc()
                g.inc()
                h.observe(1.0)

        threads = [threading.Thread(target=worker) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert c.value == g.value == n * per
        assert h.snapshot() == ((0, n * per), float(n * per), n * per)

    def test_bucketing_edges(self):
        h = MetricsRegistry().histogram("h", buckets=(1.0, 10.0, 100.0))
        for v in (0.5, 1.0, 1.0000001, 10.0, 99.0, 100.0, 1e9):
            h.observe(v)
        assert h.snapshot()[0] == (2, 2, 2, 1)

    def test_scopes_are_independent(self):
        reg = MetricsRegistry()
        c = reg.counter("t_total")
        first = reg.scope()
        c.inc(3)
        second = reg.scope()
        c.inc(4)
        assert first.counter_value("t_total") == 7.0
        assert second.counter_value("t_total") == 4.0

    def test_default_registry_is_shared(self):
        assert obs_metrics.default_registry() is \
            obs_metrics.default_registry()


# ------------------------------------------------------------------ trace


class TestTrace:
    def test_span_tree_nesting_and_round_trip(self):
        tracer = obs_trace.Tracer()
        with tracer.span("polish", zmws=2):
            with tracer.span("polish.setup", zmws=2):
                pass
            with tracer.span("polish.refine", zmws=2):
                pass
        chrome = json.loads(json.dumps(tracer.to_chrome()))
        assert [e["name"] for e in chrome["traceEvents"]] == \
            ["polish", "polish.setup", "polish.refine"]
        tree = obs_trace.span_tree(chrome)
        (root,) = tree[None]
        assert [c["name"] for c in tree[root["id"]]] == \
            ["polish.setup", "polish.refine"]
        for c in tree[root["id"]]:
            assert root["ts"] <= c["ts"]
            assert c["ts"] + c["dur"] <= root["ts"] + root["dur"] + 1e-6

    def test_ctx_span_exports_the_trace_identity_as_pbccs_tpu(self):
        """The wire trace context: a span with an inbound ctx adopts its
        trace id and records its span id as the remote parent, children
        inherit the trace id, and the exported args are pbccs_tpu's for
        the same spans."""
        from pbccs_tpu.obs import trace as jtrace

        exported = []
        for mod in (obs_trace, jtrace):
            tracer = mod.Tracer(tag="t1")
            with tracer.span("serve.prep",
                             ctx={"trace_id": "abc", "span_id": "rt-q1"}):
                with tracer.span("inner") as sp:
                    ctx = tracer.context_of(sp)
                    assert tracer.current_span() is sp
            with tracer.span("untraced") as sp:
                assert tracer.context_of(sp) is None
            exported.append([(e["name"], e["args"]) for e in
                             tracer.to_chrome()["traceEvents"]])
            assert ctx == {"trace_id": "abc", "span_id": "t1-1"}
        mine, ref = ([(n, {k: a[k] for k in a if k != "device_wait_ms"})
                      for n, a in ev] for ev in exported)
        assert mine == ref
        assert mine[1][1] == {"parent": 0, "trace_id": "abc",
                              "span_id": "t1-1"}

    def test_current_context_round_trip(self):
        tracer = obs_trace.Tracer(tag="cli")
        prev = obs_trace.set_tracer(None)
        try:
            assert obs_trace.current_context() is None  # tracing off
            assert obs_trace.install_tracer(tracer)
            assert obs_trace.current_context() is None  # not in a span
            with obs_trace.span("load", ctx={"trace_id": "t",
                                             "span_id": None}):
                ctx = obs_trace.current_context()
                assert ctx == {"trace_id": "t", "span_id": "cli-0"}
            assert obs_trace.clear_tracer(tracer)
        finally:
            obs_trace.set_tracer(prev)
        ids = {obs_trace.new_trace_id() for _ in range(64)}
        assert len(ids) == 64
        assert all(len(i) == 16 and int(i, 16) >= 0 for i in ids)

    def test_device_fetch_attributes_wait(self):
        """timing.device_fetch copies a tensor to the host, counts the
        fetch and its blocking time, and attributes the time to the
        innermost open span."""
        tracer = obs_trace.Tracer()
        prev = obs_trace.set_tracer(tracer)
        win = timing.window()
        try:
            with obs_trace.span("polish"):
                with obs_trace.span("polish.refine"):
                    out = timing.device_fetch(torch.arange(4,
                                                           dtype=torch.int32),
                                              np.float64)
        finally:
            obs_trace.set_tracer(prev)
        np.testing.assert_array_equal(out, [0.0, 1.0, 2.0, 3.0])
        assert out.dtype == np.float64
        assert win.counter_value("ccs_device_fetches_total") == 1
        assert win.counter_value("ccs_device_wait_seconds_total") >= 0.0
        spans = {s.name: s for s in tracer.finished_spans()}
        assert spans["polish.refine"].device_wait_s >= 0.0
        ev = [e for e in tracer.to_chrome()["traceEvents"]
              if e["name"] == "polish.refine"][0]
        assert "device_wait_ms" in ev["args"]

    def test_stage_timer(self):
        win = timing.window()
        with timing.stage("test_obs_stage"):
            pass
        timing.add_stage("test_obs_stage", 1.0)
        assert timing.stage_seconds(win)["test_obs_stage"] >= 1.0

    def test_disabled_tracer_is_noop(self):
        prev = obs_trace.set_tracer(None)
        try:
            with obs_trace.span("x") as sp:
                assert sp is None
            obs_trace.add_device_wait(1.0)
        finally:
            obs_trace.set_tracer(prev)

    def test_span_cap_bounds_capture(self):
        tracer = obs_trace.Tracer(max_spans=3)
        for i in range(5):
            with tracer.span("s", i=i) as sp:
                assert (sp is not None) == (i < 3)
        chrome = tracer.to_chrome()
        assert len(chrome["traceEvents"]) == 3
        assert chrome["droppedSpans"] == 2
        assert chrome["meta"]["dropped_spans"] == 2

    def test_install_and_clear_are_cas(self):
        prev = obs_trace.set_tracer(None)
        try:
            a, b = obs_trace.Tracer(), obs_trace.Tracer()
            assert obs_trace.install_tracer(a)
            assert not obs_trace.install_tracer(b)
            assert not obs_trace.clear_tracer(b)
            assert obs_trace.get_tracer() is a
            assert obs_trace.clear_tracer(a)
            assert obs_trace.get_tracer() is None
        finally:
            obs_trace.set_tracer(prev)

    def test_spans_across_threads_keep_separate_stacks(self):
        tracer = obs_trace.Tracer()

        def worker(i):
            with tracer.span("w", i=i):
                pass

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        spans = tracer.finished_spans()
        assert len(spans) == 4 and all(s.parent is None for s in spans)

    def test_open_spans_tagged(self):
        tracer = obs_trace.Tracer()
        with tracer.span("outer"):
            chrome = tracer.to_chrome()
        assert chrome["traceEvents"][0]["args"]["open"] is True
        assert chrome["meta"]["open_spans"] == 1
        assert "open" not in tracer.to_chrome()["traceEvents"][0]["args"]


# --------------------------------------------------------------- profiling


class TestProfiling:
    def test_capture_writes_a_chrome_trace(self, tmp_path):
        d = str(tmp_path / "prof")
        with profiling.profile_capture(d):
            torch.ones(64).cumsum(0)
        assert os.listdir(d) == [os.path.basename(profiling.trace_path(d))]
        assert json.load(open(profiling.trace_path(d)))["traceEvents"]

    def test_off_without_a_directory(self, tmp_path):
        with profiling.profile_capture(None):
            pass
        with profiling.profile_capture(""):
            pass

    def test_failure_to_start_only_warns(self, tmp_path, monkeypatch):
        def broken(*a, **kw):
            raise RuntimeError("no profiler here")

        monkeypatch.setattr(torch.profiler, "profile", broken)
        ran = []
        with profiling.profile_capture(str(tmp_path / "p")):
            ran.append(1)
        assert ran == [1]

    def test_work_errors_still_raise(self, tmp_path):
        with pytest.raises(ValueError, match="the work"):
            with profiling.profile_capture(str(tmp_path / "p")):
                raise ValueError("the work failed")


# ------------------------------------------------- CLI spans vs pbccs_tpu


def _span_shape(path):
    """Span names with their parents' names, as a multiset (the nesting
    of the export), and the names of the roots."""
    events = json.load(open(path))["traceEvents"]
    by_id = {e["id"]: e for e in events}
    pairs = Counter()
    for e in events:
        if e["name"] == "polish.round":
            continue
        parent = by_id.get(e["args"].get("parent"))
        pairs[(e["name"], parent["name"] if parent else None)] += 1
    return pairs


def test_cli_trace_spans_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    recs = []
    for hole in (1, 2, 3):
        _, reads, _, _ = simulate_zmw(rng, 80, 4)
        recs += [(f"movie1/{hole}/{i * 100}_{i * 100 + len(r)}",
                  decode_bases(r)) for i, r in enumerate(reads)]
    inp = str(tmp_path / "in.fasta")
    write_fasta(inp, recs)
    shapes = {}
    for who, fn, kw in (("jax", jcli.run, {}),
                        ("port", tcli.run, {"device": "cpu"})):
        trace = str(tmp_path / f"{who}.json")
        assert fn([str(tmp_path / f"{who}.bam"), inp, "--reportFile",
                   str(tmp_path / f"{who}.csv"), "--skipChemistryCheck",
                   "--numThreads", "1", "--logLevel", "WARN",
                   "--trace-out", trace], **kw) == 0
        shapes[who] = _span_shape(trace)
    assert shapes["port"] == shapes["jax"]
    assert shapes["port"][("polish.refine", "polish")] == 1
    assert shapes["port"][("filter", None)] == 3
    events = json.load(open(tmp_path / "port.json"))["traceEvents"]
    assert {"device_wait_ms", "zmws"} <= set(
        next(e for e in events if e["name"] == "polish")["args"])


# ----------------------------------------------------- readid and contract


@pytest.mark.parametrize("text", ["m/12", "m/12/0_100", "movie_x/7/5_9"])
def test_readid_matches(text):
    mine, ref = ReadId.parse(text), JReadId.parse(text)
    assert str(mine) == str(ref) == text
    assert (mine.movie_name, mine.hole_number) == \
        (ref.movie_name, ref.hole_number)
    if mine.zmw_interval is not None:
        assert mine.zmw_interval == Interval(ref.zmw_interval.left,
                                             ref.zmw_interval.right)
    with pytest.raises(ValueError):
        ReadId.parse("nomovie")


def test_tool_contract_matches_but_for_its_command():
    mine, ref = contract.tool_contract(), jcontract.tool_contract()
    assert mine["driver"]["exe"] == \
        "python -m pbccs_tpu_torch.contract run-rtc "
    mine["driver"]["exe"] = ref["driver"]["exe"]
    assert mine == ref


def test_resolved_contract_maps_onto_the_cli(tmp_path, monkeypatch):
    """A resolved tool contract becomes the same argv in both packages,
    handed to the port's CLI (which polishes on the card)."""
    rtc = {"resolved_tool_contract": {
        "options": {"pbccs.task_options.min_passes": 5,
                    "pbccs.task_options.min_snr": 3.5},
        "output_files": [str(tmp_path / "o.consensusreadset.xml"),
                         str(tmp_path / "r.csv")],
        "input_files": [str(tmp_path / "in.bam")], "nproc": 4}}
    path = tmp_path / "rtc.json"
    path.write_text(json.dumps(rtc))
    seen = {}
    monkeypatch.setattr(tcli, "run", lambda argv: seen.setdefault(
        "port", argv) and 0)
    monkeypatch.setattr(jcli, "run", lambda argv: seen.setdefault(
        "jax", argv) and 0)
    assert contract.run_resolved_tool_contract(str(path)) == 0
    assert jcontract.run_resolved_tool_contract(str(path)) == 0
    assert seen["port"] == seen["jax"]
    assert str(tmp_path / "o.bam") in seen["port"]
    assert "--minPasses=5" in seen["port"]


def test_emit_tool_contract_file(tmp_path):
    out = tmp_path / "tc.json"
    assert contract.main(["emit-tool-contract", "-o", str(out)]) == 0
    assert json.loads(out.read_text()) == contract.tool_contract()
