"""The port's observability tier against pbccs_tpu's on the CPU: the
metrics registry (counters, gauges, log-bucket histograms, measurement
scopes, Prometheus exposition, the end-of-run summary table), trace
spans with device-wait attribution and their Chrome export, the
device-fetch timer, the torch.profiler capture, and two small modules
of the same slice (runtime/readid.py, contract.py).  Then the router
tier's pieces: the federation helpers (parse, relabel and merge of
Prometheus expositions), the tracer's retroactive spans (`add_span`) and
the port's trace merge (the cases of tests/test_obs.py and
tests/test_trace_merge.py).

Parity: the same operations on a registry of each package render the
same Prometheus text and summary table; the CLI's --trace-out spans on
the same FASTA have the same names and nesting as pbccs_tpu's, the
refinement loop's per-round `polish.round` spans included, once the
port-only spans (obs/trace.PORT_ONLY_SPANS) are projected out; the
tool contract is the same JSON but for the command it names; the
federation helpers and add_span export the same text and args as
pbccs_tpu's, and the trace merge the same document as
tools/trace_merge.py on the same bundle."""

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
from pbccs_tpu_torch.tools import trace_merge
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
    of the export), and the names of the roots.  The port-only spans
    (obs_trace.PORT_ONLY_SPANS) are projected out: a span's parent is its
    nearest ancestor of another name."""
    events = json.load(open(path))["traceEvents"]
    by_id = {e["id"]: e for e in events}
    pairs = Counter()
    for e in events:
        if e["name"] in obs_trace.PORT_ONLY_SPANS:
            continue
        parent = by_id.get(e["args"].get("parent"))
        while parent is not None \
                and parent["name"] in obs_trace.PORT_ONLY_SPANS:
            parent = by_id.get(parent["args"].get("parent"))
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
    assert shapes["port"][("polish.round", "polish.refine")] > 0
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


class TestAddSpan:
    def test_add_span_pins_explicit_span_id(self):
        tracer = obs_trace.Tracer()
        sp = tracer.add_span("router.request", 0.25,
                             ctx={"trace_id": "abc", "span_id": "cl-0"},
                             span_id="rt-q9", replica="r1")
        assert sp is not None and not sp.open
        ev = tracer.to_chrome()["traceEvents"][0]
        assert ev["args"]["span_id"] == "rt-q9"
        assert ev["args"]["remote_parent"] == "cl-0"
        assert ev["dur"] == pytest.approx(250_000, rel=0.05)

    def test_add_span_exports_as_pbccs_tpu(self):
        """Retro spans with and without a context, a pinned id without
        a trace id, and one past the cap: the same args, the same
        dropped count as pbccs_tpu's tracer."""
        from pbccs_tpu.obs import trace as jtrace

        exported = []
        for mod in (obs_trace, jtrace):
            tracer = mod.Tracer(tag="r", max_spans=3)
            tracer.add_span("router.request", 0.01,
                            ctx={"trace_id": "t1", "span_id": None},
                            span_id="rt-q1", replica="a:1", attempts=1)
            tracer.add_span("router.request", 0.02, span_id="rt-q2")
            with tracer.span("serve.prep",
                             ctx={"trace_id": "t1", "span_id": "rt-q1"}):
                pass
            assert tracer.add_span("late", 0.0) is None
            assert tracer.span_id_of(tracer.finished_spans()[0]) == "rt-q1"
            doc = tracer.to_chrome()
            exported.append(([(e["name"], e["args"])
                              for e in doc["traceEvents"]],
                             doc["meta"]["dropped_spans"]))
        assert exported[0] == exported[1]


class TestFederationHelpers:
    def test_relabel_injects_into_all_sample_forms(self):
        from pbccs_tpu_torch.obs.metrics import relabel_exposition

        body = ('# TYPE a_total counter\n'
                'a_total 3\n'
                'a_total{x="1"} 4\n'
                'h_bucket{le="+Inf"} 7\n')
        out = relabel_exposition(body, replica="r:1")
        assert 'a_total{replica="r:1"} 3' in out
        assert 'a_total{x="1",replica="r:1"} 4' in out
        assert 'h_bucket{le="+Inf",replica="r:1"} 7' in out
        assert '# TYPE a_total counter' in out

    def test_merge_groups_by_name_with_one_type_line(self):
        from pbccs_tpu_torch.obs.metrics import merge_expositions

        merged = merge_expositions([
            "# TYPE a_total counter\na_total 1\n",
            '# TYPE a_total counter\na_total{replica="x"} 2\n',
        ])
        assert merged.count("# TYPE a_total counter") == 1
        assert "a_total 1" in merged
        assert 'a_total{replica="x"} 2' in merged

    def test_histogram_quantile(self):
        from pbccs_tpu_torch.obs.metrics import histogram_quantile

        bounds = (0.1, 0.2, 0.4)
        assert histogram_quantile((10, 0, 0, 0), bounds, 0.99) == 0.1
        assert histogram_quantile((50, 49, 1, 0), bounds, 0.99) == 0.2
        assert histogram_quantile((0, 0, 0, 5), bounds, 0.5) == 0.4
        import math
        assert math.isnan(histogram_quantile((0, 0, 0, 0), bounds, 0.5))

    def test_histogram_quantile_edge_shapes(self):
        """Empty/all-zero counts, a single bucket, and degenerate
        no-finite-bounds layouts answer (NaN or a bound), never raise."""
        import math

        from pbccs_tpu_torch.obs.metrics import histogram_quantile

        # empty layouts: no counts at all / no finite bounds
        assert math.isnan(histogram_quantile((), (), 0.5))
        assert math.isnan(histogram_quantile((5,), (), 0.9))
        # all-zero counts at every width
        assert math.isnan(histogram_quantile((0,), (), 0.5))
        assert math.isnan(histogram_quantile((0, 0), (1.0,), 0.5))
        # a single bucket: everything lands on its one bound
        assert histogram_quantile((3, 0), (1.0,), 0.01) == 1.0
        assert histogram_quantile((3, 0), (1.0,), 0.99) == 1.0
        # overflow-only observations report the last finite bound
        assert histogram_quantile((0, 7), (1.0,), 0.5) == 1.0
        # q=0 and q=1 extremes stay in range
        assert histogram_quantile((1, 1, 0), (0.1, 0.2), 0.0) == 0.1
        assert histogram_quantile((1, 1, 0), (0.1, 0.2), 1.0) == 0.2

    def test_hostile_label_values_roundtrip_federation(self):
        """Label values containing backslash, quote, newline, and a
        literal `}` must survive render -> relabel -> merge -> parse
        without corrupting the exposition (the values the fleet mints
        from network identity are not this hostile; a chaos test's
        are)."""
        from pbccs_tpu_torch.obs.metrics import (MetricsRegistry,
                                           merge_expositions,
                                           parse_exposition,
                                           relabel_exposition)

        hostile = 'a\\b"c}d\ne'
        reg = MetricsRegistry()
        reg.counter("ccs_hostile_total", "t", path=hostile).inc(3)
        body = reg.render_prometheus()
        relabeled = relabel_exposition(body, replica="r:1")
        merged = merge_expositions([relabeled])
        parsed = parse_exposition(merged)
        key = ("ccs_hostile_total",
               (("path", hostile), ("replica", "r:1")))
        assert parsed[key] == 3.0
        # the relabel actually landed (a corrupted line would have been
        # passed through unlabeled)
        assert all("replica" in dict(labels)
                   for (_n, labels) in parsed)

    def test_relabel_escapes_injected_label_value(self):
        from pbccs_tpu_torch.obs.metrics import (parse_exposition,
                                           relabel_exposition)

        out = relabel_exposition("a_total 1\n", replica='x"y\\z')
        assert parse_exposition(out)[
            ("a_total", (("replica", 'x"y\\z'),))] == 1.0

    def test_merge_empty_and_comment_only_parts(self):
        from pbccs_tpu_torch.obs.metrics import merge_expositions

        assert merge_expositions([]) == ""
        assert merge_expositions(["", "# HELP x_total h\n"]) == ""
        merged = merge_expositions(["", "# TYPE a_total counter\n"
                                        "a_total 1\n"])
        assert "a_total 1" in merged


    def test_helpers_match_pbccs_tpu_on_seeded_expositions(self):
        """parse_exposition, relabel_exposition and merge_expositions of
        both packages give the same output on the same seeded
        expositions (both registries' renders of the same updates,
        hostile label values included)."""
        from pbccs_tpu.obs import metrics as jmetrics

        rng = np.random.default_rng(20261017)
        parts = []
        for p in range(3):
            reg = MetricsRegistry()
            for _ in range(int(rng.integers(3, 8))):
                name = f"ccs_m{int(rng.integers(0, 4))}_total"
                label = "".join(rng.choice(list('ab"\\}{,\n x='), 5))
                reg.counter(name, "h", path=label).inc(
                    float(rng.integers(1, 100)))
            h = reg.histogram("ccs_lat_seconds", "lat",
                              buckets=(1e-3, 1e-2, 1.0))
            for v in rng.uniform(0, 2, 5):
                h.observe(float(v))
            reg.gauge("ccs_g", "g").set(float(rng.normal()))
            parts.append(reg.render_prometheus())
        for mod in (obs_metrics, jmetrics):
            assert [mod.parse_exposition(t) for t in parts] == \
                [jmetrics.parse_exposition(t) for t in parts]
        relabeled = [obs_metrics.relabel_exposition(t, replica=f"h:{i}")
                     for i, t in enumerate(parts)]
        assert relabeled == [jmetrics.relabel_exposition(t, replica=f"h:{i}")
                             for i, t in enumerate(parts)]
        merged = obs_metrics.merge_expositions(relabeled)
        assert merged == jmetrics.merge_expositions(relabeled)
        assert obs_metrics.parse_exposition(merged) == \
            jmetrics.parse_exposition(merged)


# ------------------------------------------------------------ trace merge

def _load_jax_trace_merge():
    """tools/trace_merge.py, loaded from its file (tools/ is no package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "trace_merge.py")
    spec = importlib.util.spec_from_file_location("jax_trace_merge", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chrome(events, origin=None, **meta):
    doc = {"traceEvents": events, "meta": dict(meta)}
    if origin is not None:
        doc["meta"]["origin_unix"] = origin
    return doc


def span(name, ts, span_id=None, parent=None, remote_parent=None,
         trace_id=None, **extra):
    args = dict(extra)
    if span_id is not None:
        args["span_id"] = span_id
    if parent is not None:
        args["parent"] = parent
    if remote_parent is not None:
        args["remote_parent"] = remote_parent
    if trace_id is not None:
        args["trace_id"] = trace_id
    return {"ph": "X", "name": name, "ts": ts, "dur": 5.0, "tid": 0,
            "args": args}


class TestMergeDegradation:
    def test_empty_bundle_merges_to_valid_empty_doc(self):
        merged = trace_merge.merge_docs(
            trace_merge.expand_bundle({"replicas": {}}))
        assert merged["traceEvents"][0]["name"] == "process_name"
        assert merged["meta"]["processes"] == {"router": 1}
        assert trace_merge.request_trees(merged) == {}

    def test_totally_empty_input(self):
        merged = trace_merge.merge_docs([])
        assert merged["traceEvents"] == []
        assert merged["meta"]["processes"] == {}

    def test_zero_span_replica_merges_cleanly(self):
        bundle = {"trace": chrome([span("a", 1.0, trace_id="t1",
                                        span_id="s1")], origin=100.0),
                  "replicas": {"r:1": chrome([], origin=100.5)}}
        merged = trace_merge.merge_docs(trace_merge.expand_bundle(bundle))
        assert merged["meta"]["processes"] == {"router": 1,
                                               "replica r:1": 2}
        report = trace_merge.request_trees(merged)
        assert report["t1"]["events"] == 1

    def test_missing_origin_is_noted_not_keyerror(self):
        bundle = {"trace": chrome([span("a", 1.0)], origin=100.0),
                  "replicas": {"r:1": chrome([span("b", 2.0)])}}
        merged = trace_merge.merge_docs(trace_merge.expand_bundle(bundle))
        assert merged["meta"]["unrebased_processes"] == ["replica r:1"]
        # the unrebased process's events keep their own timebase
        names = {ev.get("name") for ev in merged["traceEvents"]}
        assert {"a", "b"} <= names

    def test_malformed_replica_chrome_is_skipped_with_note(self):
        bundle = {"trace": chrome([span("a", 1.0)], origin=1.0),
                  "replicas": {"bad:1": None, "worse:2": "not a dict",
                               "ok:3": chrome([span("c", 3.0)],
                                              origin=1.5)}}
        merged = trace_merge.merge_docs(trace_merge.expand_bundle(bundle))
        assert sorted(merged["meta"]["skipped_processes"]) == [
            "replica bad:1", "replica worse:2"]
        assert "replica ok:3" in merged["meta"]["processes"]

    def test_alien_event_shapes_never_raise(self):
        doc = chrome([
            {"ph": "X", "name": "no_args", "ts": 1.0},       # args absent
            {"ph": "X", "name": "bad_args", "ts": 2.0,
             "args": "not a dict"},
            "not even a dict",
            {"ph": "X", "name": "ok", "ts": 3.0,
             "args": {"trace_id": "t", "span_id": "s"}},
        ], origin=5.0)
        merged = trace_merge.merge_docs([("p", doc)])
        report = trace_merge.request_trees(merged)
        assert report["t"]["events"] == 1
        assert trace_merge.trace_connected(merged, "t")

    def test_mixed_type_trace_ids_skip_not_typeerror(self):
        doc = chrome([
            span("alien", 1.0, trace_id=42),          # int id: skipped
            span("ok", 2.0, trace_id="t1", span_id="s1"),
        ], origin=1.0)
        merged = trace_merge.merge_docs([("p", doc)])
        report = trace_merge.request_trees(merged)
        assert list(report) == ["t1"]
        assert report["t1"]["events"] == 1

    def test_alien_name_and_unhashable_id_skip_not_typeerror(self):
        doc = chrome([
            {"ph": "X", "name": 5, "ts": 1.0,       # non-string name
             "args": {"span_id": "s1", "trace_id": "t1"}},
            {"ph": "X", "name": "ok", "ts": 2.0,
             "id": ["unhashable"],                   # alien event id
             "args": {"trace_id": "t1", "parent": ["also"],
                      "span_id": "s2"}},
        ], origin=1.0)
        merged = trace_merge.merge_docs([("p", doc)])
        report = trace_merge.request_trees(merged)
        assert report["t1"]["events"] == 2
        assert report["t1"]["spans"] == ["5", "ok"]

    def test_non_numeric_meta_counts_degrade(self):
        doc = chrome([span("a", 1.0)], origin=1.0,
                     dropped_spans="garbage", open_spans=None)
        merged = trace_merge.merge_docs([("p", doc)])
        assert merged["meta"]["dropped_spans"] == 0

    def test_cross_process_links_still_connect_after_hardening(self):
        bundle = {
            "trace": chrome([span("router.request", 1.0, span_id="rt-1",
                                  trace_id="t1")], origin=100.0),
            "replicas": {"r:1": chrome(
                [span("serve.prep", 2.0, span_id="sp-1",
                      remote_parent="rt-1", trace_id="t1")],
                origin=100.2)},
        }
        merged = trace_merge.merge_docs(trace_merge.expand_bundle(bundle))
        assert trace_merge.trace_connected(merged, "t1")
        report = trace_merge.request_trees(merged)
        assert report["t1"]["processes"] == [1, 2]


def test_trace_merge_matches_tools_trace_merge(tmp_path):
    """The port's trace merge gives tools/trace_merge.py's document and
    report on the same bundle: a router capture with retro spans and
    two replica captures whose spans name them as remote parents
    (seeded durations), plus the CLI writing it to a file."""
    jmerge = _load_jax_trace_merge()
    rng = np.random.default_rng(7)
    router = obs_trace.Tracer(tag="router")
    replicas = {f"127.0.0.1:{7000 + i}": obs_trace.Tracer(tag=f"rep{i}")
                for i in range(2)}
    names = sorted(replicas)
    for q in range(6):
        tid = f"{q:016x}"
        rep = replicas[names[q % 2]]
        with rep.span("serve.prep", ctx={"trace_id": tid,
                                         "span_id": f"rt-q{q}"}):
            with rep.span("serve.polish", zmws=1):
                pass
        router.add_span("router.request", float(rng.uniform(0, 0.01)),
                        ctx={"trace_id": tid, "span_id": None},
                        span_id=f"rt-q{q}", replica=names[q % 2])
    bundle = json.loads(json.dumps(
        {"type": "trace", "state": "stopped", "trace": router.to_chrome(),
         "replicas": {n: t.to_chrome() for n, t in replicas.items()}}))
    mine = trace_merge.merge_docs(trace_merge.expand_bundle(bundle))
    ref = jmerge.merge_docs(jmerge.expand_bundle(bundle))
    assert mine == ref
    report = trace_merge.request_trees(mine)
    assert report == jmerge.request_trees(ref)
    assert len(report) == 6
    assert all(r["components"] == 1 and len(r["processes"]) == 2
               for r in report.values())
    src = tmp_path / "bundle.json"
    src.write_text(json.dumps(bundle))
    assert trace_merge.main([str(src), "-o", str(tmp_path / "m.json")]) == 0
    # the CLI names the router process after the bundle's file
    assert json.loads((tmp_path / "m.json").read_text()) == \
        jmerge.merge_docs(jmerge.expand_bundle(bundle, router_name="bundle"))
