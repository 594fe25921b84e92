"""The port's trace spans on the device trace's clock, on the CPU.

While a tracer is installed and torch.profiler records, every span is a
profiler range of its name (nested as the spans nest); with no tracer,
no span name reaches the profiler and no CUDA event is made, and the
refine loop opens no profiler range of its own.  A span opened on a CUDA
device carries `device_ms` once its closing event has completed (here
with stand-in events, so the test needs no card); on the CPU none does.
A batch polish records the tree of its steps: polish.dispatch >
polish.setup / polish.gates / polish.refine > polish.round >
polish.round.select > slot_grid.* and polish.round.greedy, /
polish.qv / polish.outcomes, one polish.round per pass of the refine
loop."""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from pbccs_tpu_torch import pipeline as tp
from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.parallel import device_refine as tdr
from pbccs_tpu_torch.simulate import simulate_zmw

torch.set_num_threads(1)

#: span names pbccs_tpu records on the batch polish's path
JAX_SPANS = {"polish", "polish.setup", "polish.refine", "polish.round",
             "polish.qv"}


@pytest.fixture
def tracer():
    tr = obs_trace.Tracer()
    prev = obs_trace.set_tracer(tr)
    yield tr
    obs_trace.set_tracer(prev)


@pytest.fixture(scope="module")
def preps():
    """Three prepared ZMWs of 80 bp with 4 passes (the CLI parity test's
    draw)."""
    rng = np.random.default_rng(5)
    chunks = []
    for z in range(3):
        _, reads, _, snr = simulate_zmw(rng, 80, 4)
        chunks.append(tp.Chunk(f"m/{z}", [tp.Subread(f"m/{z}/{i}", r)
                                          for i, r in enumerate(reads)],
                               snr))
    _, out = tp.prepare_batch(chunks, tp.ConsensusSettings())
    assert len(out) == 3
    return out


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def test_spans_enter_the_profiler_nested(tracer):
    def work():
        with obs_trace.span("outer", zmws=2):
            with obs_trace.span("inner"):
                torch.ones(8).sum()

    events = _profiled(work)
    (o0, o1), = [(s, e) for n, s, e in events if n == "outer"]
    (i0, i1), = [(s, e) for n, s, e in events if n == "inner"]
    assert o0 <= i0 <= i1 <= o1
    ops = [(s, e) for n, s, e in events if n == "aten::sum"]
    assert ops and all(i0 <= s <= e <= i1 for s, e in ops)
    assert [s.name for s in tracer.finished_spans()] == ["outer", "inner"]


def test_no_tracer_no_program_range(preps):
    assert obs_trace.get_tracer() is None
    settings = tp.ConsensusSettings()
    events = _profiled(lambda: tp.polish_prepared_batch(preps, settings,
                                                        device="cpu"))
    names = {n for n, _, _ in events}
    assert "aten::sum" in names
    assert not names & (set(obs_trace.PORT_ONLY_SPANS) | JAX_SPANS)


def test_no_tracer_no_range_and_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert obs_trace.get_tracer() is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs_trace.span("polish.setup", device="cuda:0", zmws=1) as sp:
            assert sp is None


def test_cpu_spans_have_no_device_ms(tracer):
    with obs_trace.span("polish.refine", device=torch.device("cpu"),
                        zmws=1):
        with obs_trace.span("polish.round", round=0, live=1):
            pass
    assert all(s.events is None and "device_ms" not in s.args
               for s in tracer.finished_spans())
    chrome = json.loads(json.dumps(tracer.to_chrome()))
    assert [e["name"] for e in chrome["traceEvents"]] == [
        "polish.refine", "polish.round"]
    assert all("device_ms" not in e["args"] for e in chrome["traceEvents"])


class _FakeEvent:
    """A stand-in timing CUDA event: completes when the test says so."""

    clock = 0.0
    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done = False
        _FakeEvent.made.append(self)

    def record(self, stream):
        self.stream = stream
        _FakeEvent.clock += 2.5
        self.t = _FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t


def test_cuda_span_records_device_ms_once_complete(tracer, monkeypatch):
    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: f"stream of {dev}")
    with obs_trace.span("polish.qv", device="cuda:0", zmws=3):
        with obs_trace.span("polish.outcomes", zmws=3):
            pass
    opened, closed = _FakeEvent.made
    assert opened.stream == closed.stream == "stream of cuda:0"
    qv, outcomes = tracer.finished_spans()
    assert "device_ms" not in qv.args          # never waits for the card
    assert qv.events == [opened, closed]
    opened.done = closed.done = True
    tracer.finished_spans()
    assert qv.args["device_ms"] == 2.5 and qv.events is None
    assert outcomes.events is None and "device_ms" not in outcomes.args
    ev = next(e for e in tracer.to_chrome()["traceEvents"]
              if e["name"] == "polish.qv")
    assert ev["args"]["device_ms"] == 2.5 and ev["args"]["zmws"] == 3


class _FailingEvent(_FakeEvent):
    """A stand-in event whose recording fails after the first: a card a
    failed launch left failing."""

    def record(self, stream):
        if len(_FakeEvent.made) > 1:
            raise RuntimeError("CUDA error: an illegal memory access")
        super().record(stream)


def test_failed_closing_event_closes_the_span(tracer, monkeypatch):
    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", _FailingEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: dev)

    def work():
        with pytest.raises(ValueError, match="the launch's own"):
            with obs_trace.span("polish.refine", device="cuda:0", zmws=1):
                raise ValueError("the launch's own error")
        with obs_trace.span("polish.qv", zmws=1):
            pass

    events = _profiled(work)
    refine, qv = tracer.finished_spans()
    assert not refine.open and refine.events is None
    assert "device_ms" not in refine.args
    assert qv.parent is None and tracer._stack() == []
    (r0, r1), = [(s, e) for n, s, e in events if n == "polish.refine"]
    (q0, _), = [(s, e) for n, s, e in events if n == "polish.qv"]
    assert r1 <= q0


def _tree(tracer):
    return Counter((s.name, s.parent.name if s.parent else None)
                   for s in tracer.finished_spans())


def test_batch_polish_emits_the_tree_of_its_steps(tracer, preps,
                                                  monkeypatch):
    real, passes = tdr.run_refine_loop, []
    fetch, fetched_in = tdr.device_fetch, []

    def spy(grid, **kw):
        it0 = grid[0][0].st.it
        real(grid, **kw)
        passes.append(grid[0][0].st.it - it0)

    def fetch_spy(*a, **kw):
        fetched_in.append(tracer._stack()[-1].name)
        return fetch(*a, **kw)

    monkeypatch.setattr(tdr, "run_refine_loop", spy)
    monkeypatch.setattr(tdr, "device_fetch", fetch_spy)
    out = tp.polish_prepared_batch(preps, tp.ConsensusSettings(),
                                   device="cpu")
    assert [f for f, _ in out] == [tp.Failure.SUCCESS] * 3
    tree = _tree(tracer)
    n = sum(passes)
    assert n > 0 and tree[("polish.round", "polish.refine")] == n
    assert tree[("polish.dispatch", None)] == 1
    for step in ("polish.setup", "polish.gates", "polish.refine",
                 "polish.qv", "polish.outcomes"):
        assert tree[(step, "polish.dispatch")] == 1, step
    for step in ("polish.round.select", "polish.round.apply",
                 "polish.round.rebuild"):
        assert tree[(step, "polish.round")] == n, step
    assert tree[("polish.round.greedy", "polish.round.select")] == n
    # each round ends on the next pass's live count (the loop converges
    # here, so every round fetches one); only the first is outside
    fetches = Counter(fetched_in)
    assert fetches["polish.round"] == n
    assert fetches["polish.refine"] == len(passes)
    for stage in tdr.STAGES:
        assert tree[(stage, "polish.round.select")] >= n, stage
    assert {name for name, _ in tree} <= \
        set(obs_trace.PORT_ONLY_SPANS) | JAX_SPANS
    spans = tracer.finished_spans()
    rounds = [s.args for s in spans if s.name == "polish.round"]
    assert [a["round"] for a in rounds] == list(range(n))
    assert rounds[0]["live"] == 3
    assert all(a["live"] >= 1 for a in rounds)
    assert all(s.args["passes"] >= 0 for s in spans
               if s.name == "polish.round.greedy")
    assert next(s for s in spans
                if s.name == "polish.dispatch").args == {"zmws": 3}
    assert all("device_ms" not in s.args for s in spans)


def test_stages_are_port_only_spans():
    assert set(tdr.STAGES) <= set(obs_trace.PORT_ONLY_SPANS)
    assert not set(obs_trace.PORT_ONLY_SPANS) & JAX_SPANS


def _drifted(rng, read, n_blocks, block):
    """The read with `n_blocks` random insertions of `block` bases in its
    first half (tests/test_torch_pipeline.py's)."""
    r = list(read)
    pos = sorted(rng.choice(np.arange(20, len(r) // 2), n_blocks,
                            replace=False))[::-1]
    for p in pos:
        r[p:p] = list(rng.integers(0, 4, block))
    return np.array(r, np.int8)


def test_band_retry_is_two_spans_around_the_narrow_refine(tracer):
    """The 2x-band retry runs where it always ran: the wide polisher and
    the adoption choice before the narrow refine, its refine and QVs
    after it, each in a polish.band_retry span (args zmws, adopted)."""
    chunks = []
    for z in range(2):
        rng = np.random.default_rng(1 + 100 * z)
        _, reads, _, snr = simulate_zmw(rng, 300, 5)
        reads = list(reads)
        if z == 0:
            reads[0] = _drifted(rng, reads[0], 40, 2)
        chunks.append(tp.Chunk(f"w/{z}", [tp.Subread(f"w/{z}/{i}", r)
                                          for i, r in enumerate(reads)],
                               snr))
    _, preps = tp.prepare_batch(chunks, tp.ConsensusSettings())
    tp.polish_prepared_batch(preps, tp.ConsensusSettings(), device="cpu")
    spans = tracer.finished_spans()
    steps = [s for s in spans if s.parent is not None
             and s.parent.name == "polish.dispatch"]
    assert [s.name for s in steps] == [
        "polish.setup", "polish.gates", "polish.band_retry",
        "polish.refine", "polish.band_retry", "polish.qv",
        "polish.outcomes"]
    first, second = (s for s in steps if s.name == "polish.band_retry")
    assert first.args == second.args == {"zmws": 1, "adopted": 1}
    assert any(s.name == "polish.round" and s.parent is second
               for s in spans)
    assert not any(s.name == "polish.round" and s.parent is first
                   for s in spans)
