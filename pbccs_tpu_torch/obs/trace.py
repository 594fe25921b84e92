"""Per-ZMW trace spans with wall vs device-wait attribution.

Port of pbccs_tpu.obs.trace.  A Tracer collects a span tree
per thread (filter -> draft -> polish -> polish.dispatch -> polish.setup
/ polish.gates / polish.band_retry / polish.refine / polish.qv /
polish.outcomes -> emit; the refine loop's rounds and their steps under
polish.refine) and exports Chrome-trace/Perfetto JSON ("traceEvents"
with complete "X" events: load chrome://tracing or ui.perfetto.dev).
Wall time is the span's duration; device-wait seconds are attributed to
the INNERMOST open span of the thread that blocked
(runtime/timing.device_fetch routes its measured blocking time here), so
a polish span decomposes into host work vs waiting on the card's queue
at a device-to-host copy.  PORT_ONLY_SPANS names the spans pbccs_tpu
does not record.

The device trace's clock: while a tracer is installed and torch.profiler
is recording, each span also opens a torch.profiler.record_function
range of its name for its lifetime, so the program's steps sit in the
profiler's host timeline beside the CUDA kernels, on their clock.
Device time: a span opened with `device=` a CUDA device records a
timing CUDA event on that device's current stream when it opens and
another when it closes; finished_spans() (and so the Chrome export)
puts the stretch between them in the span's args as `device_ms` once
the closing event has completed (Event.query; it never synchronizes).
The stretch runs from the card reaching the opening event to it
finishing the span's last work.  A card still busy with earlier work
reaches that event when the earlier work ends; an idle card reaches it
at once, so the host's work up to the span's first launch counts too:
`device_ms` is the span's wall on the card's clock, not the card's busy
time (which the profiler's kernels under the span's range give).  On
the CPU, or without `device=`, there is no event and no `device_ms`.

Tracing is OFF unless a tracer is installed (CLI --trace-out, serve
`trace` verb, the benchmark's traced run); the disabled fast path is one
global read per span() call -- no profiler range, no CUDA event --
cheap enough to leave the instrumentation in the hot pipeline.

Cross-process trace context: a span may carry an inbound `ctx` dict --
``{"trace_id": ..., "span_id": ...}``, the wire shape of
serve/protocol.py's `trace` submit field -- naming the REMOTE parent it
continues.  Children inherit the trace_id through the per-thread stack,
every context-bearing span exports a process-unique `span_id`, and
tools/trace_merge.py reassembles the per-request tree across router and
replica processes from exactly these three args (trace_id / span_id /
remote_parent).  The router records its per-request span retroactively
(`Tracer.add_span`) under a pinned span id that the replica hop already
named as its remote parent.

"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
import uuid
from typing import Any, Iterator


#: span names the port records and pbccs_tpu does not: the batch polish's
#: steps and the stages of device_refine.slot_grid_partial
PORT_ONLY_SPANS = (
    "polish.dispatch", "polish.gates", "polish.band_retry",
    "polish.straggler", "polish.outcomes", "polish.round.select",
    "polish.round.greedy", "polish.round.apply", "polish.round.rebuild",
    "slot_grid.geometry", "slot_grid.k3", "slot_grid.edge",
    "slot_grid.splice_map", "slot_grid.refill", "fill.guided")


def _profiler_range(name: str):
    """An entered torch.profiler.record_function range of `name` while
    torch.profiler records (torch already imported: no profiler runs
    without it), else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def _device_event(device):
    """A timing CUDA event recorded now on `device`'s current stream, or
    None off a CUDA device, and None where recording fails: a card left
    failing by a launch (which the polish's guard recovers from) costs
    the span its device time, and the program's own call raises the
    error, not the tracer."""
    torch = sys.modules.get("torch")
    if device is None or torch is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    try:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
    except Exception:  # noqa: BLE001 -- tracing never raises into the program
        return None
    return ev


def new_trace_id() -> str:
    """A fresh 16-hex-char request trace id (minted at the first tier
    that sees the request: client, or the router edge)."""
    return uuid.uuid4().hex[:16]


class Span:
    """One finished-or-open span; nesting is per-thread."""

    __slots__ = ("name", "args", "tid", "t0", "t1", "device_wait_s",
                 "parent", "index", "trace_id", "remote_parent", "sid",
                 "open", "events")

    def __init__(self, name: str, args: dict[str, Any], tid: int,
                 t0: float, parent: "Span | None", index: int,
                 trace_id: str | None = None,
                 remote_parent: str | None = None,
                 sid: str | None = None):
        self.name = name
        self.args = args
        self.tid = tid
        self.t0 = t0
        self.t1 = t0
        self.device_wait_s = 0.0
        self.parent = parent
        self.index = index
        self.trace_id = trace_id
        self.remote_parent = remote_parent
        self.sid = sid          # explicit span id (router retro-spans)
        self.open = True
        # CUDA events [opened, closed] of a span opened with a device
        self.events: list | None = None

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Collects spans; thread-safe; export once at the end of a capture.

    `max_spans` bounds the capture: a capture over a whole-cell run must
    not grow until the OOM killer ends it.  Past the cap new spans are
    counted (dropped_spans, surfaced in the export) but not recorded."""

    def __init__(self, max_spans: int = 200_000, tag: str | None = None):
        self.t_origin = time.perf_counter()
        # wall-clock anchor of the perf_counter origin: a trace merger
        # rebases per-process timelines onto one axis with it
        self.t_origin_unix = time.time()
        self.max_spans = max_spans
        # process tag of the export; the random suffix matters because
        # bare pids collide across machines
        self.tag = tag or f"p{os.getpid():x}-{uuid.uuid4().hex[:6]}"
        self.dropped_spans = 0
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._local = threading.local()

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, ctx: dict | None = None, *, device=None,
             **args) -> Iterator[Span | None]:
        """Record one span, nested in the calling thread's innermost open
        span, inside a profiler range of its name while torch.profiler
        records.  `ctx` is an inbound cross-process trace context
        ({"trace_id", "span_id"}): the span adopts its trace_id and
        records its span_id as the REMOTE parent; without ctx the
        trace_id is inherited from the enclosing span (if any).  On a
        CUDA `device` the span also records its device time (module
        docstring)."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        trace_id = remote_parent = None
        if ctx:
            trace_id = ctx.get("trace_id")
            remote_parent = ctx.get("span_id")
        elif parent is not None:
            trace_id = parent.trace_id
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped_spans += 1
                sp = None
            else:
                sp = Span(name, args, threading.get_ident() & 0xFFFFFFFF,
                          time.perf_counter(), parent, len(self._spans),
                          trace_id=trace_id, remote_parent=remote_parent)
                self._spans.append(sp)
        if sp is None:
            yield None
            return
        ev = _device_event(device)
        if ev is not None:
            sp.events = [ev]
        rf = _profiler_range(name)
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.t1 = time.perf_counter()
            sp.open = False
            stack.pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            if ev is not None:
                end = _device_event(device)
                sp.events = None if end is None else [ev, end]

    def add_span(self, name: str, duration_s: float, *,
                 ctx: dict | None = None, span_id: str | None = None,
                 **args) -> Span | None:
        """Record a RETROACTIVE closed span ending now (the router's
        per-request span: its lifetime is only known at completion).
        `span_id` pins the exported id so the forwarding tier could name
        this span as the remote parent BEFORE it was recorded."""
        t1 = time.perf_counter()
        trace_id = remote_parent = None
        if ctx:
            trace_id = ctx.get("trace_id")
            remote_parent = ctx.get("span_id")
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped_spans += 1
                return None
            sp = Span(name, args, threading.get_ident() & 0xFFFFFFFF,
                      t1 - max(duration_s, 0.0), None, len(self._spans),
                      trace_id=trace_id, remote_parent=remote_parent,
                      sid=span_id)
            sp.t1 = t1
            sp.open = False
            self._spans.append(sp)
        return sp

    def span_id_of(self, sp: Span) -> str:
        """The span's fleet-unique exported id."""
        return sp.sid if sp.sid is not None else f"{self.tag}-{sp.index}"

    def context_of(self, sp: Span) -> dict | None:
        """The wire trace context continuing this span on the next hop
        (None when the span belongs to no trace)."""
        if sp.trace_id is None:
            return None
        return {"trace_id": sp.trace_id, "span_id": self.span_id_of(sp)}

    def current_span(self) -> Span | None:
        stack = self._stack()
        return stack[-1] if stack else None

    def add_device_wait(self, dt: float) -> None:
        """Attribute dt blocking seconds to the calling thread's innermost
        open span (no-op when the thread is not inside a span)."""
        stack = self._stack()
        if stack:
            stack[-1].device_wait_s += dt

    # ------------------------------------------------------------ reading

    def finished_spans(self) -> list[Span]:
        """Snapshot of spans recorded so far.  Open spans are included
        with `open` still True and t1 frozen at their start; the Chrome
        export tags them (args.open) and measures them to the capture
        instant so a mid-flight capture never renders zero-duration
        lies.  A closed span whose closing CUDA event has completed gets
        its `device_ms` in its args here."""
        with self._lock:
            spans = list(self._spans)
        for sp in spans:
            ev = sp.events
            if ev is None or sp.open:
                continue
            try:
                done = ev[1].query()
                if done:
                    sp.args["device_ms"] = ev[0].elapsed_time(ev[1])
            except Exception:  # noqa: BLE001 -- a failed card: no device time
                done = True
            if done:
                sp.events = None
        return spans

    def to_chrome(self) -> dict[str, Any]:
        """Chrome-trace JSON object.  ts/dur are microseconds from the
        tracer's origin; device-wait attribution and the parent span index
        ride in args (the span TREE survives the round trip).  Spans
        still OPEN at capture time are tagged args.open=true with their
        duration measured up to the capture instant -- a mid-flight
        capture renders them honestly instead of as zero-duration lies.
        The `meta` block (dropped/open counts, process tag, wall-clock
        origin) is what tools/trace_merge.py keys the multi-process
        merge on."""
        now = time.perf_counter()
        open_spans = 0
        events = []
        for sp in self.finished_spans():
            args = dict(sp.args)
            args["device_wait_ms"] = round(sp.device_wait_s * 1e3, 3)
            if sp.parent is not None:
                args["parent"] = sp.parent.index
            if sp.trace_id is not None:
                args["trace_id"] = sp.trace_id
                args["span_id"] = self.span_id_of(sp)
            elif sp.sid is not None:
                args["span_id"] = sp.sid
            if sp.remote_parent is not None:
                args["remote_parent"] = sp.remote_parent
            t1 = sp.t1
            if sp.open:
                open_spans += 1
                args["open"] = True
                t1 = max(now, sp.t0)
            events.append({
                "name": sp.name,
                "cat": "ccs",
                "ph": "X",
                "pid": 0,
                "tid": sp.tid,
                "ts": round((sp.t0 - self.t_origin) * 1e6, 1),
                "dur": round((t1 - sp.t0) * 1e6, 1),
                "id": sp.index,
                "args": args,
            })
        out = {"traceEvents": events, "displayTimeUnit": "ms",
               "meta": {"process": self.tag,
                        "origin_unix": self.t_origin_unix,
                        "dropped_spans": self.dropped_spans,
                        "open_spans": open_spans}}
        if self.dropped_spans:
            out["droppedSpans"] = self.dropped_spans  # legacy key
        return out

    def write_json(self, path: str) -> None:
        # atomic publish: a truncated trace JSON is unreadable by the
        # Chrome viewer, so never leave a torn one
        from pbccs_tpu_torch.resilience.resources import atomic_output

        with atomic_output(path, "trace") as f:
            json.dump(self.to_chrome(), f)


def span_tree(chrome: dict[str, Any]) -> dict[int | None, list[dict]]:
    """Rebuild parent -> children from an exported Chrome-trace object
    (the inverse of Tracer.to_chrome)."""
    tree: dict[int | None, list[dict]] = {}
    for ev in chrome.get("traceEvents", []):
        tree.setdefault(ev.get("args", {}).get("parent"), []).append(ev)
    return tree


# ------------------------------------------------------------- global hook

_tracer: Tracer | None = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer | None:
    return _tracer


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or clear) the process-wide tracer; returns the previous
    one so nested captures can restore it."""
    global _tracer
    with _tracer_lock:
        prev, _tracer = _tracer, tracer
    return prev


def install_tracer(tracer: Tracer) -> bool:
    """Compare-and-swap install: succeeds only when no capture is live.
    Concurrent owners (two in-process CLI runs with --trace-out) must use
    this, not set_tracer, so one cannot silently hijack the other's
    capture."""
    global _tracer
    with _tracer_lock:
        if _tracer is not None:
            return False
        _tracer = tracer
        return True


def clear_tracer(expected: Tracer) -> bool:
    """Compare-and-swap clear: uninstalls only if `expected` is still the
    live tracer (never tears down someone else's capture)."""
    global _tracer
    with _tracer_lock:
        if _tracer is not expected:
            return False
        _tracer = None
        return True


@contextlib.contextmanager
def span(name: str, ctx: dict | None = None, *, device=None,
         **args) -> Iterator[Span | None]:
    """Record a span on the installed tracer; no-op (one global read: no
    profiler range, no CUDA event) when tracing is off.  `ctx` carries an
    inbound cross-process trace context, `device` the device whose time
    the span records (see Tracer.span)."""
    t = _tracer
    if t is None:
        yield None
        return
    with t.span(name, ctx=ctx, device=device, **args) as sp:
        yield sp


def add_device_wait(dt: float) -> None:
    t = _tracer
    if t is not None:
        t.add_device_wait(dt)


def current_context() -> dict | None:
    """Wire trace context of the calling thread's innermost open span on
    the installed tracer (None when tracing is off or the span carries
    no trace id) -- what a client attaches to an outbound submit."""
    t = _tracer
    if t is None:
        return None
    sp = t.current_span()
    if sp is None:
        return None
    return t.context_of(sp)
