"""CcsEngine: the long-lived online CCS serving core.

Port of pbccs_tpu.serve.engine: the same admission, batching, stages,
metrics, SLO plane, governor pre-split and ledger records.  Owns the
card (its CUDA context, allocator and loaded kernels) for the lifetime
of the process and turns independently-arriving ZMW requests into the
lockstep batch polish the card wants (parallel.batch.BatchPolisher via
pipeline.polish_prepared_batch, which launches K1 and K3).  The offline
CLI knows its whole workload up front; the engine does not, so it:

  * admits requests through a BOUNDED pool (max_pending): a full engine
    rejects with EngineOverloaded instead of growing without bound --
    the server maps this to a structured `overloaded` reply and the
    client retries (backpressure reaches the edge instead of the OOM
    killer);
  * preps admitted requests (filter -> POA draft -> mapping, the host
    stages) on a small worker pool, then parks them in the dynamic
    batcher under their (Jmax, Imax) length bucket
    (parallel.batch.length_bucket);
  * flushes a bucket to the polish executor when it fills (max_batch)
    or when its oldest request's deadline slack expires
    (min(admit + max_wait, deadline - polish_margin); see
    serve.batcher), so a lone request never waits longer than its slack
    for company;
  * completes each request individually (out-of-order across batches)
    through its callback/event -- a raising request or batch fails THAT
    batch's requests with a structured error and the engine keeps
    serving.

The card itself is single-owner: polish batches run on a dedicated
executor (default 1 worker -- one lockstep batch on the card at a time;
host stages live on the prep workers).  What the port adds:

  * `device`: the engine polishes on the card unless the caller passes
    another (device="cpu" runs the kernels' plain versions, as the tests
    do); asking for CUDA with no card raises at construction.  Nothing
    falls back to the CPU.
  * One stream per card: prep workers make no CUDA tensor; the polish
    executor (in pool mode each sched.DevicePool worker) runs under
    `torch.cuda.device(card)` and the governor's `device_scope`, and
    uploads the batch itself; the completion path only builds replies
    from host results.
  * Shape pinning: a flush polishes at the batch path's (Imax, Jmax, R)
    of its ZMWs and Z = next_pow2(n, 4) (the fourth `buckets` element
    of polish_prepared_batch).  torch's CUDA reductions pick their
    summation order by shape, so a flush gives bitwise the records of
    polish_prepared_batch at the same four shapes.  pbccs_tpu rounds R
    to a power of two as well, to bound its compiled-program menu; the
    port takes the batch path's R (reads padded to 4), so a full flush
    of a batch's ZMWs matches the batch CLI's records byte for byte.
  * Device errors: polish_prepared_batch re-raises a device-shaped error
    (device.is_device_error: KernelError, LaunchRefused, a CUDA error)
    instead of bisecting; the batch's requests get a structured error
    naming it and the engine keeps serving.
  * The watchdog (`polish_timeout_ms`, resilience.watchdog.
    run_with_deadline) turns a slow dispatch into a timeout reply, as
    pbccs_tpu's does.  It cannot stop a kernel already running: the
    abandoned dispatch runs on, and the next batch queues behind it on
    the same stream."""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Sequence

from pbccs_tpu_torch.device import resolve_device
from pbccs_tpu_torch.obs import flight as _obs_flight  # noqa: F401 -- import
# registers the refine-loop gauges, so an idle replica's exposition
# still carries ccs_refine_* series (zeroes) until first traffic
from pbccs_tpu_torch.obs import roofline as obs_roofline
from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.obs.metrics import default_registry, log_buckets
from pbccs_tpu_torch.pipeline import (
    Chunk,
    ConsensusResult,
    ConsensusSettings,
    Failure,
    PreparedZmw,
    polish_prepared_batch,
    prepare_chunk,
)
from pbccs_tpu_torch.resilience import resources
from pbccs_tpu_torch.runtime import timing
from pbccs_tpu_torch.runtime.logging import Logger
from pbccs_tpu_torch.sched.pool import device_name, on_device
from pbccs_tpu_torch.serve.batcher import Batch, DynamicBatcher, PendingItem

_reg = default_registry()
_m_admitted = _reg.counter("ccs_serve_admitted_total",
                           "Requests admitted past the bounded pool")
_m_rejected = _reg.counter("ccs_serve_rejected_total",
                           "Submits rejected as overloaded")
_m_completed = _reg.counter("ccs_serve_completed_total",
                            "Requests completed (any outcome)")
_m_errors = _reg.counter("ccs_serve_errors_total",
                         "Requests completed with a structured error")
_m_pending = _reg.gauge("ccs_serve_pending",
                        "Admitted-but-incomplete requests")
_m_inflight_batches = _reg.gauge("ccs_serve_in_flight_batches",
                                 "Polish batches dispatched, not finished")
_m_inflight_zmws = _reg.gauge("ccs_serve_in_flight_zmws",
                              "ZMWs inside in-flight polish batches")
# admission-to-completion latency; log buckets 1 ms .. ~5 min
_m_latency = _reg.histogram("ccs_serve_request_latency_seconds",
                            "Admission-to-completion request latency (s)",
                            buckets=log_buckets(1e-3, 300.0))
# SLO plane: per-request stage intervals (the latency story decomposed:
# admission wait -> prepare -> batcher queue -> dispatch wait -> polish
# -> emit) and the --sloP99Ms burn-rate counters.  Stage handles are
# pre-created (hot path holds direct references).
_STAGE_BUCKETS = log_buckets(1e-4, 300.0)
_m_stages = {stage: _reg.histogram(
    "ccs_serve_stage_latency_seconds",
    "Per-request stage intervals (admission wait, prepare, batcher "
    "queue, dispatch wait, polish, emit)",
    buckets=_STAGE_BUCKETS, stage=stage)
    for stage in ("admission", "prepare", "queue", "dispatch", "polish",
                  "emit")}
_m_slo_requests = _reg.counter(
    "ccs_slo_requests_total",
    "Requests measured against the --sloP99Ms latency objective")
_m_slo_violations = _reg.counter(
    "ccs_slo_violations_total",
    "Requests whose admission-to-completion latency exceeded --sloP99Ms "
    "(burn-rate numerator; ccs_slo_requests_total is the denominator)")


def _flush_shapes(preps: Sequence[PreparedZmw]) -> tuple[int, int, int]:
    """The (imax, jmax, r) bucket a flush of these preps polishes in --
    the ONE derivation shared by the pinned polish call and the
    capacity-bucket key, so the governor ceiling the pool records is
    the same key the polish-time admission pre-split looks up.  It is
    the batch path's own (parallel.batch.effective_shapes)."""
    from pbccs_tpu_torch.parallel.batch import effective_shapes

    imax, jmax, r, _ = effective_shapes(
        len(preps), max(len(p.mapped) for p in preps),
        max((len(m.seq) for p in preps for m in p.mapped), default=8),
        max(len(p.css) for p in preps))
    return imax, jmax, r


def flush_buckets(preps: Sequence[PreparedZmw]) -> tuple[int, int, int, int]:
    """The (Imax, Jmax, R, Z) a flush of these preps polishes at: its
    shape bucket and Z = next_pow2(n, 4), so flushes of 1..max_batch
    ZMWs run at a few Z only."""
    from pbccs_tpu_torch.utils import next_pow2

    return (*_flush_shapes(preps), next_pow2(len(preps), 4))


def _polish_shape_pinned(preps: Sequence[PreparedZmw], settings, *,
                         device=None, raise_device_shaped: bool = False):
    """polish_prepared_batch on `device` with every shape pinned to
    flush_buckets(preps)."""
    return polish_prepared_batch(preps, settings, device=device,
                                 buckets=flush_buckets(preps),
                                 raise_device_shaped=raise_device_shaped)


class EngineOverloaded(RuntimeError):
    """Admission pool full: shed load, client should retry with backoff."""


class EngineClosed(RuntimeError):
    """Engine is shutting down (or never started); no new requests."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (see module docstring for the policy they drive)."""

    max_batch: int = 16            # bucket fill-flush size (ZMWs per batch)
    max_wait_ms: float = 250.0     # max time a request waits to be batched
    max_pending: int = 256         # admitted-but-incomplete request bound
    prep_workers: int = 2          # host draft/mapping threads
    polish_workers: int = 1        # concurrent device batches (devices=1)
    # polish across a device fleet (sched.DevicePool): N>1 uses the first
    # N visible cards, 0 all of them, 1 (default) the single-device
    # polish executor.  Flushed buckets route STICKY by shape bucket
    # (sched_policy), a repeatedly-failing device is benched and its
    # batches requeue to healthy devices.
    devices: int = 1
    sched_policy: str = "sticky"   # sticky | least | roundrobin
    default_deadline_ms: float = 60_000.0   # per-request deadline default
    polish_margin_ms: float = 0.0  # slack reserved for the polish itself
    # the offline CLI's read-score input gate (cli.py --minReadScore),
    # applied at admission so serve and offline see the same read sets
    min_read_score: float = 0.75
    # watchdog deadline per polish batch (resilience.watchdog): a hung
    # device program becomes a structured timeout error on THAT batch's
    # requests and the engine keeps serving.  0 disables.  Size it well
    # above a worst-case polish incl. quarantine bisection re-dispatches.
    polish_timeout_ms: float = 0.0
    # ---- wire-protocol armor (enforced by server._Session) ----
    # longest accepted NDJSON frame; an oversized frame gets a
    # `bad_request` reply and the session closes (the line buffer is the
    # only per-session allocation an untrusted peer controls)
    max_line_bytes: int = 8 << 20
    # submits one session may have in flight before further submits are
    # rejected `overloaded` WITHOUT touching the engine (one hostile
    # session cannot monopolize the shared admission pool)
    max_inflight_per_session: int = 64
    # reap sessions with nothing in flight that send no byte for this
    # long (slow-loris defense); 0 disables
    idle_timeout_s: float = 600.0
    # ---- SLO plane ----
    # per-request latency objective in ms (--sloP99Ms): requests slower
    # than this count into ccs_slo_violations_total (burn-rate
    # numerator) and the status verb's `slo` block.  0 disables.
    slo_p99_ms: float = 0.0
    # ---- performance ledger (obs.ledger) ----
    # append schema-versioned NDJSON perf records to this path
    # (--perfLedger): one snapshot every perf_ledger_interval_s plus a
    # final one at close, and the status verb grows a `perf` block the
    # router federates fleet-wide.  None disables.
    perf_ledger_path: str | None = None
    perf_ledger_interval_s: float = 30.0


@dataclasses.dataclass
class Request:
    """One in-flight ZMW request; completed exactly once."""

    seq: int
    chunk: Chunk
    submit_t: float                  # monotonic admission time
    deadline_t: float                # monotonic absolute deadline
    callback: Callable[["Request"], None] | None = None
    # inbound cross-process trace context ({"trace_id", "span_id"}, the
    # protocol's `trace` submit field): engine spans parent under it
    trace_ctx: dict | None = None
    # outcome (exactly one of failure or error set at completion)
    failure: Failure | None = None
    result: ConsensusResult | None = None
    error: str | None = None
    latency_ms: float = 0.0
    # stage timestamps (monotonic; 0.0 = stage never reached) feeding
    # the ccs_serve_stage_latency_seconds histograms at completion
    t_prep0: float = 0.0
    t_prep1: float = 0.0
    t_dispatch: float = 0.0
    t_polish0: float = 0.0
    t_polish1: float = 0.0
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    def wait(self, timeout: float | None = None) -> bool:
        return self.done.wait(timeout)


class CcsEngine:
    """Long-lived dynamic-batching consensus engine (see module doc)."""

    def __init__(self, settings: ConsensusSettings | None = None,
                 config: ServeConfig | None = None, *,
                 prep_fn: Callable[..., tuple[Failure | None,
                                              PreparedZmw | None]] | None = None,
                 polish_fn: Callable[..., list[tuple[Failure,
                                                     ConsensusResult | None]]]
                 | None = None,
                 logger: Logger | None = None,
                 device=None):
        """prep_fn/polish_fn default to the real pipeline stages; tests
        inject stubs to exercise scheduling without device work.
        `device`: the card by default (raises when there is none);
        "cpu" polishes with the kernels' plain versions."""
        self.settings = settings or ConsensusSettings()
        self.config = config or ServeConfig()
        self.device = resolve_device(device)
        self._prep_fn = prep_fn or prepare_chunk
        self._polish_fn = polish_fn or _polish_shape_pinned
        self._log = logger or Logger.default()

        self._lock = threading.Lock()
        self._window = timing.window()   # re-opened at start()
        self._trace_lock = threading.Lock()
        self._capture: obs_trace.Tracer | None = None
        self._seq = 0
        self._pending = 0            # admitted, not yet completed
        self._admitted = 0
        self._rejected = 0
        self._completed = 0
        self._errors = 0
        self._in_flight_batches = 0
        self._in_flight_zmws = 0
        self._prep_queue: queue.Queue[Request | None] = queue.Queue()
        self._batcher = DynamicBatcher(self.config.max_batch)
        self._wake = threading.Condition()
        self._closed = True
        self._abort = False
        self._stop_flush = False
        self._start_t = 0.0
        self._threads: list[threading.Thread] = []
        self._pool = None   # DevicePool when config.devices != 1
        self._complete_queue = None   # fleet-mode completion hand-off
        self._complete_thread = None
        self._n_polish_workers = 0   # set by start(); close() must not
        # depend on attributes a failed start() never assigned
        # performance ledger (obs.ledger): periodic snapshot records
        # while serving + a final record at close
        self._ledger = None
        self._ledger_stop = threading.Event()
        self._ledger_thread: threading.Thread | None = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "CcsEngine":
        with self._lock:
            if not self._closed:
                return self
            self._closed = False
            self._abort = False
            self._stop_flush = False
        self._start_t = time.monotonic()
        # the engine's OWN measurement window: a timing.reset() elsewhere
        # in the process (bench.py) no longer clobbers engine counters
        self._window = timing.window()
        # pick up CostCards minted by an earlier warmup process so the
        # roofline block/gauges have bounds before the first polish
        obs_roofline.tracker().load_persisted()
        n_polish = self.config.polish_workers
        if self.config.devices != 1:
            # device-fleet mode: the DevicePool's per-device executor
            # threads replace the single polish executor; flushed buckets
            # route sticky by shape bucket (sched/)
            from pbccs_tpu_torch.sched import (DevicePool, DevicePoolConfig,
                                               select_devices)

            try:
                devs = select_devices(self.config.devices, self.device)
            except ValueError as e:
                raise ValueError(f"ServeConfig.devices: {e}") from None
            pool = DevicePool(
                devs, DevicePoolConfig(policy=self.config.sched_policy),
                logger=self._log)
            n_polish = 0
            # batch completions run arbitrary caller code (replies on a
            # possibly-slow client socket, bounded only by the session's
            # idle timeout): hand them to a dedicated thread so a stalled
            # send blocks this thread, never a device executor
            complete_queue = queue.Queue()
            complete_thread = threading.Thread(
                target=self._completion_worker, daemon=True,
                name="ccs-serve-complete")
            # publish under the lock: status() and close() read these
            # attributes from other threads (ccs-analyze CONC001)
            with self._lock:
                self._pool = pool
                self._complete_queue = complete_queue
                self._complete_thread = complete_thread
            complete_thread.start()
        self._threads = [
            threading.Thread(target=self._prep_worker, daemon=True,
                             name=f"ccs-serve-prep-{i}")
            for i in range(self.config.prep_workers)
        ] + [
            threading.Thread(target=self._flush_loop, daemon=True,
                             name="ccs-serve-batcher"),
        ] + [
            threading.Thread(target=self._polish_worker, daemon=True,
                             name=f"ccs-serve-polish-{i}")
            for i in range(n_polish)
        ]
        self._n_polish_workers = n_polish
        self._polish_queue: queue.Queue[Batch | None] = queue.Queue()
        for t in self._threads:
            t.start()
        if self.config.perf_ledger_path:
            from pbccs_tpu_torch.obs.ledger import PerfLedger

            ledger = PerfLedger(self.config.perf_ledger_path,
                                logger=self._log)
            ledger_thread = threading.Thread(
                target=self._ledger_worker, args=(ledger,), daemon=True,
                name="ccs-serve-ledger")
            self._ledger_stop.clear()
            with self._lock:
                self._ledger = ledger
                self._ledger_thread = ledger_thread
            ledger_thread.start()
        self._log.info(
            f"ccs engine up: max_batch={self.config.max_batch} "
            f"max_wait={self.config.max_wait_ms}ms "
            f"max_pending={self.config.max_pending}"
            + (f" devices={self._pool.n_devices}" if self._pool else ""))
        return self

    def close(self, drain: bool = True,
              deadline_s: float | None = None) -> bool:
        """Stop admission; with drain (default) finish everything already
        admitted, else fail pending requests with a `closed` error.

        ``deadline_s`` bounds the drain wait: past it the engine falls
        back to fast abort (remaining requests fail with a structured
        `closed` error) instead of hanging shutdown on a stuck device.
        Returns True when every admitted request completed normally."""
        with self._lock:
            if self._closed:
                return True
            self._closed = True
            self._abort = not drain
            pending0 = self._pending
        # drain=False with requests in the system WILL fail them with a
        # `closed` error -- that is not a clean drain
        drained = drain or pending0 == 0
        if drain:
            # wait for admitted requests to complete (they flow through
            # prep -> batcher -> polish on their own; the flush loop ships
            # not-yet-due buckets immediately once it sees _closed)
            give_up_at = (time.monotonic() + deadline_s
                          if deadline_s else None)
            while True:
                with self._lock:
                    if self._pending == 0:
                        break
                    pending = self._pending
                if give_up_at is not None and time.monotonic() > give_up_at:
                    with self._lock:
                        self._abort = True
                    drained = False
                    self._log.warn(
                        f"drain deadline ({deadline_s}s) exceeded with "
                        f"{pending} request(s) pending: aborting")
                    break
                with self._wake:
                    self._wake.notify_all()
                time.sleep(0.01)
        # stop the workers (flush loop last: it must outlive the preps so
        # a request prepped during the drain still gets shipped)
        for _ in range(self.config.prep_workers):
            self._prep_queue.put(None)
        with self._wake:
            self._wake.notify_all()
        for t in self._threads:
            if t.name.startswith("ccs-serve-prep"):
                t.join(timeout=10.0)
        with self._lock:
            self._stop_flush = True
        with self._wake:
            self._wake.notify_all()
        for _ in range(self._n_polish_workers):
            self._polish_queue.put(None)
        for t in self._threads:
            t.join(timeout=10.0)
        with self._lock:
            aborted = self._abort
            pool = self._pool
            complete_thread = self._complete_thread
            complete_queue = self._complete_queue
        if pool is not None:
            # draining already waited for in-flight batches; an abort
            # fails queued pool tasks (their callbacks complete the
            # requests with a structured error) and bounds the worker
            # joins like the legacy polish-worker path, so a hung device
            # program cannot hold the drain-deadline fallback hostage
            pool.close(wait=not aborted,
                       join_timeout_s=10.0 if aborted else 60.0)
            with self._lock:
                self._pool = None
        if complete_thread is not None:
            # after pool.close() every settled future has enqueued its
            # completion; the sentinel lands behind them all
            complete_queue.put(None)
            complete_thread.join(timeout=10.0)
            with self._lock:
                self._complete_thread = None
        if aborted:
            # fail whatever is still parked anywhere
            leftovers = [i.payload[0] for b in self._batcher.drain()
                         for i in b.items]
            while True:
                try:
                    req = self._prep_queue.get_nowait()
                except queue.Empty:
                    break
                if req is not None:
                    leftovers.append(req)
            for req in leftovers:
                self._complete_error(req, "engine closed")
        # performance ledger: stop the snapshot loop, then one FINAL
        # record so a short-lived engine still leaves a run record
        with self._lock:
            ledger = self._ledger
            ledger_thread = self._ledger_thread
            self._ledger = None
            self._ledger_thread = None
        if ledger is not None:
            self._ledger_stop.set()
            if ledger_thread is not None:
                ledger_thread.join(timeout=10.0)
            ledger.append(self._ledger_record())
            ledger.close()
        self.trace_stop()  # never leak a live capture past the engine
        self._log.info("ccs engine down")
        return drained

    def __enter__(self) -> "CcsEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- admission

    def submit(self, chunk: Chunk, deadline_ms: float | None = None,
               callback: Callable[[Request], None] | None = None,
               trace_ctx: dict | None = None) -> Request:
        """Admit one ZMW; returns its Request handle (completes via
        callback and/or .wait()).  `trace_ctx` is the request's inbound
        cross-process trace context (protocol `trace` field); engine
        spans parent under it.  Raises EngineOverloaded when max_pending
        requests are in the system and EngineClosed after close()."""
        now = time.monotonic()
        deadline_ms = (self.config.default_deadline_ms
                       if deadline_ms is None else float(deadline_ms))
        with self._lock:
            if self._closed:
                raise EngineClosed("engine is not accepting requests")
            if self._pending >= self.config.max_pending:
                self._rejected += 1
                _m_rejected.inc()
                raise EngineOverloaded(
                    f"{self._pending} requests pending (max "
                    f"{self.config.max_pending})")
            self._pending += 1
            self._admitted += 1
            _m_admitted.inc()
            _m_pending.inc()
            self._seq += 1
            req = Request(seq=self._seq, chunk=chunk, submit_t=now,
                          deadline_t=now + deadline_ms / 1e3,
                          callback=callback, trace_ctx=trace_ctx)
        self._prep_queue.put(req)
        return req

    # ---------------------------------------------------------------- stages

    def _prep_worker(self) -> None:
        while True:
            req = self._prep_queue.get()
            if req is None:
                return
            with self._lock:
                aborting = self._abort
            if aborting:
                self._complete_error(req, "engine closed")
                continue
            # the offline CLI's read-score input gate (cli.py), applied
            # pre-draft so serve and offline polish the same read sets
            kept = [r for r in req.chunk.reads
                    if r.read_accuracy >= self.config.min_read_score]
            if len(kept) != len(req.chunk.reads):
                req.chunk = Chunk(req.chunk.id, kept, req.chunk.snr)
            req.t_prep0 = time.monotonic()
            try:
                with obs_trace.span("serve.prep", ctx=req.trace_ctx,
                                    zmw=req.chunk.id), \
                        timing.stage("serve.prep"):
                    failure, prep = self._prep_fn(req.chunk, self.settings)
            except Exception as e:  # noqa: BLE001 -- isolate the request
                self._complete_error(req, f"prep failed: {e!r}")
                continue
            req.t_prep1 = time.monotonic()
            if failure is not None:
                self._complete(req, failure, None)
                continue
            from pbccs_tpu_torch.parallel.batch import length_bucket

            key = length_bucket(
                len(prep.css),
                max((len(m.seq) for m in prep.mapped), default=8))
            slack_end = req.deadline_t - self.config.polish_margin_ms / 1e3
            flush_by = min(req.submit_t + self.config.max_wait_ms / 1e3,
                           slack_end)
            filled = self._batcher.add(PendingItem(
                key=key, payload=(req, prep), admit_t=req.submit_t,
                flush_by=flush_by))
            if filled is not None:
                self._dispatch(filled)
            else:
                with self._wake:
                    self._wake.notify_all()  # re-arm the flush timer

    def _flush_loop(self) -> None:
        """Sleep until the earliest flush-by, then ship due buckets.

        Exits only on _stop_flush (set after the prep workers join), so a
        request prepped during a close() drain is still shipped."""
        while True:
            with self._lock:
                if self._stop_flush:
                    return
                closed = self._closed
            with self._wake:
                nxt = self._batcher.next_deadline()
                if nxt is None:
                    # closed-but-empty still naps: close() may be waiting
                    # on in-flight polishes and this must not busy-spin
                    self._wake.wait(timeout=0.05 if closed else 0.2)
                else:
                    delay = nxt - time.monotonic()
                    if delay > 0 and not closed:
                        self._wake.wait(timeout=min(delay, 0.2))
            with self._lock:
                closed = self._closed
            batches = self._batcher.due(time.monotonic())
            if closed:
                # shutting down: ship everything, due or not
                batches += self._batcher.drain()
            for batch in batches:
                self._dispatch(batch)

    def _capacity_bucket(self, batch: Batch):
        """The resources.shape_bucket this flush polishes in (the shape
        derivation is _flush_shapes, shared with _polish_shape_pinned),
        so governor ceilings learned at dispatch time pre-split later
        flushes."""
        preps = [item.payload[1] for item in batch.items]
        return resources.shape_bucket(*_flush_shapes(preps))

    def _dispatch(self, batch: Batch) -> None:
        # serve flushes consult the governor's learned ceilings: a
        # bucket that ran out of memory at some Z dispatches as
        # ceiling-sized sub-batches from the start, instead of paying
        # the OOM again.  The key is the card's name (cuda:0); in pool
        # mode the target card is not picked yet, so the fleet-wide
        # minimum applies
        bucket = self._capacity_bucket(batch)
        with self._lock:
            pool = self._pool
        cap = resources.default_governor().cap(
            bucket, device=None if pool is not None
            else device_name(self.device))
        parts = [batch]
        if cap is not None and len(batch.items) > cap:
            resources.note_presplit()
            # capacity-split postmortem: what the refine loops were doing
            # just before the governor had to intervene
            from pbccs_tpu_torch.obs import flight

            flight.dump("capacity-split", self._log)
            self._log.info(
                f"flush bucket={batch.key}: governor ceiling {cap} "
                f"splits {len(batch.items)} ZMW(s) into "
                f"{len(resources.split_sizes(len(batch.items), cap))} "
                "dispatches")
            parts, start = [], 0
            for size in resources.split_sizes(len(batch.items), cap):
                parts.append(Batch(batch.key,
                                   batch.items[start:start + size],
                                   batch.reason))
                start += size
        for part in parts:
            self._dispatch_part(part, bucket)

    def _dispatch_part(self, batch: Batch, capacity_bucket) -> None:
        now = time.monotonic()
        for item in batch.items:
            item.payload[0].t_dispatch = now
        with self._lock:
            self._in_flight_batches += 1
            self._in_flight_zmws += len(batch.items)
        _m_inflight_batches.inc()
        _m_inflight_zmws.inc(len(batch.items))
        self._log.debug(
            f"flush bucket={batch.key} n={len(batch.items)} "
            f"reason={batch.reason}")
        if self._pool is not None:
            # device-fleet mode: the pool picks the device (sticky by the
            # batch's shape bucket); a device-shaped failure requeues the
            # WHOLE batch to a healthy device before the requests see an
            # error (sched/), and a capacity-shaped one records a
            # governor ceiling + requeues to the same device for a split
            # re-dispatch.  The task runs on the pool worker's thread,
            # under its card and governor scope.
            attempts = [0]

            def run(device, batch=batch, attempts=attempts):
                attempts[0] += 1
                return self._run_polish(batch, device,
                                        first_attempt=attempts[0] == 1)

            self._pool.submit(
                batch.key, run, zmws=len(batch.items),
                capacity_bucket=capacity_bucket,
                callback=lambda fut: self._pool_done(batch, fut))
        else:
            self._polish_queue.put(batch)

    def _run_polish(self, batch: Batch, device,
                    first_attempt: bool = False) -> list:
        """One batch through the polish fn on `device` under the
        watchdog; raises on failure (the caller routes the error to this
        batch's requests).  On a fleet's first attempt the default polish
        fn also re-raises a watchdog timeout or exhausted retries instead
        of quarantining in place, so the pool can bench the sick device
        and requeue the whole batch to a healthy one -- mirroring the
        batch executor (sched/executor.py)."""
        raise_dev = (first_attempt and self._pool is not None
                     and self._pool.n_devices > 1
                     and self._polish_fn is _polish_shape_pinned)
        preps = [item.payload[1] for item in batch.items]
        reqs = [item.payload[0] for item in batch.items]
        # batch-level span: parents under the FIRST traced request's
        # context; every member trace id rides in args so the fleet
        # merge can associate the shared device work with each request
        ctx = next((r.trace_ctx for r in reqs if r.trace_ctx), None)
        trace_ids = sorted({r.trace_ctx["trace_id"] for r in reqs
                            if r.trace_ctx})[:32]
        t_polish0 = time.monotonic()
        for req in reqs:
            req.t_polish0 = t_polish0
        try:
            # per-dispatch roofline scope keyed by the flush's shape
            # bucket; reentrancy-guarded, so in fleet mode (this method
            # runs inside a pool task that opened its own scope) only the
            # pool's outer scope counts
            rl_label = obs_roofline.bucket_label(*_flush_shapes(preps))
            with obs_trace.span("serve.polish", ctx=ctx,
                                bucket=str(batch.key),
                                zmws=len(batch.items),
                                reason=batch.reason,
                                trace_ids=trace_ids), \
                    timing.stage("serve.polish"), \
                    obs_roofline.dispatch_scope(rl_label,
                                                zmws=len(batch.items)):
                outcomes = self._run_polish_inner(preps, device, raise_dev,
                                                  first_attempt)
        finally:
            t_polish1 = time.monotonic()
            for req in reqs:
                req.t_polish1 = t_polish1
        if len(outcomes) != len(batch.items):
            raise RuntimeError(
                f"polish returned {len(outcomes)} outcomes for "
                f"{len(batch.items)} requests")
        return outcomes

    def _run_polish_inner(self, preps, device, raise_dev: bool,
                          first_attempt: bool) -> list:
        from pbccs_tpu_torch.resilience.watchdog import (WatchdogTimeout,
                                                         run_with_deadline)

        kw = {}
        if self._polish_fn is _polish_shape_pinned:
            kw["device"] = device
        if raise_dev:
            kw["raise_device_shaped"] = True
        # the watchdog turns a hung dispatch into a structured timeout on
        # THIS batch's requests; the engine keeps serving.  The polish
        # enters its card and governor scope (a re-entry on a pool
        # worker, which entered them already)
        key = device_name(device)

        def polish():
            with on_device(device), resources.device_scope(key):
                return self._polish_fn(preps, self.settings, **kw)

        try:
            return run_with_deadline(polish,
                                     self.config.polish_timeout_ms / 1e3,
                                     site="serve.polish")
        except WatchdogTimeout as e:
            if not first_attempt and self._pool is not None:
                # a SECOND expiry on a different device is workload-
                # shaped (the batch is just slower than the deadline,
                # e.g. a kernel build), not sick hardware: wrap it so
                # the pool fails the batch instead of striking another
                # healthy device and touring the whole fleet at one
                # full timeout per hop
                raise RuntimeError(
                    f"polish timed out on two devices: {e}") from e
            raise

    def _complete_batch(self, batch: Batch, outcomes: list | None = None,
                        error: BaseException | None = None) -> None:
        reqs = [item.payload[0] for item in batch.items]
        pairs: list = []
        if error is None:
            # validate shape BEFORE completing anything: a malformed
            # outcome must fail the whole batch, never complete part of
            # it and strand the rest (in pool mode this runs inside a
            # SchedFuture callback, where an escaped exception is only
            # debug-logged)
            try:
                pairs = [(failure, result) for failure, result in outcomes]
            except Exception as e:  # noqa: BLE001
                error = RuntimeError(f"malformed polish outcomes: {e!r}")
        try:
            if error is not None:
                for req in reqs:
                    self._complete_error(req, f"polish failed: {error!r}")
            else:
                for req, (failure, result) in zip(reqs, pairs):
                    self._complete(req, failure, result)
        finally:
            # in-flight accounting must survive any completion error or
            # close(drain=True) spins forever waiting on this batch
            with self._lock:
                self._in_flight_batches -= 1
                self._in_flight_zmws -= len(batch.items)
            _m_inflight_batches.dec()
            _m_inflight_zmws.dec(len(batch.items))

    def _pool_done(self, batch: Batch, fut) -> None:
        # runs on a device executor thread: hand off immediately so the
        # device goes back to polishing while replies hit client sockets
        exc = fut.exception()
        self._complete_queue.put(
            (batch, None if exc is not None else fut.result(), exc))

    def _completion_worker(self) -> None:
        while True:
            item = self._complete_queue.get()
            if item is None:
                return
            batch, outcomes, error = item
            try:
                self._complete_batch(batch, outcomes, error=error)
            except Exception as e:  # noqa: BLE001 -- the completer must
                # outlive any one batch (accounting already ran in
                # _complete_batch's finally)
                self._log.warn(f"batch completion failed: {e!r}")

    def _polish_worker(self) -> None:
        while True:
            batch = self._polish_queue.get()
            if batch is None:
                return
            try:
                outcomes = self._run_polish(batch, self.device)
            except Exception as e:  # noqa: BLE001 -- fail THIS batch only
                self._complete_batch(batch, error=e)
            else:
                self._complete_batch(batch, outcomes)

    # ------------------------------------------------------------ completion

    @staticmethod
    def _observe_stages(req: Request, now: float) -> None:
        """Per-request stage intervals into the SLO histograms.  Stages a
        request never reached (early failure, prep-side yield gate) are
        skipped, not recorded as zero; clock jitter is clamped at 0."""
        marks = (("admission", req.submit_t, req.t_prep0),
                 ("prepare", req.t_prep0, req.t_prep1),
                 ("queue", req.t_prep1, req.t_dispatch),
                 ("dispatch", req.t_dispatch, req.t_polish0),
                 ("polish", req.t_polish0, req.t_polish1),
                 ("emit", req.t_polish1, now))
        for stage, t0, t1 in marks:
            if t0 > 0.0 and t1 > 0.0:
                _m_stages[stage].observe(max(t1 - t0, 0.0))

    def _finish(self, req: Request) -> None:
        now = time.monotonic()
        req.latency_ms = (now - req.submit_t) * 1e3
        with self._lock:
            self._pending -= 1
            self._completed += 1
            if req.error is not None:
                self._errors += 1
        _m_pending.dec()
        _m_completed.inc()
        if req.error is not None:
            _m_errors.inc()
        _m_latency.observe(req.latency_ms / 1e3)
        self._observe_stages(req, now)
        if self.config.slo_p99_ms > 0:
            _m_slo_requests.inc()
            if req.latency_ms > self.config.slo_p99_ms:
                _m_slo_violations.inc()
        req.done.set()
        if req.callback is not None:
            try:
                req.callback(req)
            except Exception as e:  # noqa: BLE001 -- a dead client must
                # never take the engine down with it
                self._log.debug(f"result callback failed: {e!r}")

    def _complete(self, req: Request, failure: Failure,
                  result: ConsensusResult | None) -> None:
        req.failure, req.result = failure, result
        self._finish(req)

    def _complete_error(self, req: Request, message: str) -> None:
        req.error = message
        self._log.warn(f"request {req.chunk.id}: {message}")
        self._finish(req)

    # ------------------------------------------------ performance ledger

    def _ledger_record(self) -> dict:
        """One serve-snapshot ledger record: registry deltas over the
        engine's own measurement window plus the live serving state."""
        from pbccs_tpu_torch.obs import ledger as obs_ledger

        with self._lock:
            pending = self._pending
            in_flight = self._in_flight_zmws
            completed = self._completed
            errors = self._errors
        return obs_ledger.run_record(
            self._window, kind="serve_snapshot", source="ccs-serve",
            extra={
                "uptime_s": round(time.monotonic() - self._start_t, 3),
                "pending": pending,
                "in_flight_zmws": in_flight,
                "completed": completed,
                "errors": errors,
                "queue_depth": max(0, pending - in_flight),
                "slo_requests": int(_m_slo_requests.value),
                "slo_violations": int(_m_slo_violations.value),
            })

    def _ledger_worker(self, ledger) -> None:
        interval = max(self.config.perf_ledger_interval_s, 0.1)
        while not self._ledger_stop.wait(interval):
            try:
                ledger.append(self._ledger_record())
            except Exception as e:  # noqa: BLE001 -- the ledger must
                # never take the engine down (a failing append already
                # disabled itself with a counted warning)
                self._log.debug(f"perf ledger snapshot failed: {e!r}")

    # ---------------------------------------- status / metrics / trace

    def accepting(self) -> bool:
        """Cheap liveness for /healthz: False once close() began (the
        same figure the status verb reports)."""
        with self._lock:
            return not self._closed

    def status(self) -> dict:
        """Engine introspection for the protocol's `status` verb.  Stage
        and device-wait figures come from the engine's OWN measurement
        window (opened at start()), so concurrent windows elsewhere in
        the process cannot clobber them."""
        with self._lock:
            snap = dict(
                # False once close() began: the router's health probes
                # read this to stop routing to a draining replica before
                # its socket ever closes
                accepting=not self._closed,
                pending=self._pending,
                admitted=self._admitted,
                rejected=self._rejected,
                completed=self._completed,
                errors=self._errors,
                in_flight_batches=self._in_flight_batches,
                in_flight_zmws=self._in_flight_zmws,
            )
            pool = self._pool   # close() nulls this under the same lock
            ledger = self._ledger
        stage_s = {k: round(v, 4)
                   for k, v in timing.stage_seconds(self._window).items()}
        sched = {"sched": pool.status()} if pool is not None else {}
        # the status verb's perf block (protocol.FIELD_PERF): present
        # only when this process writes a ledger, federated fleet-wide
        # by `ccs router --perfLedger`
        perf = {"perf": ledger.perf_block()} if ledger is not None else {}
        # the status verb's roofline block (protocol.FIELD_ROOFLINE):
        # per-bucket CostCard bound + measured achieved/efficiency;
        # absent until the plane has a card or a charge
        rl_block = obs_roofline.tracker().status_block()
        rl = {"roofline": rl_block} if rl_block else {}
        return {
            "engine": "ccs-serve",
            **sched,
            **perf,
            **rl,
            "slo": self._slo_block(),
            "uptime_s": round(time.monotonic() - self._start_t, 3),
            "queue_depth": max(0, snap["pending"] - snap["in_flight_zmws"]),
            "bucketed": self._batcher.pending_count(),
            "depth_by_bucket": self._batcher.depth_by_bucket(),
            "max_pending": self.config.max_pending,
            "max_batch": self.config.max_batch,
            "max_wait_ms": self.config.max_wait_ms,
            "stage_seconds": stage_s,
            "device_wait_s": round(
                timing.device_wait_seconds(self._window), 4),
            "device_fetches": timing.fetch_count(self._window),
            "metrics": self.metrics_snapshot(),
            **snap,
        }

    def _slo_block(self) -> dict:
        """The status verb's SLO summary: the burn-rate pair plus an
        observed-p99 estimate from the latency histogram (bucket upper
        bound -- honest to within the log-bucket resolution)."""
        import math

        from pbccs_tpu_torch.obs.metrics import histogram_quantile

        counts, _s, n = _m_latency.snapshot()
        p99 = histogram_quantile(counts, _m_latency.bounds, 0.99)
        requests = _m_slo_requests.value
        violations = _m_slo_violations.value
        return {
            "target_p99_ms": self.config.slo_p99_ms,
            "enabled": self.config.slo_p99_ms > 0,
            "requests": int(requests),
            "violations": int(violations),
            "violation_rate": round(violations / requests, 6)
            if requests else 0.0,
            "observed_p99_ms_le": round(p99 * 1e3, 3)
            if n and math.isfinite(p99) else None,
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of the process registry (the
        protocol's `metrics` verb scrapes this)."""
        return _reg.render_prometheus()

    def metrics_snapshot(self) -> dict:
        """Compact /metrics-style name->value snapshot (counters and
        gauges only; histograms ride the text exposition) for the
        `status` verb."""
        out = {}
        for (name, labels), (kind, val) in sorted(_reg.snapshot().items()):
            if kind == "histogram" or not name.startswith(
                    ("ccs_serve_", "ccs_batch_", "ccs_device_",
                     "ccs_retries_", "ccs_quarantine", "ccs_degraded_",
                     "ccs_watchdog_", "ccs_faults_", "ccs_sched_",
                     "ccs_slo_", "ccs_refine_", "ccs_flight_",
                     "ccs_metrics_", "ccs_roofline_", "ccs_tenant_")):
                continue
            suffix = "{%s}" % ",".join(
                f"{k}={v}" for k, v in labels) if labels else ""
            out[name + suffix] = round(val, 6)
        return out

    def trace_start(self) -> bool:
        """Install a process-wide capture tracer (the protocol's `trace`
        verb, action=start).  Returns False when a capture -- this
        engine's or anyone else's -- is already running."""
        with self._trace_lock:
            if self._capture is not None:
                return False
            cap = obs_trace.Tracer()
            if not obs_trace.install_tracer(cap):  # someone else's capture
                return False
            self._capture = cap
            return True

    def trace_stop(self) -> dict | None:
        """Stop the capture and return the Chrome-trace JSON object
        (None when no capture was running).  Clears the global tracer
        only if it is still OUR capture (CAS) -- never tears down a
        capture another owner installed since."""
        with self._trace_lock:
            cap, self._capture = self._capture, None
            if cap is None:
                return None
            obs_trace.clear_tracer(cap)
        return cap.to_chrome()
