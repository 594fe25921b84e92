"""Device-fleet scheduler core: one executor thread per device.

Port of pbccs_tpu.sched.pool over torch devices.  Many independent
bucketed batches, each small enough for one card, are dispatched across
the fleet so every card is fed; on a one-card machine the pool is the
device half of the scheduled pipeline (sched/executor.py), whose prepare
threads draft the next batches while the card polishes.

Design points (those of pbccs_tpu):

  * **One worker thread per device.**  Each task runs on its worker's
    thread under ``torch.cuda.device(card)`` (for a card), inside
    ``resources.device_scope(worker name)`` (the memory governor keys its
    ceilings by it), the ``sched.dispatch`` fault site and
    ``roofline.dispatch_scope``, and gets the device as its argument.
    Tasks launch on that card's current stream, so the torch ops and the
    kernels of one worker run in issue order.
  * **Sticky bucket routing** (the default policy): a task's bucket key
    prefers a device that already ran that key ("home"); an idle home
    always wins, a busy home loses to the least-loaded healthy device
    (work-conserving), which then becomes an additional home.
    Policies: ``sticky`` | ``least`` | ``roundrobin``.
  * **Failure classification**, in this order: capacity (a CUDA OOM,
    ``resources.is_capacity_error``: the governor records a ceiling for
    the task's shape bucket and the task requeues to the SAME device,
    where the pipeline's admission pre-split dispatches it in
    ceiling-sized parts); device-shaped (a WatchdogTimeout, a
    RetriesExhausted, an injected fault, or ``device.is_device_error``:
    a KernelError, a LaunchRefused, a CUDA error) -- a strike against the
    device on the task's FIRST failure, and a requeue to a healthy
    device the task has not failed on (``task.excluded`` bounds the
    tour to the fleet size); everything else is task-shaped: ONE
    healthy-device retry, then it surfaces.  ``bench_after``
    device-shaped strikes in a row bench the device: its queued tasks
    requeue to healthy devices.  The LAST healthy device is never
    benched, and a task never requeues to a device it failed on -- a
    CUDA error other than an OOM is sticky (the context is lost), so on
    one card such a failure surfaces instead of looping.

Device names are ``cuda:<index>`` for a card and ``cpu:<i>`` for the
CPU workers the tests run (``select_devices(n, device="cpu")``), the
names of pbccs_tpu's virtual CPU devices, so fault specs and metric
labels are the same strings in both packages.

Metrics (the port's registry): ``ccs_sched_tasks_total{device}``,
``ccs_sched_task_failures_total{device}``, ``ccs_sched_requeues_total``,
``ccs_sched_device_benched_total{device}``,
``ccs_sched_queue_depth{device}``,
``ccs_sched_sticky_routes_total{outcome=home|spill|new}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import traceback
from typing import Any, Callable, Hashable, Sequence

import torch

from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.runtime.logging import Logger
from pbccs_tpu_torch.sched.health import StickyMap

_reg = default_registry()
_m_requeues = _reg.counter(
    "ccs_sched_requeues_total",
    "Tasks re-routed to another device after a device-shaped failure")
_m_sticky = {outcome: _reg.counter(
    "ccs_sched_sticky_routes_total",
    "Sticky routing decisions by outcome", outcome=outcome)
    for outcome in ("home", "spill", "new")}

#: the longest one condition wait of a worker or of close() blocks before
#: it re-checks its state
_POLL_S = 1.0


def select_devices(n: int, device=None) -> list[torch.device]:
    """First-n device selection shared by every fleet entry point (batch
    CLI ``--devices``, ``ccs warmup``): ``n == 0`` means every card,
    ``n > 0`` the first n.  A negative n is a usage error.  With no
    ``device`` (or a CUDA one) the cards are ``torch.cuda.device_count()``
    and none raises -- the CPU is never chosen on its own; ``device="cpu"``
    gives ``max(n, 1)`` CPU workers ``cpu:0`` ... ``cpu:<n-1>``."""
    if n < 0:
        raise ValueError(f"devices must be >= 0, got {n}")
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu", i) for i in range(max(n, 1))]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the device fleet runs on CUDA devices by default and none is "
            "available; pass device='cpu' to run CPU workers")
    count = torch.cuda.device_count()
    if n > count:
        # a silent clamp would run a "--devices 8" fleet on one card with
        # nothing flagging the visibility misconfiguration
        Logger.default().warn(
            f"requested {n} devices but only {count} visible; "
            f"running on {count}")
    return [torch.device("cuda", i) for i in range(min(n or count, count))]


def device_name(device: torch.device) -> str:
    """A worker's name: ``cuda:<index>`` or ``cpu:<i>``."""
    return f"{device.type}:{device.index or 0}"


def on_device(device: torch.device):
    """The current-device scope of a task: the card for a CUDA worker."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class PoolClosed(RuntimeError):
    """submit() after close(), or a task failed by a non-waiting close."""


class NoHealthyDevice(RuntimeError):
    """A task ran out of healthy devices it has not already failed on."""


@dataclasses.dataclass(frozen=True)
class DevicePoolConfig:
    """Scheduler knobs (see module docstring for the policy they drive)."""

    policy: str = "sticky"        # sticky | least | roundrobin
    # consecutive device-shaped failures before a device is benched
    bench_after: int = 2
    # a busy home keeps a sticky task only while its depth (queued +
    # running) is <= spill_depth; 0 = work-conserving (idle homes only)
    spill_depth: int = 0

    def __post_init__(self):
        if self.policy not in ("sticky", "least", "roundrobin"):
            raise ValueError(f"unknown sched policy {self.policy!r}")
        if self.bench_after < 1:
            raise ValueError("bench_after must be >= 1")


class SchedFuture:
    """Completion handle for one submitted task (threading-based)."""

    def __init__(self, callback: Callable[["SchedFuture"], None] | None = None):
        self._done = threading.Event()
        self._result: Any = None
        self._exc: BaseException | None = None
        self._callback = callback

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError("task not complete")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: float | None = None) -> BaseException | None:
        if not self._done.wait(timeout):
            raise TimeoutError("task not complete")
        return self._exc

    def _finish(self, result: Any = None,
                exc: BaseException | None = None) -> None:
        if self._done.is_set():
            return   # complete exactly once (a racing close)
        self._result, self._exc = result, exc
        self._done.set()
        if self._callback is not None:
            try:
                self._callback(self)
            except Exception as e:  # noqa: BLE001 -- a completion callback
                # must never take the worker thread down with it
                Logger.default().debug(f"sched callback failed: {e!r}")


@dataclasses.dataclass
class _Task:
    key: Hashable
    fn: Callable[[Any], Any]          # fn(torch.device) -> result
    zmws: int
    future: SchedFuture
    excluded: set = dataclasses.field(default_factory=set)  # worker indices
    # pin=True submissions (warmup) must run on THEIR device or fail
    # loudly: a silent requeue elsewhere would report a cold device warm
    pinned: bool = False
    # the resources.shape_bucket this task polishes in: a capacity-shaped
    # failure records a governor ceiling under it and requeues the task
    # to the SAME device.  None = no capacity handling.
    capacity_bucket: Hashable | None = None
    capacity_requeues: int = 0


class _Worker:
    """Bookkeeping for one device executor (state guarded by pool lock)."""

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.name = device_name(device)
        self.pending: collections.deque[_Task] = collections.deque()
        self.busy = False
        self.benched = False
        self.strikes = 0
        self.tasks_done = 0
        self.failures = 0
        self.thread: threading.Thread | None = None
        self.m_tasks = _reg.counter("ccs_sched_tasks_total",
                                    "Tasks completed per device",
                                    device=self.name)
        self.m_failures = _reg.counter("ccs_sched_task_failures_total",
                                       "Task attempts that raised, per device",
                                       device=self.name)
        self.m_depth = _reg.gauge("ccs_sched_queue_depth",
                                  "Queued + running tasks per device",
                                  device=self.name)

    def depth(self) -> int:
        return len(self.pending) + (1 if self.busy else 0)


def _device_shaped(exc: BaseException) -> bool:
    """A failure that points at the device rather than the task: a hang,
    retries that never cleared, an injected chaos fault, or a fault of
    the card or the kernels (device.is_device_error)."""
    from pbccs_tpu_torch.device import is_device_error
    from pbccs_tpu_torch.resilience import faults, retry, watchdog

    return (isinstance(exc, (watchdog.WatchdogTimeout,
                             retry.RetriesExhausted, faults.InjectedFault))
            or is_device_error(exc))


class DevicePool:
    """A fleet of per-device executor threads with sticky bucket routing
    and health-based benching (see module docstring)."""

    def __init__(self, devices: Sequence[torch.device] | None = None,
                 config: DevicePoolConfig | None = None, *,
                 logger: Logger | None = None):
        self.config = config or DevicePoolConfig()
        self._log = logger or Logger.default()
        devices = [torch.device(d) for d in
                   (devices if devices is not None else select_devices(0))]
        if not devices:
            raise ValueError("DevicePool needs at least one device")
        names = [device_name(d) for d in devices]
        if len(set(names)) != len(names):
            # two workers on one card would share its stream and memory
            raise ValueError(f"DevicePool got a device twice: {names}")
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._workers = [_Worker(i, d) for i, d in enumerate(devices)]
        # bucket key -> worker indices that have run it (sticky "homes")
        self._sticky = StickyMap()
        self._rr = -1
        self._closed = False
        for w in self._workers:
            w.thread = threading.Thread(
                target=self._worker_loop, args=(w,), daemon=True,
                name=f"ccs-sched-{w.name}")
            w.thread.start()
        self._log.info(
            f"device pool up: {len(self._workers)} device(s) "
            f"[{', '.join(w.name for w in self._workers)}] "
            f"policy={self.config.policy}")

    @property
    def n_devices(self) -> int:
        return len(self._workers)

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers if not w.benched)

    # ------------------------------------------------------------- submission

    def submit(self, key: Hashable, fn: Callable[[Any], Any], *,
               zmws: int = 1,
               callback: Callable[[SchedFuture], None] | None = None,
               worker_index: int | None = None,
               pin: bool = False,
               capacity_bucket: Hashable | None = None) -> SchedFuture:
        """Queue fn(device) on a device chosen by the routing policy.

        `key` is the sticky-routing bucket.  `worker_index` places the
        task on one device; with `pin=True` it must also COMPLETE there
        (a pinned task that fails surfaces its exception instead of
        requeueing).  The future completes with fn's result, or -- after
        the requeues are exhausted -- its last exception.
        `capacity_bucket` (a resources.shape_bucket) opts the task into
        OOM handling: a capacity failure records a MemoryGovernor ceiling
        for (device, bucket) and requeues to the SAME device."""
        if pin and worker_index is None:
            raise ValueError("pin=True requires worker_index")
        if worker_index is not None and not (
                0 <= worker_index < len(self._workers)):
            # no negative-index wrap: a pinned task landing on the LAST
            # device via an off-by-one would leave the intended one cold
            raise ValueError(
                f"worker_index {worker_index} out of range "
                f"[0, {len(self._workers)})")
        task = _Task(key, fn, zmws, SchedFuture(callback), pinned=pin,
                     capacity_bucket=capacity_bucket)
        with self._cv:
            if self._closed:
                raise PoolClosed("device pool is closed")
            if worker_index is not None:
                w = self._workers[worker_index]
                if w.benched:
                    raise NoHealthyDevice(f"device {w.name} is benched")
            else:
                w = self._route_locked(task)
            self._enqueue_locked(w, task)
            self._cv.notify_all()
        return task.future

    def _route_locked(self, task: _Task) -> _Worker:
        healthy = [w for w in self._workers
                   if not w.benched and w.index not in task.excluded]
        if not healthy:
            raise NoHealthyDevice(
                f"no healthy device left for bucket {task.key!r}")
        policy = self.config.policy
        if policy == "roundrobin":
            self._rr += 1
            return healthy[self._rr % len(healthy)]

        # least-loaded tie-break: fewer resident buckets first, then
        # device order
        def load(w: _Worker):
            return (w.depth(), self._sticky.resident_count(w.index),
                    w.index)

        if policy == "sticky":
            target, outcome = self._sticky.route(
                task.key, healthy, member_id=lambda w: w.index, load=load,
                depth=lambda w: w.depth(),
                spill_depth=self.config.spill_depth)
            _m_sticky[outcome].inc()
            return target
        return min(healthy, key=load)

    def _enqueue_locked(self, w: _Worker, task: _Task) -> None:
        self._sticky.note(task.key, w.index)
        w.pending.append(task)
        w.m_depth.set(w.depth())

    # ------------------------------------------------------------ worker loop

    def _worker_loop(self, w: _Worker) -> None:
        while True:
            with self._cv:
                while not w.pending and not self._closed and not w.benched:
                    self._cv.wait(_POLL_S)
                if w.benched:
                    return  # _bench_locked already requeued w.pending
                if not w.pending:  # closed and drained
                    return
                task = w.pending.popleft()
                w.busy = True
                w.m_depth.set(w.depth())
            self._run_task(w, task)
            with self._cv:
                w.busy = False
                w.m_depth.set(w.depth())
                self._cv.notify_all()

    def _run_task(self, w: _Worker, task: _Task) -> None:
        from pbccs_tpu_torch.obs import roofline
        from pbccs_tpu_torch.resilience import faults, resources

        # per-dispatch roofline scope, keyed by the task's shape bucket
        # when it declared one
        rl_label = (roofline.label_from_capacity_bucket(task.capacity_bucket)
                    or str(task.key))
        try:
            # the device-level chaos site, keyed by WORKER name so a spec
            # can sicken one device (ZMW-poison specs live inside the
            # dispatch at polish.dispatch); an oom spec here models the
            # card rejecting the batch shape
            with resources.device_scope(w.name):
                faults.maybe_fail("sched.dispatch",
                                  keys=[w.name, str(task.key)])
                with on_device(w.device), \
                        roofline.dispatch_scope(rl_label, zmws=task.zmws):
                    result = task.fn(w.device)
        except BaseException as e:  # noqa: BLE001 -- classified below
            self._on_task_error(w, task, e)
            return
        with self._lock:
            w.strikes = 0
            w.tasks_done += 1
        w.m_tasks.inc()
        task.future._finish(result=result)

    def _on_task_error(self, w: _Worker, task: _Task,
                       exc: BaseException) -> None:
        from pbccs_tpu_torch.resilience import resources

        w.m_failures.inc()
        # CAPACITY first: the batch SHAPE overflows the card, which is
        # neither sick hardware nor a poison input.  Record the ceiling
        # and requeue to the SAME device; halvings are bounded, so a task
        # that ignores the governor still surfaces in O(log Z) requeues
        if (task.capacity_bucket is not None and not task.pinned
                and resources.is_capacity_error(exc)
                and task.capacity_requeues <= max(1, task.zmws).bit_length()):
            resources.default_governor().record_oom(
                task.capacity_bucket, max(1, task.zmws), device=w.name)
            resources.note_oom_split()
            self._log.warn(
                f"sched: capacity failure on {w.name} (bucket "
                f"{task.key!r}, {task.zmws} ZMW(s)): "
                f"{type(exc).__name__}: {exc}; requeueing for a "
                "governor-split re-dispatch on the same device")
            with self._cv:
                task.capacity_requeues += 1
                if not self._closed and not w.benched:
                    _m_requeues.inc()
                    self._enqueue_locked(w, task)
                    self._cv.notify_all()
                    return
            task.future._finish(exc=exc)
            return
        device_shaped = _device_shaped(exc)
        tb = "".join(traceback.format_exception(type(exc), exc,
                                                exc.__traceback__))
        self._log.warn(
            f"sched: task (bucket {task.key!r}, {task.zmws} ZMW(s)) failed "
            f"on {w.name} with {type(exc).__name__}: {exc} "
            f"[device_shaped={device_shaped}]")
        self._log.debug(f"sched: {w.name} failure traceback:\n{tb}")
        stranded: list[_Task] = []
        with self._cv:
            w.failures += 1
            # only a task's FIRST failure strikes its device: a poisoned
            # task touring the fleet must not bench every device it visits
            first_failure = not task.excluded
            task.excluded.add(w.index)
            if device_shaped and first_failure and not self._closed:
                w.strikes += 1
                healthy = sum(1 for x in self._workers if not x.benched)
                if (w.strikes >= self.config.bench_after and not w.benched
                        and healthy > 1):
                    stranded = self._bench_locked(w, exc)
                elif w.strikes >= self.config.bench_after:
                    self._log.warn(
                        f"sched: {w.name} reached {w.strikes} strike(s) but "
                        "is the last healthy device; keeping it in service")
            # requeue to a healthy device this task has not failed on --
            # never after close() (a drained worker may have exited), never
            # a pinned task, and a task-shaped failure only once
            if self._closed or task.pinned or (
                    not device_shaped and not first_failure):
                target = None
            else:
                try:
                    target = self._route_locked(task)
                except NoHealthyDevice:
                    target = None
            if target is not None:
                _m_requeues.inc()
                self._enqueue_locked(target, task)
                self._cv.notify_all()
                self._log.warn(
                    f"sched: requeued bucket {task.key!r} "
                    f"({task.zmws} ZMW(s)) {w.name} -> {target.name}")
        # futures complete OUTSIDE the pool lock: completion callbacks run
        # caller code that must never stall the scheduler
        for t in stranded:
            t.future._finish(exc=NoHealthyDevice(
                f"bucket {t.key!r}: no eligible healthy device left "
                "(failed everywhere, or pinned to a benched device)"))
        if target is None:
            task.future._finish(exc=exc)

    def _bench_locked(self, w: _Worker,
                      exc: BaseException) -> list[_Task]:
        """Take a sick device out of service; requeue its queued tasks.
        Caller holds the lock.  Returns the tasks with no healthy device
        left (the caller fails them after releasing the lock)."""
        w.benched = True
        _reg.counter("ccs_sched_device_benched_total",
                     "Devices benched by repeated device-shaped failures",
                     device=w.name).inc()
        queued = list(w.pending)
        w.pending.clear()
        w.m_depth.set(0)
        self._sticky.forget_member(w.index)
        self._log.error(
            f"sched: benching device {w.name} after {w.strikes} "
            f"device-shaped failure(s) (last: {type(exc).__name__}: {exc}); "
            f"requeuing {len(queued)} queued task(s)")
        stranded: list[_Task] = []
        for task in queued:
            if task.pinned:
                stranded.append(task)
                continue
            try:
                target = self._route_locked(task)
            except NoHealthyDevice:
                stranded.append(task)
                continue
            _m_requeues.inc()
            self._enqueue_locked(target, task)
        self._cv.notify_all()
        return stranded

    # -------------------------------------------------------------- lifecycle

    def close(self, wait: bool = True, *,
              join_timeout_s: float | None = None) -> None:
        """Stop the pool.  wait=True (default) drains queued tasks first;
        wait=False fails queued tasks with PoolClosed (running tasks
        still finish -- a launched kernel cannot be interrupted).
        join_timeout_s (None = until drained) caps each worker's join."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            stranded: list[_Task] = []
            if not wait:
                for w in self._workers:
                    stranded.extend(w.pending)
                    w.pending.clear()
                    w.m_depth.set(w.depth())
            self._cv.notify_all()
        for task in stranded:
            task.future._finish(exc=PoolClosed("device pool closed"))
        for w in self._workers:
            if w.thread is None:
                continue
            if join_timeout_s is not None:
                w.thread.join(timeout=join_timeout_s)
                continue
            while w.thread.is_alive():
                w.thread.join(timeout=_POLL_S)
        # a task requeued onto a worker that had already exited would
        # otherwise strand with an incomplete future
        with self._lock:
            leftovers = [t for w in self._workers for t in w.pending]
            for w in self._workers:
                w.pending.clear()
                w.m_depth.set(0)
        for task in leftovers:
            task.future._finish(exc=PoolClosed("device pool closed"))
        self._log.info("device pool down")

    def __enter__(self) -> "DevicePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ intro

    def status(self) -> dict:
        """Per-device breakdown."""
        with self._lock:
            bucket_count = {w.index: self._sticky.resident_count(w.index)
                            for w in self._workers}
            return {
                "policy": self.config.policy,
                "devices": [{
                    "device": w.name,
                    "benched": w.benched,
                    "busy": w.busy,
                    "queued": len(w.pending),
                    "strikes": w.strikes,
                    "tasks_done": w.tasks_done,
                    "failures": w.failures,
                    "buckets": bucket_count[w.index],
                } for w in self._workers],
            }
