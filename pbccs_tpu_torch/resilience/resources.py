"""Resource-exhaustion governance: OOM-adaptive dispatch ceilings, a
host-memory budget gate, and disk-full-safe output finalization.

Port of pbccs_tpu.resilience.resources, the whole module, with the same
metric names.  Resource pressure needs different handling from every
other fault the resilience subsystem knows:

  * a device OOM (torch.cuda.OutOfMemoryError, "CUDA out of memory") is
    CAPACITY-shaped -- retrying the identical batch shape cannot
    succeed, and quarantine-bisecting it would burn O(Z log Z)
    dispatches to "isolate" ZMWs that are all healthy.  The right move
    is to SPLIT the batch (Z -> Z/2) at the parent's pinned (Imax, Jmax,
    R) bucket, each part with a Z of its own (the memory relief), and
    REMEMBER the shape
    ceiling so later batches for that bucket are pre-split at admission
    instead of re-discovering the OOM (`MemoryGovernor`);
  * host memory pressure (a fast reader + prepare pool outrunning the
    device) must surface as a THROTTLE, not as the OOM killer: the
    `HostBudget` gate bounds the bytes of prepared-batch backlog in
    flight.  Its caller is the device-fleet scheduler behind
    `--memBudget` (sched/executor.py);
  * a full disk (`ENOSPC`) on the checkpoint journal or an output
    writer must become a STRUCTURED `OutputWriteError` with
    bytes-written accounting and atomic tmp+rename finalization -- a
    torn final file is never published under the output path, and a
    disk-full run resumes byte-identically once space is freed.

Classification order matters: `is_capacity_error` is checked FIRST at
every failure-classification site (pipeline dispatch recovery, every
level of the quarantine bisection, the serial rescue, per-ZMW
isolation), before device.is_device_error -- which also matches a CUDA
OOM, for callers outside the polish.

Metrics: ``ccs_resource_oom_splits_total``,
``ccs_resource_oom_ceilings_total``,
``ccs_resource_presplit_batches_total``,
``ccs_resource_throttles_total{site}``,
``ccs_resource_host_rss_bytes``, ``ccs_resource_budget_bytes_inuse``,
``ccs_output_write_errors_total{sink}``.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
from typing import Callable, Hashable, Iterator

import torch

from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.runtime.logging import Logger

_reg = default_registry()
_m_oom_splits = _reg.counter(
    "ccs_resource_oom_splits_total",
    "Batch dispatches split after a capacity-shaped (OOM) failure")
_m_ceilings = _reg.counter(
    "ccs_resource_oom_ceilings_total",
    "Shape-ceiling records/lowerings by the memory governor")
_m_presplit = _reg.counter(
    "ccs_resource_presplit_batches_total",
    "Batches pre-split at admission by a learned shape ceiling")
_m_rss = _reg.gauge("ccs_resource_host_rss_bytes",
                    "Sampled resident-set size of this process")
_m_budget_inuse = _reg.gauge(
    "ccs_resource_budget_bytes_inuse",
    "Bytes currently charged against the host memory budget")


def _m_throttles(site: str):
    return _reg.counter("ccs_resource_throttles_total",
                        "Host-budget admissions that had to wait",
                        site=site)


def _m_write_errors(sink: str):
    return _reg.counter("ccs_output_write_errors_total",
                        "Output writes failed by the filesystem "
                        "(ENOSPC, quota, I/O error)", sink=sink)


# -------------------------------------------------------- classification

# message markers identifying a CAPACITY failure: the allocation was too
# big for the device/arena, so a same-shape retry cannot succeed
# (pbccs_tpu's list; torch's "CUDA out of memory" matches "out of
# memory", and an injected `oom` fault carries RESOURCE_EXHAUSTED)
CAPACITY_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory",
                    "out of memory", "OOM", "HBM",
                    "Attempting to allocate")


def is_capacity_error(exc: BaseException | None) -> bool:
    """True when exc (or an exception in its cause chain) looks like
    memory exhaustion (device or host-arena): the batch SHAPE is the
    problem, so the recovery is a split, never a same-shape retry and
    never quarantine.  Checked BEFORE transient and device-shaped
    classification everywhere."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
            return True
        text = str(exc)
        if any(m in text for m in CAPACITY_MARKERS):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


class CapacityError(MemoryError):
    """A capacity failure reduced to its type name and message.

    The exception a failed dispatch raised holds its traceback, and the
    traceback holds the failed attempt's frames with every tensor they
    allocated: a split that re-dispatches while it lives runs beside
    that memory and runs out again.  The recovery classifies inside the
    `except` block, carries one of these out of it, and dispatches only
    after the original is gone."""

    @classmethod
    def of(cls, exc: BaseException) -> "CapacityError":
        return cls(f"{type(exc).__name__}: {exc}")


# -------------------------------------------------- device scope (TLS)

_tls = threading.local()

HOST_DEVICE = "host"


@contextlib.contextmanager
def device_scope(name: str) -> Iterator[None]:
    """Tag this thread with the device its dispatches run on, so the
    governor can key ceilings per device without threading a device
    handle through every pipeline signature.  The CLI's worker threads
    run in this with the card they polish on; un-scoped threads record
    under "host"."""
    prev = getattr(_tls, "device", None)
    _tls.device = name
    try:
        yield
    finally:
        _tls.device = prev


def current_device() -> str:
    """The device name of this thread's dispatch scope ("host" when
    un-scoped)."""
    return getattr(_tls, "device", None) or HOST_DEVICE


# ------------------------------------------------------ memory governor

def shape_bucket(imax: int, jmax: int, r: int) -> tuple:
    """The canonical capacity-bucket key for a pinned polish shape: the
    compiled (Imax, Jmax, R) geometry whose per-ZMW device footprint is
    fixed, so a Z ceiling learned once applies to every batch that
    polishes in the bucket.  pbccs_tpu's key space, so the pre-split
    and every later reader of the ceilings agree."""
    return ("shape", int(imax), int(jmax), int(r))


def split_sizes(n: int, cap: int) -> list[int]:
    """Greedy cap-sized sub-batches covering n items (the admission
    pre-split plan, pbccs_tpu's): 10 @ cap 4 -> [4, 4, 2]."""
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    out = []
    while n > cap:
        out.append(cap)
        n -= cap
    out.append(n)
    return out


class MemoryGovernor:
    """Per-(device, shape-bucket) Z ceilings learned from OOM failures.

    ``record_oom(bucket, z)`` after a capacity failure at batch size z
    lowers the ceiling to max(1, z // 2); ``cap(bucket)`` returns the
    ceiling later admissions pre-split to.  A device with no recorded
    ceiling inherits the MINIMUM ceiling any other device learned for
    the bucket (fleets are near-homogeneous; pessimistic warm-start
    beats N devices re-discovering the same OOM).  ``reset_device``
    forgets a device's ceilings -- the re-admission hook for a device
    or replica that came back after remediation (more HBM freed, a
    restart) and should re-learn from scratch."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # bucket -> {device -> ceiling}
        self._ceilings: dict[Hashable, dict[str, int]] = {}

    def record_oom(self, bucket: Hashable, z: int,
                   device: str | None = None) -> int:
        """Account one capacity failure at batch size z; returns the new
        ceiling (what the split re-dispatch should target)."""
        device = device or current_device()
        new = max(1, int(z) // 2)
        with self._lock:
            per_dev = self._ceilings.setdefault(bucket, {})
            old = per_dev.get(device)
            ceiling = min(old, new) if old is not None else new
            per_dev[device] = ceiling
        _m_ceilings.inc()
        log = Logger.default()
        log.warn(
            f"memory governor: capacity failure at Z={z} on {device} "
            f"(bucket {bucket!r}); ceiling -> {ceiling}")
        # capacity-split postmortem: the refine-loop flight record just
        # before the device ran out (obs.flight ring buffer)
        from pbccs_tpu_torch.obs import flight

        flight.dump("oom-ceiling", log)
        return ceiling

    def cap(self, bucket: Hashable, device: str | None = None
            ) -> int | None:
        """The admission Z ceiling for bucket on device (None = no
        limit learned).  device=None returns the minimum over devices --
        the conservative bound for a caller that has not yet picked a
        device."""
        with self._lock:
            per_dev = self._ceilings.get(bucket)
            if not per_dev:
                return None
            if device is None:
                return min(per_dev.values())
            own = per_dev.get(device)
            if own is not None:
                return own
            return min(per_dev.values())

    def reset_device(self, device: str) -> int:
        """Forget every ceiling learned for `device` (re-admission after
        remediation); returns how many were dropped."""
        dropped = 0
        with self._lock:
            for per_dev in self._ceilings.values():
                if per_dev.pop(device, None) is not None:
                    dropped += 1
            self._ceilings = {b: d for b, d in self._ceilings.items() if d}
        if dropped:
            Logger.default().info(
                f"memory governor: reset {dropped} ceiling(s) for "
                f"re-admitted device {device}")
        return dropped

    def snapshot(self) -> dict:
        """Introspection: {str(bucket): {device: ceiling}}."""
        with self._lock:
            return {str(b): dict(d) for b, d in self._ceilings.items()}


_default_governor = MemoryGovernor()


def default_governor() -> MemoryGovernor:
    """The process-wide governor every dispatch of the process shares."""
    return _default_governor


def note_oom_split(n: int = 1) -> None:
    """Count split (re-)dispatches caused by capacity failures."""
    _m_oom_splits.inc(n)


def note_presplit() -> None:
    """Count batches pre-split at admission by a learned ceiling."""
    _m_presplit.inc()


# ---------------------------------------------------------- host budget

_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kKmMgGtT]?)(?:i?[bB])?\s*$")
_SIZE_MULT = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_size(text: str | int) -> int:
    """'8G' / '512M' / '1048576' -> bytes (the --memBudget grammar)."""
    if isinstance(text, int):
        return text
    m = _SIZE_RE.match(text)
    if not m:
        raise ValueError(f"bad size {text!r}: want BYTES or N[K|M|G|T]")
    return int(float(m.group(1)) * _SIZE_MULT[m.group(2).lower()])


def rss_bytes() -> int:
    """Current resident-set size of this process (0 when unreadable)."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def peak_rss_bytes() -> int:
    """Peak resident-set size since process start (ru_maxrss; kilobytes
    on Linux)."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, ValueError, OSError):
        return 0


def sample_rss() -> int:
    """Sample RSS into the ccs_resource_host_rss_bytes gauge."""
    rss = rss_bytes()
    if rss:
        _m_rss.set(rss)
    return rss


class BudgetLease:
    """One admitted charge against a HostBudget; release exactly once
    (idempotent -- emission and teardown paths may both call it)."""

    __slots__ = ("_budget", "nbytes", "_released")

    def __init__(self, budget: "HostBudget", nbytes: int):
        self._budget = budget
        self.nbytes = nbytes
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._budget._release(self.nbytes)


class HostBudget:
    """Byte-bounded admission gate for host-side batch backlog.

    The prepare pool charges each batch's marshalled-bytes estimate
    before building it and the lease is released when the batch's
    polish completes (the planes are garbage once the dispatch consumed
    them), so prepared-batch backlog stays under ``limit_bytes``
    instead of growing until the OOM killer fires.  Releases must never
    be tied to an ORDERED drain point: a waiter whose predecessor is
    itself blocked in admit() would deadlock.  A charge larger than the
    whole budget admits alone (progress is guaranteed: admit() only
    blocks while something else holds bytes).
    Pressure surfaces as ccs_resource_throttles_total{site} and a
    ``resource.throttle`` span, never a crash."""

    def __init__(self, limit_bytes: int, *, logger: Logger | None = None):
        limit_bytes = int(limit_bytes)
        if limit_bytes < 1:
            raise ValueError(f"memBudget must be >= 1 byte, got "
                             f"{limit_bytes}")
        self.limit_bytes = limit_bytes
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._in_use = 0
        self._throttles = 0
        self._log = logger or Logger.default()
        self._warned_oversize = False

    def in_use(self) -> int:
        with self._lock:
            return self._in_use

    def _admit_locked(self, nbytes: int) -> bool:
        """Caller holds the lock: True when nbytes fits now (or nothing
        else is charged, the progress guarantee)."""
        return self._in_use == 0 or self._in_use + nbytes <= self.limit_bytes

    def admit(self, nbytes: int, site: str = "host",
              abort: Callable[[], bool] | None = None
              ) -> BudgetLease | None:
        """Block until nbytes fits under the budget, then charge it.
        Returns the lease, or None when abort() turned true while
        waiting (pipeline teardown)."""
        nbytes = max(0, int(nbytes))
        sample_rss()
        if nbytes > self.limit_bytes and not self._warned_oversize:
            self._warned_oversize = True
            self._log.warn(
                f"host budget: single batch estimate {nbytes} B exceeds "
                f"--memBudget {self.limit_bytes} B; admitting it alone "
                "(raise the budget or lower --chunkSize)")
        with self._cv:
            if self._admit_locked(nbytes):
                self._in_use += nbytes
                _m_budget_inuse.set(self._in_use)
                return BudgetLease(self, nbytes)
            self._throttles += 1
        _m_throttles(site).inc()
        with obs_trace.span("resource.throttle", site=site, bytes=nbytes):
            with self._cv:
                while not self._admit_locked(nbytes):
                    if abort is not None and abort():
                        return None
                    self._cv.wait(timeout=0.1)
                self._in_use += nbytes
                _m_budget_inuse.set(self._in_use)
        return BudgetLease(self, nbytes)

    def _release(self, nbytes: int) -> None:
        with self._cv:
            self._in_use = max(0, self._in_use - nbytes)
            _m_budget_inuse.set(self._in_use)
            self._cv.notify_all()

    def throttle_count(self) -> int:
        with self._lock:
            return self._throttles


# ------------------------------------------------- disk-full-safe output

class OutputWriteError(RuntimeError):
    """A filesystem write to an output sink failed (ENOSPC, quota, I/O
    error): structured so callers can report WHAT was lost.
    ``bytes_written`` counts the bytes the sink durably accepted before
    the failure."""

    def __init__(self, sink: str, path: str, bytes_written: int,
                 cause: OSError):
        self.sink = sink
        self.path = path
        self.bytes_written = int(bytes_written)
        self.errno = cause.errno
        super().__init__(
            f"{sink} write to {path} failed after {bytes_written} byte(s): "
            f"{cause.strerror or cause}")
        _m_write_errors(sink).inc()


@contextlib.contextmanager
def atomic_output(path: str, sink: str, mode: str = "w") -> Iterator:
    """Write `path` through a same-directory temp file, fsync, and
    rename into place on clean exit -- a disk-full (or crash) mid-write
    never publishes a torn file under the output path.  An OSError from
    the write/flush/rename raises a structured OutputWriteError and the
    temp file is removed."""
    tmp = path + ".tmp"
    written = 0
    try:
        fh = open(tmp, mode)
    except OSError as e:
        raise OutputWriteError(sink, path, 0, e) from e
    try:
        yield fh
        fh.flush()
        os.fsync(fh.fileno())
        written = fh.tell()
        fh.close()
        os.replace(tmp, path)
    except OSError as e:
        try:
            written = max(written, fh.tell())
        except (OSError, ValueError):
            pass
        _close_and_remove(fh, tmp)
        raise OutputWriteError(sink, path, written, e) from e
    except BaseException:
        _close_and_remove(fh, tmp)
        raise


def _close_and_remove(fh, tmp: str) -> None:
    """Error-path teardown of a temp output: close (its flush can
    re-raise the same ENOSPC) and remove it, best effort."""
    try:
        fh.close()
    except OSError:
        pass
    try:
        os.remove(tmp)
    except OSError:
        pass  # best-effort cleanup; the .tmp suffix marks it torn
