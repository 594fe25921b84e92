"""Stage timers and device-wait accounting over the metrics registry.

Port of pbccs_tpu.runtime.timing.  Records into the process-wide
MetricsRegistry (obs/metrics.py) under pbccs_tpu's names:

  ccs_stage_seconds_total{stage=...}   thread-seconds per pipeline stage
  ccs_device_wait_seconds_total        blocking time inside device fetches
  ccs_device_fetches_total             fetch count
  ccs_device_fetch_seconds             per-fetch latency histogram

Registry values are monotone; a measurement window (window(), a
MeasurementScope over the default registry) reports deltas, so the CLI's
end-of-run table and any other window never clobber each other.

device_fetch(t) is the blocking device-to-host copy of a tensor
(`t.cpu()`), timed on the host: on the card the copy waits for every
kernel queued before it, so its time is the host's wait on the device.
The time also goes to the innermost open trace span (obs/trace.py), so
exported span trees carry wall vs device-wait decomposition.  It adds
no synchronisation: it times the copies the pipeline already makes.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from pbccs_tpu_torch.obs import metrics as _metrics
from pbccs_tpu_torch.obs import trace as _trace

STAGE_SECONDS = "ccs_stage_seconds_total"
DEVICE_WAIT_SECONDS = "ccs_device_wait_seconds_total"
DEVICE_FETCHES = "ccs_device_fetches_total"
DEVICE_FETCH_SECONDS = "ccs_device_fetch_seconds"

_registry = _metrics.default_registry()
_device_wait = _registry.counter(
    DEVICE_WAIT_SECONDS, "Blocking seconds inside device-to-host fetches")
_fetches = _registry.counter(DEVICE_FETCHES, "Device-to-host fetch count")
_fetch_hist = _registry.histogram(
    DEVICE_FETCH_SECONDS, "Per-fetch blocking latency (s)",
    buckets=_metrics.log_buckets(1e-5, 30.0))

# per-stage Counter handles, cached so the hot path is one dict hit + one
# locked add
_stage_counters: dict[str, _metrics.Counter] = {}
_stage_lock = threading.Lock()


def _stage_counter(name: str) -> _metrics.Counter:
    c = _stage_counters.get(name)
    if c is None:
        with _stage_lock:
            c = _stage_counters.get(name)
            if c is None:
                c = _registry.counter(
                    STAGE_SECONDS,
                    "Accumulated thread-seconds per pipeline stage",
                    stage=name)
                _stage_counters[name] = c
    return c


@contextlib.contextmanager
def stage(name: str):
    """Attribute the enclosed wall time to a named pipeline stage
    (summed across threads; see stage_seconds).  Two perf_counter calls
    and one locked add per use."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _stage_counter(name).inc(time.perf_counter() - t0)


def add_stage(name: str, dt: float) -> None:
    """Attribute dt seconds to a stage (for callers that already timed)."""
    _stage_counter(name).inc(dt)


def device_fetch(t, dtype=None) -> np.ndarray:
    """`t.cpu().numpy()` (cast to `dtype` when given) with the copy's
    blocking time attributed to device wait (registry counters and the
    innermost open trace span)."""
    t0 = time.perf_counter()
    host = t.cpu()
    dt = time.perf_counter() - t0
    _device_wait.inc(dt)
    _fetches.inc()
    _fetch_hist.observe(dt)
    _trace.add_device_wait(dt)
    out = host.numpy()
    return out.astype(dtype, copy=False) if dtype is not None else out


def window() -> _metrics.MeasurementScope:
    """Open an independent measurement window over the default registry.
    Any number may be live at once; none interferes with another."""
    return _registry.scope()


def device_wait_seconds(win: _metrics.MeasurementScope) -> float:
    """Seconds the host blocked in device fetches over the window."""
    return win.counter_value(DEVICE_WAIT_SECONDS)


def stage_seconds(win: _metrics.MeasurementScope) -> dict[str, float]:
    """Per-stage accumulated THREAD time over the window.  With
    overlapped workers the stages can sum past wall time."""
    return {dict(labels)["stage"]: v
            for labels, v in win.counters(STAGE_SECONDS).items() if v != 0}


def fetch_count(win: _metrics.MeasurementScope) -> int:
    """Blocking device-to-host fetches over the window."""
    return int(win.counter_value(DEVICE_FETCHES))
