"""RetryPolicy: exponential backoff + deterministic jitter, deadline-aware.

Port of pbccs_tpu.resilience.retry (the same delays, jitter stream,
`ccs_retries_total{site}` counter and policies).  Two call sites define
the contract: the serve client retries `overloaded` rejections
(OVERLOADED_RETRY: bounded attempts, jittered backoff, a server's
`retry_after_ms` hint honored through `delay_hint`), and the device
dispatch retries TRANSIENT failures before the quarantine
machinery treats the batch as poisoned.  What counts as transient is
narrower than in pbccs_tpu: JAX retries any XlaRuntimeError that is not
INVALID_ARGUMENT, but the CUDA errors torch raises (illegal address,
launch failure, ECC, device-side assert) are sticky -- every later call
on the context fails too -- so no CUDA error is retried.  Only the
status markers below are (an injected `error=transient` among them).
Memory exhaustion is not transient either: it is capacity-shaped
(resources.is_capacity_error) and handled by the split path.

Jitter is drawn from a seedable RNG so chaos runs are reproducible; the
optional deadline bounds total wall time INCLUDING the next sleep (a
retry that cannot finish before the deadline is not attempted).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, TypeVar

import numpy as np

from pbccs_tpu_torch.obs.metrics import default_registry

T = TypeVar("T")

_reg = default_registry()


def _retry_counter(site: str):
    return _reg.counter("ccs_retries_total",
                        "Retries performed by RetryPolicy.run", site=site)


class RetriesExhausted(RuntimeError):
    """Raised by RetryPolicy.run when attempts/deadline run out; __cause__
    is the last underlying error."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: delay_k = base * multiplier^k, capped at
    max_delay, each +/- jitter fraction."""

    max_attempts: int = 3          # total attempts (1 = no retry)
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25           # +/- fraction of the nominal delay
    deadline_s: float | None = None  # total wall budget across attempts

    def delays(self, rng: np.random.Generator | None = None
               ) -> Iterator[float]:
        """The backoff sequence (max_attempts - 1 sleeps)."""
        rng = rng or np.random.default_rng()
        d = self.base_delay_s
        for _ in range(max(self.max_attempts - 1, 0)):
            j = rng.uniform(-self.jitter, self.jitter) if self.jitter else 0.0
            yield max(0.0, d * (1.0 + j))
            d = min(d * self.multiplier, self.max_delay_s)

    def run(self, fn: Callable[[], T], *,
            retry_on: Callable[[BaseException], bool],
            site: str = "retry",
            rng: np.random.Generator | None = None,
            sleep: Callable[[float], None] = time.sleep,
            delay_hint: Callable[[BaseException], float | None]
            | None = None) -> T:
        """Call fn() with retries on errors retry_on() accepts.

        Non-retryable errors propagate untouched.  When attempts or the
        deadline run out, raises RetriesExhausted from the last error
        (so callers can distinguish "gave up" from "not retryable").

        `delay_hint(exc)` (optional) may return a server-supplied
        backoff in SECONDS (a shed reply's retry_after_ms): when present
        it overrides the exponential schedule for the next sleep, capped
        at max_delay_s and jittered like any other delay.  The schedule
        still advances underneath."""
        counter = _retry_counter(site)
        rng = rng or np.random.default_rng()
        t0 = time.monotonic()
        last: BaseException | None = None
        delays = self.delays(rng)
        attempt = 0
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 -- filtered below
                if not retry_on(e):
                    raise
                last = e
            delay = next(delays, None)
            if delay is None:
                break
            if delay_hint is not None:
                hint_s = delay_hint(last)
                if hint_s is not None:
                    j = (rng.uniform(-self.jitter, self.jitter)
                         if self.jitter else 0.0)
                    delay = min(self.max_delay_s,
                                max(0.0, float(hint_s) * (1.0 + j)))
            if self.deadline_s is not None and \
                    time.monotonic() - t0 + delay > self.deadline_s:
                break
            counter.inc()
            sleep(delay)
        elapsed = time.monotonic() - t0
        why = (f"deadline {self.deadline_s:g}s exceeded"
               if attempt < self.max_attempts
               else f"attempt budget {self.max_attempts} spent")
        raise RetriesExhausted(
            f"{site}: gave up after {attempt} attempt(s) in "
            f"{elapsed:.1f}s ({why})") from last


# the device-dispatch default: fast, few attempts (a lockstep batch is
# expensive to sit on), generous cap
DEVICE_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.1,
                           max_delay_s=5.0)

# the serve client's overloaded-backpressure default: patient, deadline-
# governed (the attempt bound is a backstop, not the limiter)
OVERLOADED_RETRY = RetryPolicy(max_attempts=128, base_delay_s=0.05,
                               max_delay_s=2.0, deadline_s=120.0)

# status markers of a transient failure (pbccs_tpu's list).
# RESOURCE_EXHAUSTED is deliberately not here: a device OOM is
# capacity-shaped, and retrying the identical batch shape cannot succeed.
_TRANSIENT_MARKERS = ("UNAVAILABLE", "ABORTED", "DEADLINE_EXCEEDED",
                      "transient")


def is_transient_device_error(exc: BaseException) -> bool:
    """True when exc carries a transient status marker and is neither
    memory exhaustion nor a fault of the card or of the kernels
    (device.is_device_error: those are sticky under CUDA, and a retry
    would only fail again on the same context)."""
    from pbccs_tpu_torch.device import is_device_error
    from pbccs_tpu_torch.resilience.resources import is_capacity_error

    if is_capacity_error(exc) or is_device_error(exc):
        return False
    text = str(exc)
    return any(m in text for m in _TRANSIENT_MARKERS)
