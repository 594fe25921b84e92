"""Deadline wrapper around a device dispatch.

Port of pbccs_tpu.resilience.watchdog: `run_with_deadline`,
`WatchdogTimeout`, `configure` and PBCCS_WATCHDOG_S, with the same
`ccs_watchdog_timeouts_total{site}` counter.  A dispatch that does not
return would otherwise stall the whole batch CLI.  The watchdog runs
the guarded callable on a disposable worker thread and bounds the wait;
on expiry it raises a structured WatchdogTimeout in the CALLER, who
recovers on the normal failure path (quarantine bisection).

Python cannot kill the worker -- it is abandoned (a daemon thread named
pbccs-watchdog-<site>) and its eventual result, if any, is discarded.
What the port recovers from is a hung dispatch as the watchdog defines
it: a callable that has not returned by its deadline (an injected
`delay` at polish.dispatch exercises exactly that).  The abandoned
worker wakes later and finishes its polish on the card beside the
recovery's own dispatches, on the same stream: its launches count and
its tensors add to peak memory until it ends, so a caller that reads
counters joins the pbccs-watchdog-* threads first.  A kernel that truly
never ends would also hold up every later launch on that stream; no
deadline can recover from that.

In torch the current CUDA device and the current stream are per thread,
and the kernels launch on the current stream of their tensors' device.
So the worker enters the caller's device and stream (and the caller's
resources.device_scope tag) before it calls the guarded callable.

The default deadline comes from PBCCS_WATCHDOG_S (0/unset = disabled) or
configure() (the CLI's --polishTimeout flag).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, TypeVar

import torch

from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.resilience import resources
from pbccs_tpu_torch.runtime.logging import Logger

T = TypeVar("T")

_reg = default_registry()


class WatchdogTimeout(TimeoutError):
    """A guarded callable exceeded its deadline (structured: site + s)."""

    def __init__(self, site: str, timeout_s: float):
        super().__init__(
            f"watchdog: {site or 'callable'} exceeded {timeout_s:g}s deadline")
        self.site = site
        self.timeout_s = timeout_s


_default_deadline: float | None = None


def configure(deadline_s: float | None) -> float | None:
    """Set the process default deadline (None reverts to the env);
    returns the value it replaces."""
    global _default_deadline
    prev, _default_deadline = _default_deadline, deadline_s
    return prev


def default_deadline_s() -> float:
    """The ambient dispatch deadline: configure() value, else
    PBCCS_WATCHDOG_S, else 0 (disabled)."""
    if _default_deadline is not None:
        return _default_deadline
    try:
        return float(os.environ.get("PBCCS_WATCHDOG_S", "0") or 0)
    except ValueError:
        return 0.0


def _caller_context() -> Callable[[], contextlib.AbstractContextManager]:
    """Read on the CALLER's thread: a factory of the context the worker
    enters -- the caller's device_scope tag and, once CUDA is in use,
    its current device and that device's current stream."""
    scope = resources.current_device()
    cuda = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        dev = torch.cuda.current_device()
        cuda = (dev, torch.cuda.current_stream(dev))

    def enter() -> contextlib.ExitStack:
        stack = contextlib.ExitStack()
        stack.enter_context(resources.device_scope(scope))
        if cuda is not None:
            stack.enter_context(torch.cuda.device(cuda[0]))
            stack.enter_context(torch.cuda.stream(cuda[1]))
        return stack

    return enter


def run_with_deadline(fn: Callable[[], T], timeout_s: float | None = None,
                      *, site: str = "") -> T:
    """Run fn() with a deadline; timeout_s None uses the ambient default,
    and <= 0 disables the wrapper entirely (fn runs on this thread).
    The worker runs fn under the caller's CUDA device and stream and its
    device_scope tag (see _caller_context)."""
    if timeout_s is None:
        timeout_s = default_deadline_s()
    if not timeout_s or timeout_s <= 0:
        return fn()

    done = threading.Event()
    abandoned = threading.Event()
    box: list = []          # [("ok", result)] or [("err", exc)]
    context = _caller_context()

    def target() -> None:
        try:
            with context():
                box.append(("ok", fn()))
        except BaseException as e:  # noqa: BLE001 -- re-raised by the
            # caller, or logged at debug if it already timed out
            box.append(("err", e))
            if abandoned.is_set():
                Logger.default().debug(
                    f"watchdog[{site}]: abandoned callable failed late: "
                    f"{e!r}")
        done.set()
    t = threading.Thread(target=target, daemon=True,
                         name=f"pbccs-watchdog-{site or 'anon'}")
    t.start()
    if not done.wait(timeout_s):
        abandoned.set()
        _reg.counter("ccs_watchdog_timeouts_total",
                     "Guarded callables that exceeded their deadline",
                     site=site or "anon").inc()
        Logger.default().warn(
            f"watchdog: {site or 'callable'} still running after "
            f"{timeout_s:g}s; abandoning it")
        raise WatchdogTimeout(site, timeout_s)
    status, payload = box.pop()
    if status == "ok":
        return payload
    try:
        raise payload
    finally:
        # no frame of this call keeps the exception (and through its
        # traceback the failed dispatch's tensors) alive in a cycle
        del payload
