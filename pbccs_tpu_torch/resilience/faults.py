"""Seedable, site-based fault injection registry.

Copy of pbccs_tpu.resilience.faults: the same grammar, kinds, seeding
and PBCCS_FAULTS variable, so one chaos spec arms either package.  The
port's sites: polish.dispatch (the batch dispatch and the serial
rescue), prep.zmw, workqueue.task, output.write (BAM writer and report)
and checkpoint.record.

Production code marks *fault sites* -- named points where the real system
can fail (a device dispatch, a host prep, a checkpoint write) -- with

    faults.maybe_fail("polish.dispatch", keys=zmw_ids)
    data = faults.corrupt("checkpoint.record", data)

Both are no-ops (one module-global read) unless an injector is installed,
so the sites are safe to leave in the hot path.  An installed injector
fires DETERMINISTICALLY: each spec keeps its own eligible-call counter
and a seeded RNG, so the same spec string + seed produces the same fault
sequence on every run -- the property chaos tests need to assert exact
recovery behavior.

Spec grammar (comma-separated entries):

    site:kind[=arg][~key][@at][%prob][*times]

    kind   error     raise InjectedFault (arg = message marker; the
                     marker "transient" makes retry.is_transient_device_error
                     treat it as retryable)
           oom       raise InjectedFault carrying the RESOURCE_EXHAUSTED
                     marker: classified CAPACITY-shaped
                     (resources.is_capacity_error), exercising the
                     OOM-adaptive split path at dispatch sites
           enospc    raise OSError(ENOSPC) -- the real exception class a
                     full disk produces, so writer sites exercise their
                     production error handling, not a chaos special case
           delay     sleep arg seconds (a hang, for the watchdog)
           corrupt   mutate the payload passed to corrupt() at the site
           crashloop os._exit(86) -- the process dies instantly, like a
                     segfaulting binary, so the fleet supervisor's
                     crash-loop quarantine is chaos-testable without a
                     real broken build.  arg = how many supervisor
                     incarnations die (the supervisor exports the
                     0-based respawn counter as
                     PBCCS_FLEET_INCARNATION); no arg = every one
    ~key   fire only when one of the caller's keys equals `key`
           (poison-ZMW selection: keys are ZMW ids at polish sites;
           the supervisor's serve.start site keys on the fleet slot)
    @at    fire only on the at-th eligible call (1-based)
    %prob  fire with probability prob (seeded; default 1.0)
    *times fire at most `times` times total (default unlimited)

Examples:

    polish.dispatch:error~sim/3          # ZMW sim/3 poisons its batch
    polish.dispatch:delay=30@1           # first dispatch hangs 30 s
    polish.dispatch:error=transient@1*1  # one retryable device error
    checkpoint.record:corrupt@2          # torn journal record
    sched.dispatch:oom@1*1               # one device OOM -> split
    checkpoint.record:enospc@3*1         # disk fills at record 3
    output.write:enospc~bam@1*1          # BAM writer hits a full disk
    serve.start:crashloop=3~1            # fleet slot 1 dies 3 spawns

Enable via environment (read once, on first site hit):

    PBCCS_FAULTS="polish.dispatch:error~sim/3" PBCCS_FAULT_SEED=7 ccs ...

or programmatically with install()/active() (tests), or the CLI's
`--faults` flag (which just sets the same module state).  The variable
arms every package that reads it, so a test process holding both
packages installs injectors with active() instead.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Iterable, Sequence

import numpy as np

from pbccs_tpu_torch.obs.metrics import default_registry

_reg = default_registry()


class InjectedFault(RuntimeError):
    """An error raised by the fault injector (never by real code)."""

    def __init__(self, site: str, marker: str = ""):
        msg = f"injected fault at {site}"
        if marker:
            msg += f": {marker}"
        super().__init__(msg)
        self.site = site
        self.marker = marker


class FaultSpecError(ValueError):
    """A fault spec string violates the grammar."""


# the injectable failure vocabulary, one name per shaped recovery path:
# error (transient raise), delay (latency), corrupt (payload bytes),
# oom (capacity-shaped RESOURCE_EXHAUSTED -> governor split), enospc
# (disk-full OSError -> atomic-writer recovery), crashloop (instant
# process death -> supervisor respawn/quarantine).  The tuple is
# pbccs_tpu's, so a spec either package accepts arms the other.
FAULT_KINDS = ("error", "delay", "corrupt", "oom", "enospc", "crashloop")

# exit status of a crashloop-killed process (distinctive on purpose, so
# a supervisor log line attributes the death to injection at a glance)
CRASHLOOP_EXIT = 86


def _crashloop_armed(spec: FaultSpec) -> bool:
    """crashloop=N dies only while this process's fleet incarnation
    (the supervisor's 0-based respawn counter, exported as
    PBCCS_FLEET_INCARNATION) is < N; no/zero arg = every incarnation."""
    if not spec.arg:
        return True
    try:
        n = int(spec.arg)
    except ValueError:
        return True
    try:
        inc = int(os.environ.get("PBCCS_FLEET_INCARNATION", "0") or 0)
    except ValueError:
        inc = 0
    return n <= 0 or inc < n


@dataclasses.dataclass
class FaultSpec:
    """One parsed spec entry (see module docstring for the grammar)."""

    site: str
    kind: str                  # one of FAULT_KINDS
    arg: str = ""              # error marker / delay seconds
    key: str | None = None     # fire only when a caller key matches
    at: int | None = None      # fire only on the at-th eligible call
    prob: float = 1.0          # seeded firing probability
    times: int | None = None   # max total fires

    @property
    def delay_s(self) -> float:
        return float(self.arg or 1.0)


def parse_faults(text: str) -> list[FaultSpec]:
    """Parse a comma-separated spec string; raises FaultSpecError."""
    specs: list[FaultSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        site, sep, rest = raw.partition(":")
        if not sep or not site:
            raise FaultSpecError(f"bad fault spec {raw!r}: want site:kind")
        spec_kw: dict = {}
        # peel modifiers right-to-left so kind[=arg] stays a plain prefix
        fields = {"~": "key", "@": "at", "%": "prob", "*": "times"}
        while True:
            idx, mark = max((rest.rfind(m), m) for m in fields)
            if idx <= 0:
                break
            val, rest = rest[idx + 1:], rest[:idx]
            field = fields[mark]
            try:
                spec_kw[field] = (val if field == "key"
                                  else float(val) if field == "prob"
                                  else int(val))
            except ValueError:
                raise FaultSpecError(
                    f"bad fault modifier {mark}{val!r} in {raw!r}"
                ) from None
        kind, _, arg = rest.partition("=")
        if kind not in FAULT_KINDS:
            raise FaultSpecError(
                f"bad fault kind {kind!r} in {raw!r} "
                f"(want {'|'.join(FAULT_KINDS)})")
        specs.append(FaultSpec(site=site, kind=kind, arg=arg, **spec_kw))
    return specs


class FaultInjector:
    """A set of armed FaultSpecs with deterministic firing state."""

    def __init__(self, specs: Iterable[FaultSpec] | str, seed: int = 0):
        if isinstance(specs, str):
            specs = parse_faults(specs)
        self.specs = list(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._calls = [0] * len(self.specs)   # eligible-call counters
        self._fires = [0] * len(self.specs)
        # one seeded stream per spec: firing decisions are independent of
        # call order at OTHER sites, so multi-threaded runs stay
        # deterministic per site
        self._rngs = [np.random.default_rng((self.seed, i))
                      for i in range(len(self.specs))]
        self._counters: dict[tuple[str, str], object] = {}

    # ------------------------------------------------------------- firing

    def _due(self, i: int, spec: FaultSpec, keys: Sequence[str]) -> bool:
        """Advance spec i's state for one eligible call; True if it fires.
        Caller holds the lock."""
        if spec.key is not None and spec.key not in keys:
            return False
        self._calls[i] += 1
        if spec.at is not None and self._calls[i] != spec.at:
            return False
        if spec.times is not None and self._fires[i] >= spec.times:
            return False
        if spec.prob < 1.0 and self._rngs[i].random() >= spec.prob:
            return False
        self._fires[i] += 1
        return True

    def _record(self, spec: FaultSpec) -> None:
        key = (spec.site, spec.kind)
        c = self._counters.get(key)
        if c is None:
            c = _reg.counter("ccs_faults_injected_total",
                             "Faults fired by the injection registry",
                             site=spec.site, kind=spec.kind)
            self._counters[key] = c
        c.inc()

    def maybe_fail(self, site: str, keys: Sequence[str] = ()) -> None:
        """Fire any armed error/delay spec for `site` (raises / sleeps)."""
        delay = 0.0
        boom: FaultSpec | None = None
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site or spec.kind == "corrupt":
                    continue
                if spec.kind == "crashloop" and not _crashloop_armed(spec):
                    continue   # this incarnation survives (arg exhausted)
                if not self._due(i, spec, keys):
                    continue
                self._record(spec)
                if spec.kind == "delay":
                    delay = max(delay, spec.delay_s)
                else:
                    boom = spec
        if delay > 0.0:
            time.sleep(delay)
        if boom is not None:
            if boom.kind == "crashloop":
                # die like a segfault: no drain, no traceback, no exit
                # handlers -- the supervisor must see a hard child death
                os._exit(CRASHLOOP_EXIT)
            if boom.kind == "enospc":
                # the REAL exception class a full disk produces, so the
                # armed writer site exercises its production OSError
                # handling end to end (structured OutputWriteError,
                # atomic-tmp cleanup, torn-tail resume)
                import errno

                raise OSError(errno.ENOSPC,
                              f"No space left on device (injected at "
                              f"{site})")
            marker = ("RESOURCE_EXHAUSTED" if boom.kind == "oom"
                      else boom.arg)
            raise InjectedFault(site, marker)

    def corrupt(self, site: str, data, keys: Sequence[str] = ()):
        """Return `data`, corrupted if a corrupt spec fires for `site`.
        bytes: one byte flipped mid-record; int arrays: codes scrambled
        out of the valid base alphabet."""
        fire = False
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site or spec.kind != "corrupt":
                    continue
                if self._due(i, spec, keys):
                    self._record(spec)
                    fire = True
        if not fire:
            return data
        if isinstance(data, (bytes, bytearray)):
            b = bytearray(data)
            if b:
                b[len(b) // 2] ^= 0xFF
            return bytes(b)
        arr = np.array(data, copy=True)
        if arr.size:
            arr.flat[arr.size // 2] = 99   # far outside the base alphabet
        return arr

    def fired(self, site: str | None = None) -> int:
        with self._lock:
            return sum(f for spec, f in zip(self.specs, self._fires)
                       if site is None or spec.site == site)


# ------------------------------------------------------- module-level state

_injector: FaultInjector | None = None
_env_checked = False
_install_lock = threading.Lock()


def install(injector: FaultInjector | None) -> FaultInjector | None:
    """Install (or clear, with None) the process-wide injector."""
    global _injector, _env_checked
    with _install_lock:
        _injector = injector
        _env_checked = True   # explicit install wins over the env
    return injector


def configure(text: str | None, seed: int | None = None
              ) -> FaultInjector | None:
    """Parse + install a spec string (empty/None clears)."""
    if not text:
        return install(None)
    return install(FaultInjector(text, seed=seed or 0))


def get() -> FaultInjector | None:
    """The installed injector; first call arms PBCCS_FAULTS if set."""
    global _env_checked
    if not _env_checked:
        with _install_lock:
            if not _env_checked:
                _env_checked = True
                text = os.environ.get("PBCCS_FAULTS", "").strip()
                if text:
                    globals()["_injector"] = FaultInjector(
                        text,
                        seed=int(os.environ.get("PBCCS_FAULT_SEED", "0")))
    return _injector


def maybe_fail(site: str, keys: Sequence[str] = ()) -> None:
    """Site marker: no-op unless an injector is installed."""
    inj = get()
    if inj is not None:
        inj.maybe_fail(site, keys)


def corrupt(site: str, data, keys: Sequence[str] = ()):
    """Site marker for data corruption: identity unless armed."""
    inj = get()
    if inj is None:
        return data
    return inj.corrupt(site, data, keys)


class active:
    """Context manager installing an injector for a scope (tests)."""

    def __init__(self, specs: Iterable[FaultSpec] | str, seed: int = 0):
        self._injector = FaultInjector(specs, seed=seed)
        self._prev: FaultInjector | None = None

    def __enter__(self) -> FaultInjector:
        self._prev = get()
        install(self._injector)
        return self._injector

    def __exit__(self, *exc) -> None:
        install(self._prev)
