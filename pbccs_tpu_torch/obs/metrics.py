"""Thread-safe metrics registry: counters, gauges, log-bucket histograms.

Copy of pbccs_tpu.obs.metrics without the text-level federation helpers
(parse_exposition, relabel_exposition, merge_expositions,
histogram_quantile), which serve the router of a tier the port does not
have yet.  Metric names are pbccs_tpu's, so a dashboard reads either
package.  Design constraints, in order:

  * cheap enough to leave on: one instance-lock add per update, metric
    handles are cached by callers (instruments are get-or-create keyed
    on (name, labels), so hot paths hold a direct reference);
  * concurrent measurement windows: values are MONOTONE (counters and
    histogram buckets only grow); a MeasurementScope snapshots the
    registry and reports deltas, so any number of windows (a CLI run, a
    test, chip_smoke's phases) read the same registry without
    clobbering each other;
  * standard exposition: render_prometheus() emits the Prometheus text
    format and summary_table() the human end-of-run table the CLI
    prints.

Histograms use FIXED log-scale buckets (geometric bounds chosen at
creation, +Inf implicit): latency distributions span 4+ decades between
a device fetch and a 15 kb polish, where linear buckets are either
blind or enormous.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Iterable, Mapping

MetricKey = tuple[str, tuple[tuple[str, str], ...]]


def _label_key(labels: Mapping[str, object]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def log_buckets(lo: float, hi: float, factor: float = math.sqrt(10.0)
                ) -> tuple[float, ...]:
    """Geometric bucket bounds lo, lo*factor, ... up to and including the
    first bound >= hi (the +Inf bucket is implicit)."""
    if lo <= 0 or hi <= lo or factor <= 1.0:
        raise ValueError("need 0 < lo < hi and factor > 1")
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


# default bounds: seconds, 100 us .. ~5 min in half-decade steps
DEFAULT_SECONDS_BUCKETS = log_buckets(1e-4, 300.0)


class Counter:
    """Monotone float counter."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: tuple[tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time float value."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: tuple[tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bound histogram (log-scale bounds by default, +Inf implicit).

    Cumulative bucket semantics live in the RENDERING (Prometheus `le`
    lines); internally counts are per-bucket so scope deltas subtract
    cleanly.  observe() is one bisect + two locked adds."""

    __slots__ = ("name", "labels", "bounds", "_lock", "_counts", "_sum",
                 "_count")

    def __init__(self, name: str, labels: tuple[tuple[str, str], ...] = (),
                 bounds: Iterable[float] | None = None):
        self.name = name
        self.labels = labels
        bounds = tuple(bounds) if bounds is not None \
            else DEFAULT_SECONDS_BUCKETS
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram bounds must be strictly increasing")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        # bucket b holds values <= bounds[b] (Prometheus `le` semantics)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> tuple[tuple[int, ...], float, int]:
        with self._lock:
            return tuple(self._counts), self._sum, self._count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class MeasurementScope:
    """A measurement window over one registry: deltas since creation.

    Scopes are independent -- any number may be live at once (a bench
    repeat, a serve engine's uptime window, a test) because they only
    ever READ the registry; nothing is zeroed."""

    def __init__(self, registry: "MetricsRegistry"):
        self._registry = registry
        self._base = registry.snapshot()

    def delta(self) -> dict[MetricKey, object]:
        """Counter/histogram deltas since scope creation; gauges report
        their current value (a gauge has no meaningful delta)."""
        out: dict[MetricKey, object] = {}
        for key, (kind, val) in self._registry.snapshot().items():
            base = self._base.get(key)
            if kind == "counter":
                out[key] = val - (base[1] if base else 0.0)
            elif kind == "gauge":
                out[key] = val
            else:  # histogram: (counts, sum, count)
                counts, s, n = val
                if base is not None:
                    bc, bs, bn = base[1]
                    counts = tuple(c - b for c, b in zip(counts, bc))
                    s, n = s - bs, n - bn
                out[key] = (counts, s, n)
        return out

    def counter_value(self, name: str, **labels) -> float:
        return float(self.delta().get((name, _label_key(labels)), 0.0))

    def counters(self, name: str) -> dict[tuple[tuple[str, str], ...], float]:
        """All counter deltas sharing `name`, keyed by label tuple."""
        return {key[1]: v for key, v in self.delta().items()
                if key[0] == name and isinstance(v, float)}


class MetricsRegistry:
    """Get-or-create instrument registry with Prometheus exposition.

    ``max_series_per_name`` caps how many distinct label sets one metric
    name may register (default generous).  Per-replica / per-peer labels
    are minted from NETWORK identity (replica addresses, session peers),
    so a hostile or flapping fleet could otherwise grow the registry --
    and every scrape -- without bound.  Past the cap a NEW label set gets
    a detached instrument (updates work, nothing is recorded) and the
    drop is counted under ``ccs_metrics_series_dropped_total{metric}``
    instead of growing the exposition."""

    def __init__(self, max_series_per_name: int = 512):
        self._lock = threading.Lock()
        self._metrics: dict[MetricKey, Counter | Gauge | Histogram] = {}
        self._help: dict[str, str] = {}
        self._series_count: dict[str, int] = {}
        # label sets dropped by the cap, each holding ONE cached
        # detached instrument: the drop is counted once per label set,
        # and repeat lookups get the same (unrecorded) handle instead of
        # a fresh allocation per update on a by-definition hot path
        self._dropped: dict[MetricKey, Counter | Gauge | Histogram] = {}
        self._max_series = max_series_per_name

    def set_series_cap(self, max_series_per_name: int) -> None:
        """Adjust the per-name series cap (applies to NEW label sets)."""
        if max_series_per_name < 1:
            raise ValueError("max_series_per_name must be >= 1")
        with self._lock:
            self._max_series = max_series_per_name

    # ------------------------------------------------------------ creation

    _DROPPED = "ccs_metrics_series_dropped_total"

    def _get(self, cls, name: str, help: str | None, labels: dict,
             **kwargs):
        key = (name, _label_key(labels))
        dropped = new_drop = False
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                prior = self._dropped.get(key)
                if prior is not None:
                    if not isinstance(prior, cls):
                        raise TypeError(f"{name} already registered as "
                                        f"{type(prior).__name__}")
                    dropped, m = True, prior
                # the drop counter itself is exempt (its `metric` label
                # values are existing capped names, already bounded)
                elif name != self._DROPPED and \
                        self._series_count.get(name, 0) >= self._max_series:
                    # cardinality armor: the caller gets a working but
                    # DETACHED instrument (updates land nowhere), cached
                    # so the drop counts ONCE per label set
                    dropped = new_drop = True
                    m = self._dropped[key] = cls(name, key[1], **kwargs)
                else:
                    m = cls(name, key[1], **kwargs)
                    self._metrics[key] = m
                    self._series_count[name] = \
                        self._series_count.get(name, 0) + 1
            elif not isinstance(m, cls):
                raise TypeError(f"{name} already registered as "
                                f"{type(m).__name__}")
            if help and not dropped:
                self._help.setdefault(name, help)
        if new_drop:
            self.counter("ccs_metrics_series_dropped_total",
                         "New label sets dropped by the per-name series "
                         "cap", metric=name).inc()
        return m

    def counter(self, name: str, help: str | None = None,
                **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str | None = None, **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str | None = None,
                  buckets: Iterable[float] | None = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, bounds=buckets)

    # ------------------------------------------------------------- reading

    def snapshot(self) -> dict[MetricKey, tuple[str, object]]:
        """Point-in-time values of every instrument: (kind, value) where
        counter/gauge value is float and histogram value is
        (per-bucket counts, sum, count)."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[MetricKey, tuple[str, object]] = {}
        for key, m in items:
            if isinstance(m, Counter):
                out[key] = ("counter", m.value)
            elif isinstance(m, Gauge):
                out[key] = ("gauge", m.value)
            else:
                out[key] = ("histogram", m.snapshot())
        return out

    def scope(self) -> MeasurementScope:
        """Open a measurement window (see MeasurementScope)."""
        return MeasurementScope(self)

    # ---------------------------------------------------------- exposition

    @staticmethod
    def _fmt_labels(labels, extra: str = "") -> str:
        parts = [f'{k}="{_escape(v)}"' for k, v in labels]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.items())
            helps = dict(self._help)
        by_name: dict[str, list] = {}
        for (name, labels), m in sorted(metrics, key=lambda kv: kv[0]):
            by_name.setdefault(name, []).append((labels, m))
        lines: list[str] = []
        for name, group in by_name.items():
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(group[0][1])]
            if name in helps:
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, m in group:
                if isinstance(m, Histogram):
                    counts, s, n = m.snapshot()
                    cum = 0
                    for bound, c in zip(m.bounds, counts):
                        cum += c
                        le = self._fmt_labels(labels, f'le="{_fmt(bound)}"')
                        lines.append(f"{name}_bucket{le} {cum}")
                    le = self._fmt_labels(labels, 'le="+Inf"')
                    lines.append(f"{name}_bucket{le} {n}")
                    lines.append(
                        f"{name}_sum{self._fmt_labels(labels)} {_fmt(s)}")
                    lines.append(
                        f"{name}_count{self._fmt_labels(labels)} {n}")
                else:
                    lines.append(
                        f"{name}{self._fmt_labels(labels)} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"

    def summary_table(self, scope: MeasurementScope | None = None,
                      prefix: str = "ccs_") -> str:
        """Human-readable end-of-run table (the CLI prints this).  With a
        scope, rows are the scope's deltas; gauges are skipped either way
        (a point-in-time value would masquerade as a run delta)."""
        snap = self.snapshot()
        gauges = {k for k, (kind, _) in snap.items() if kind == "gauge"}
        if scope is not None:
            delta = {k: v for k, v in scope.delta().items()
                     if k not in gauges}
        else:
            delta = {k: v for k, (kind, v) in snap.items()
                     if kind != "gauge"}
        rows: list[tuple[str, str]] = []
        for (name, labels), v in sorted(delta.items()):
            if not name.startswith(prefix):
                continue
            label_s = ",".join(f"{k}={val}" for k, val in labels)
            display = f"{name}{{{label_s}}}" if label_s else name
            if isinstance(v, tuple):  # histogram (counts, sum, count)
                _, s, n = v
                if n == 0:
                    continue
                rows.append((display, f"n={n} sum={s:.4g} mean={s / n:.4g}"))
            else:
                if v == 0:
                    continue
                rows.append((display, f"{v:.6g}"))
        if not rows:
            return "(no metrics recorded)"
        width = max(len(r[0]) for r in rows)
        return "\n".join(f"{k:<{width}}  {v}" for k, v in rows)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def histogram_quantile(counts: "tuple[int, ...]",
                       bounds: "tuple[float, ...]", q: float) -> float:
    """Approximate quantile from per-bucket counts (the snapshot()
    layout: len(bounds)+1 buckets, last = +Inf overflow).  Returns the
    upper bound of the bucket holding the q-th observation (+Inf bucket
    reports the last finite bound -- a floor, honestly labeled by the
    caller); NaN when empty.  Used for the status verb's SLO block."""
    total = sum(counts)
    if total == 0 or not bounds:
        # empty histogram (or degenerate: every observation in the
        # implicit +Inf bucket with no finite bound to report) -- NaN,
        # never an IndexError mid-scrape
        return float("nan")
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every built-in instrument records to."""
    return _default
