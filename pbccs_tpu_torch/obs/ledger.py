"""Performance ledger: schema-versioned NDJSON per-run perf records.

Port of pbccs_tpu.obs.ledger with the same schema, so one
tools/perf_gate.py and one dashboard read either package's records:

  * one NDJSON record per run, appended to ``--perfLedger PATH`` by the
    batch CLI (cli.py);
  * every field carries a TOLERANCE CLASS (``LEDGER_FIELDS``, pbccs_tpu's
    table field for field, serve-tier fields included) that the gate
    keys enforcement on -- wall-clock metrics are noisy and
    accelerator-only, CPU-deterministic counters are exact everywhere
    (the class vocabulary is documented on ``LEDGER_CLASSES``).  The one
    field that names the framework is ``torch_version`` where pbccs_tpu
    writes ``jax_version``; the gate's compile class, keyed on
    jax_version, is therefore enforced on a port record only against a
    port baseline (None on both sides), never against pbccs_tpu's;
  * appends are journal-shaped like the checkpoint journal: one line
    per record, flushed, torn tails tolerated by the reader
    (``read_ledger`` skips an unparseable final line and counts it).  A
    failing filesystem degrades the ledger to absence (counted under
    ``ccs_output_write_errors_total{sink=perf_ledger}``), never to a
    crashed run.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

from pbccs_tpu_torch.obs.metrics import MeasurementScope, default_registry

LEDGER_SCHEMA_VERSION = 1

# Tolerance classes (what tools/perf_gate.py enforces per class):
#   meta     identity/environment fields -- recorded, never gated
#   live     point-in-time serving state -- recorded, never gated
#   wall     wall-clock measurements: median-of-N vs a relative band,
#            enforced only on accelerator hosts (CPU wall time is noise)
#   resource host-memory figures: relative band, accelerator hosts only
#   counter  CPU-deterministic counts: exact match, enforced everywhere
#   ratio    CPU-deterministic ratios/shares (fill, padding, region
#            shares): absolute band, enforced everywhere
#   compile  compile/cache counts: exact match everywhere, but only
#            when the ledger's jax_version matches the baseline's (a
#            jax upgrade legitimately changes compile behavior; the
#            port's counts are nvcc builds and build-cache lookups,
#            ops/cuda_lib.py)
LEDGER_CLASSES = ("meta", "live", "wall", "resource", "counter", "ratio",
                  "compile")

# The canonical field -> tolerance-class schema (pbccs_tpu's, with
# torch_version for jax_version).  PerfLedger.append refuses fields
# outside it -- a writer cannot mint an undocumented field.
LEDGER_FIELDS = {
    # ---- identity / environment (meta) ----
    "schema_version": "meta",
    "kind": "meta",            # batch_run | bench_row | serve_snapshot |
    #                            router_snapshot | replica_snapshot |
    #                            fleet_event | tenant_snapshot
    "t_unix": "meta",
    "source": "meta",          # emitting process/row identity
    "workload": "meta",        # free-form workload descriptor (dict)
    "platform": "meta",        # "gpu" on a CUDA device, else "cpu"
    "torch_version": "meta",
    "devices": "meta",
    "tuned_profile": "meta",   # active ccs-tune profile id, or "none"
    # ---- wall-clock (wall: accelerator-only, median-of-N) ----
    "wall_s": "wall",
    "zmws_per_sec": "wall",
    "device_wait_s": "wall",
    "device_step_ms": "wall",  # mean device fetch-to-fetch step
    "compile_s": "wall",       # warmup/compile seconds where measured
    # roofline rates: flops-charged / refine wall (a timing, so wall
    # class -- but also floor-gated via PERF_BASELINE.json "floors")
    "roofline_achieved_tflops": "wall",
    "roofline_efficiency": "wall",
    # ---- host memory (resource) ----
    "peak_rss_bytes": "resource",
    # ---- CPU-deterministic counters (exact everywhere) ----
    "zmws": "counter",
    "results": "counter",
    "polish_dispatches": "counter",
    "batch_polishes": "counter",
    "sched_batches": "counter",
    "refine_rounds_host": "counter",
    "refine_rounds_device": "counter",
    "zmw_slots": "counter",
    "zmw_slots_used": "counter",
    "read_slots": "counter",
    "read_slots_used": "counter",
    "device_fetches": "counter",
    "quarantined_zmws": "counter",
    "degraded_zmws": "counter",
    "watchdog_timeouts": "counter",
    "oom_splits": "counter",
    "oom_ceilings": "counter",
    "admission_presplits": "counter",
    "budget_throttles": "counter",
    # roofline plane (obs/roofline.py): CostCard-bound work charged for
    # executed canonical programs -- integer-scaled from a card counted
    # from the shapes, so deterministic everywhere
    "roofline_flops": "counter",
    "roofline_bytes": "counter",
    # ---- CPU-deterministic ratios/shares (absolute band everywhere) ----
    "fill_ratio_zmw": "ratio",
    "fill_ratio_read": "ratio",
    "padding_waste": "ratio",
    "slot_occupancy": "ratio",
    "converged_fraction": "ratio",
    "kernel_fraction": "ratio",
    "region_shares": "ratio",  # {region: share of device self-time}
    # ---- compile/cache counts (exact iff jax_version matches) ----
    "compiles": "compile",
    "compile_cache_hits": "compile",
    "compile_cache_misses": "compile",
    # ---- fleet-autopilot events (meta: audit trail, never gated) ----
    # one record per supervisor decision (kind == "fleet_event"):
    # respawn | quarantine | readmit | scale_up | scale_down | add |
    # remove | drain_kill | rolling_restart_begin / _step / _done
    "fleet_event": "meta",
    "slot": "meta",            # supervisor slot index the event is about
    "reason": "meta",          # structured cause (quarantine/bench text)
    "attempt": "meta",         # respawn attempt number within the window
    "backoff_s": "meta",       # backoff applied before the next respawn
    # ---- live serving state (recorded, never gated) ----
    "uptime_s": "live",
    "pending": "live",
    "in_flight_zmws": "live",
    "completed": "live",
    "errors": "live",
    "slo_requests": "live",
    "slo_violations": "live",
    "queue_depth": "live",
    "replica": "live",
    # ---- multi-tenant edge (kind == "tenant_snapshot" accounting rows
    # from the router's fair queue, plus bench noisy-neighbor figures) ----
    "tenant": "meta",            # tenant name the record is about
    "tenant_priority": "meta",   # shed class (0 = never shed)
    "tenant_inflight": "live",
    "tenant_queued": "live",
    "tenant_completed": "live",
    "tenant_sheds": "live",
    "tenant_rejects": "live",
    "tenant_p99_ms": "wall",     # per-tenant p99 under contention
    "tenant_b_p99_gain": "wall",  # victim p99 fairness-off / fairness-on
}

_reg = default_registry()


def _m_records(kind: str):
    return _reg.counter("ccs_ledger_records_total",
                        "Perf-ledger records appended, by record kind",
                        kind=kind)


def _m_write_errors():
    # the shared output-failure counter (resilience.resources registers
    # the name); the ledger is one more sink under it
    return _reg.counter("ccs_output_write_errors_total", sink="perf_ledger")


class LedgerSchemaError(ValueError):
    """A record carries a field outside LEDGER_FIELDS."""


class PerfLedger:
    """Append-only NDJSON perf journal (thread-safe).

    One ``append(record)`` per run/row/snapshot; each line is flushed so
    a crash loses at most the in-flight record and the reader's
    torn-tail tolerance absorbs a half-written one.  A filesystem
    failure (ENOSPC, quota) disables the ledger with a warning and a
    ``ccs_output_write_errors_total{sink=perf_ledger}`` count --
    observability must degrade to absence, never crash the run."""

    def __init__(self, path: str, logger=None):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None
        self._dead = False
        self._records = 0
        self._last: dict[str, Any] | None = None
        self._log = logger

    def _warn(self, msg: str) -> None:
        if self._log is not None:
            self._log.warn(msg)

    def append(self, record: dict[str, Any]) -> bool:
        """Validate + append one record; returns False when the ledger
        is disabled (a prior write failure).  Unknown fields raise
        LedgerSchemaError -- the schema table is the contract."""
        unknown = sorted(set(record) - set(LEDGER_FIELDS))
        if unknown:
            raise LedgerSchemaError(
                f"fields not in LEDGER_FIELDS: {', '.join(unknown)} "
                "(extend the schema in both packages)")
        rec = {"schema_version": LEDGER_SCHEMA_VERSION,
               "t_unix": round(time.time(), 3), **record}
        line = json.dumps(rec, separators=(",", ":"), sort_keys=True,
                          default=str) + "\n"
        with self._lock:
            if self._dead:
                return False
            try:
                if self._fh is None:
                    self._fh = open(self.path, "a")
                self._fh.write(line)
                self._fh.flush()
            except OSError as e:
                self._dead = True
                _m_write_errors().inc()
                self._warn(f"perf ledger {self.path} disabled after "
                           f"write failure: {e}")
                return False
            self._records += 1
            self._last = rec
        _m_records(str(rec.get("kind", "unknown"))).inc()
        return True

    def records_written(self) -> int:
        with self._lock:
            return self._records

    def last_record(self) -> dict[str, Any] | None:
        with self._lock:
            return dict(self._last) if self._last is not None else None

    def perf_block(self) -> dict[str, Any]:
        """The status verb's `perf` block: the schema version, how many
        records this process appended, and the most recent record."""
        return {"schema_version": LEDGER_SCHEMA_VERSION,
                "records": self.records_written(),
                "last_record": self.last_record()}

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_ledger(path: str) -> tuple[list[dict[str, Any]], int]:
    """Parse an NDJSON ledger; returns (records, skipped_lines).  A torn
    tail (crash mid-append) or an alien line is skipped and counted,
    never a raise -- the checkpoint journal's loader contract."""
    records: list[dict[str, Any]] = []
    skipped = 0
    try:
        fh = open(path)
    except OSError:
        return [], 0
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(obj, dict):
                records.append(obj)
            else:
                skipped += 1
    return records, skipped


# --------------------------------------------------- record construction

def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _counter(delta: dict, name: str, **labels) -> int:
    v = delta.get((name, _label_key(labels)), 0.0)
    return int(round(v)) if isinstance(v, (int, float)) else 0


def _counter_sum(delta: dict, name: str) -> int:
    """Sum a labeled counter family's deltas (site/cause labels)."""
    return int(round(sum(
        v for (n, _), v in delta.items()
        if n == name and isinstance(v, (int, float)))))


def environment_fields(device=None) -> dict[str, Any]:
    """The meta fields every record shares: platform, torch version and
    tuned profile.  `platform` is "gpu" for a CUDA `device`, "cpu" for
    another; with no device, "gpu" only when this process already holds
    a CUDA context -- a ledger append never creates one.
    `tuned_profile` is the applied `ccs tune` profile's id, "none" on
    the hand-tuned defaults (runtime/tuning.ledger_tag)."""
    from pbccs_tpu_torch.runtime import tuning

    out: dict[str, Any] = {"tuned_profile": tuning.ledger_tag()}
    try:
        import torch

        out["torch_version"] = torch.__version__
        if device is not None:
            cuda = torch.device(device).type == "cuda"
        else:
            cuda = torch.cuda.is_initialized()
        out["platform"] = "gpu" if cuda else "cpu"
    except Exception:  # noqa: BLE001 -- environment capture is best-effort
        pass
    return out


def run_record(scope: MeasurementScope, *, kind: str, source: str,
               workload: dict | None = None,
               wall_s: float | None = None,
               zmws: int | None = None,
               results: int | None = None,
               kernel_fraction: float | None = None,
               region_shares: dict | None = None,
               extra: dict | None = None,
               device=None) -> dict[str, Any]:
    """Build one ledger record from a MeasurementScope's registry deltas
    plus caller-known figures.  The scope supplies every counter the
    registry already tracks (compiles, refine rounds, slot fills,
    governor interventions); the caller supplies what only it knows
    (wall time, workload identity, region attribution); `device` is the
    one the run polished on (environment_fields, and the roofline
    efficiency's peak)."""
    from pbccs_tpu_torch.resilience.resources import peak_rss_bytes

    # ONE registry snapshot for the whole record (scope.counter_value
    # would re-snapshot per field)
    delta = scope.delta()
    zslots = _counter(delta, "ccs_batch_slots_total", axis="zmw")
    zused = _counter(delta, "ccs_batch_slots_used_total", axis="zmw")
    rslots = _counter(delta, "ccs_batch_slots_total", axis="read")
    rused = _counter(delta, "ccs_batch_slots_used_total", axis="read")
    fetches = _counter(delta, "ccs_device_fetches_total")
    wait_s = float(delta.get(("ccs_device_wait_seconds_total", ()), 0.0))
    rec: dict[str, Any] = {
        "kind": kind,
        "source": source,
        **environment_fields(device),
        "polish_dispatches": _counter(delta, "ccs_polish_dispatches_total"),
        "batch_polishes": _counter(delta, "ccs_batch_polishes_total"),
        "sched_batches": _counter(delta, "ccs_sched_batches_total"),
        "refine_rounds_host": _counter(delta, "ccs_refine_rounds_total",
                                       source="host"),
        "refine_rounds_device": _counter(delta, "ccs_refine_rounds_total",
                                         source="device"),
        "zmw_slots": zslots,
        "zmw_slots_used": zused,
        "read_slots": rslots,
        "read_slots_used": rused,
        "device_fetches": fetches,
        "device_wait_s": round(wait_s, 4),
        "quarantined_zmws": _counter(delta, "ccs_quarantined_zmws_total"),
        "degraded_zmws": _counter(delta, "ccs_degraded_zmws_total"),
        "oom_splits": _counter(delta, "ccs_resource_oom_splits_total"),
        "oom_ceilings": _counter(delta, "ccs_resource_oom_ceilings_total"),
        "admission_presplits": _counter(
            delta, "ccs_resource_presplit_batches_total"),
        "compiles": _counter(delta, "ccs_compiles_total"),
        "compile_cache_hits": _counter(delta,
                                       "ccs_compile_cache_events_total",
                                       kind="hit"),
        "compile_cache_misses": _counter(
            delta, "ccs_compile_cache_events_total", kind="miss"),
        "peak_rss_bytes": peak_rss_bytes(),
        # watchdog + throttles carry site/cause labels; sum across them
        "watchdog_timeouts": _counter_sum(delta,
                                          "ccs_watchdog_timeouts_total"),
        "budget_throttles": _counter_sum(delta,
                                         "ccs_resource_throttles_total"),
    }
    if zslots:
        rec["fill_ratio_zmw"] = round(zused / zslots, 4)
        rec["padding_waste"] = round(1.0 - zused / zslots, 4)
    if rslots:
        rec["fill_ratio_read"] = round(rused / rslots, 4)
    if fetches and wait_s:
        rec["device_step_ms"] = round(wait_s * 1e3 / fetches, 4)
    # roofline plane (obs/roofline.py): CostCard-bound work charged over
    # this window.  Absent when no card was available (degraded path) --
    # the gate only compares fields both sides carry.
    rl_flops = _counter_sum(delta, "ccs_roofline_flops_total")
    if rl_flops > 0:
        rec["roofline_flops"] = rl_flops
        rec["roofline_bytes"] = _counter_sum(
            delta, "ccs_roofline_bytes_total")
        rl_wall = float(sum(
            v for (n, _), v in delta.items()
            if n == "ccs_roofline_refine_seconds_total"
            and isinstance(v, (int, float))))
        if rl_wall > 0:
            from pbccs_tpu_torch.obs import roofline as _roofline
            achieved = rl_flops / 1e12 / rl_wall
            peak = _roofline.tracker().peak_tflops(device)
            rec["roofline_achieved_tflops"] = float(f"{achieved:.6g}")
            if peak > 0:
                rec["roofline_efficiency"] = float(
                    f"{achieved / peak:.6g}")
    if workload is not None:
        rec["workload"] = workload
    if wall_s is not None:
        rec["wall_s"] = round(float(wall_s), 4)
        if zmws:
            rec["zmws_per_sec"] = round(zmws / wall_s, 4)
    if zmws is not None:
        rec["zmws"] = int(zmws)
    if results is not None:
        rec["results"] = int(results)
    if kernel_fraction is not None:
        rec["kernel_fraction"] = round(float(kernel_fraction), 4)
    if region_shares:
        total = sum(region_shares.values())
        if total > 0:
            rec["region_shares"] = {
                k: round(v / total, 4)
                for k, v in sorted(region_shares.items())}
    if extra:
        rec.update(extra)
    return rec
