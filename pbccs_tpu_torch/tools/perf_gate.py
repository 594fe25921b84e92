"""The ccs-tune referee: a copy of tools/perf_gate.py's baseline and
comparison over the port's perf-ledger records.

tools/perf_gate.py imports pbccs_tpu's ledger schema, which the port
cannot load, so the port keeps its own copy of the gate's
``build_baseline`` and ``compare`` (with ``ignore``), reading the port's
``obs.ledger.LEDGER_FIELDS``.  Classes and tolerances are the gate's:
counters exact, ratios within an absolute band, compile counts exact
when the records' ``torch_version`` matches the baseline's (the gate
keys that on ``jax_version``), wall-clock and resource figures only on
a matching accelerator platform and never in counters-only mode, and
the baseline's ``floors`` as hard minimums.  tests/test_torch_tune.py
holds its verdicts to tools/perf_gate.py's on the same records.
"""

from __future__ import annotations

import statistics
from typing import Any

from pbccs_tpu_torch.obs.ledger import LEDGER_FIELDS

BASELINE_VERSION = 1

DEFAULT_TOLERANCES = {
    "counter": 0.0,    # allowed absolute count difference
    "ratio": 0.02,     # allowed absolute ratio difference
    "compile": 0.0,    # allowed absolute count difference (same torch)
    "wall": 0.35,      # allowed relative regression
    "resource": 0.5,   # allowed relative regression
}

# wall/resource metrics regress in a direction; improvements never fail
_LOWER_IS_BETTER = {"wall_s", "device_wait_s", "device_step_ms",
                    "compile_s", "peak_rss_bytes"}

# classes the gate may enforce (meta/live are recorded, never gated)
_GATED = ("counter", "ratio", "compile", "wall", "resource")


def _select_records(records: list[dict], select: dict) -> list[dict]:
    out = []
    for rec in records:
        if all(rec.get(k) == v for k, v in select.items()):
            out.append(rec)
    return out


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def observed_metrics(records: list[dict]) -> dict[str, Any]:
    """Collapse matching records into one observed-metric map: the LAST
    record for deterministic classes, the MEDIAN across records for the
    noisy wall/resource classes (median-of-N is the committed
    statistic, the gate's statistic)."""
    out: dict[str, Any] = {}
    last = records[-1]
    for field, cls in LEDGER_FIELDS.items():
        if cls in ("counter", "ratio", "compile"):
            if field == "region_shares":
                if isinstance(last.get(field), dict):
                    out[field] = last[field]
            elif _numeric(last.get(field)):
                out[field] = last[field]
        elif cls in ("wall", "resource"):
            vals = [r[field] for r in records if _numeric(r.get(field))]
            if vals:
                out[field] = statistics.median(vals)
    return out


def _violation(metric: str, cls: str, base, obs, tol) -> dict:
    return {"metric": metric, "class": cls, "baseline": base,
            "observed": obs, "tolerance": tol}


def compare(baseline: dict, records: list[dict], *,
            counters_only: bool = False,
            all_records: list[dict] | None = None,
            ignore: set[str] | frozenset[str] | None = None
            ) -> tuple[list[dict], list[str]]:
    """(violations, notes) of the observed ledger records vs baseline.

    `records` are the selector-matched records the class bands run
    over; `all_records` (default: same) is the whole ledger, which
    floors may fall back to for fields only specialized record kinds
    carry (e.g. tenant_snapshot's tenant_b_p99_gain).  `ignore` names
    metrics exempt from enforcement (noted, not silently dropped) --
    the ccs-tune referee uses it for fields a candidate knob
    legitimately perturbs (e.g. band_w changes compile counts)."""
    tol = {**DEFAULT_TOLERANCES, **(baseline.get("tolerances") or {})}
    base_metrics = baseline.get("metrics") or {}
    obs = observed_metrics(records)
    last = records[-1]
    notes: list[str] = []
    violations: list[dict] = []
    if ignore:
        exempt = sorted(set(ignore) & set(base_metrics))
        if exempt:
            base_metrics = {k: v for k, v in base_metrics.items()
                            if k not in ignore}
            notes.append("metrics exempted by --ignore: "
                         + ", ".join(exempt))

    fw_match = (last.get("torch_version") == baseline.get("torch_version"))
    platform = last.get("platform")
    wall_enforced = (not counters_only
                     and platform == baseline.get("platform")
                     and platform not in (None, "cpu"))
    if not fw_match:
        notes.append(
            f"compile-class metrics skipped: ledger torch_version "
            f"{last.get('torch_version')!r} != baseline "
            f"{baseline.get('torch_version')!r}")
    if not wall_enforced and not counters_only:
        notes.append(
            f"wall/resource classes skipped on platform {platform!r} "
            f"(baseline platform {baseline.get('platform')!r}; "
            "wall-clock is enforced on matching accelerator hosts only)")

    for metric, base_val in sorted(base_metrics.items()):
        cls = LEDGER_FIELDS.get(metric)
        if cls not in _GATED:
            notes.append(f"baseline metric {metric!r} has no gated "
                         "class; ignored")
            continue
        if cls == "compile" and not fw_match:
            continue
        if cls in ("wall", "resource") and not wall_enforced:
            continue
        obs_val = obs.get(metric)
        if metric == "region_shares":
            base_shares = base_val if isinstance(base_val, dict) else {}
            obs_shares = obs_val if isinstance(obs_val, dict) else {}
            for region in sorted(set(base_shares) | set(obs_shares)):
                b = float(base_shares.get(region, 0.0))
                o = float(obs_shares.get(region, 0.0))
                if abs(o - b) > tol["ratio"]:
                    violations.append(_violation(
                        f"region_shares.{region}", "ratio", b, o,
                        tol["ratio"]))
            continue
        if not _numeric(base_val):
            # defense in depth for library callers that skipped the
            # bad_baseline_reason gate; main() exits 2 before this
            notes.append(f"baseline metric {metric!r} is non-numeric; "
                         "skipped")
            continue
        if obs_val is None:
            violations.append(_violation(
                metric, cls, base_val, None, tol[cls]))
            continue
        if cls in ("counter", "compile", "ratio"):
            if abs(obs_val - base_val) > tol[cls]:
                violations.append(_violation(metric, cls, base_val,
                                             obs_val, tol[cls]))
        else:  # wall / resource: relative band, regression direction only
            if base_val == 0:
                continue
            if metric in _LOWER_IS_BETTER:
                rel = (obs_val - base_val) / base_val
            else:
                rel = (base_val - obs_val) / base_val
            if rel > tol[cls]:
                violations.append(_violation(metric, cls, base_val,
                                             round(obs_val, 4),
                                             tol[cls]))

    # floors: hard minimums (e.g. roofline_efficiency for the headline
    # config) -- a kernel-share slide fails here even when the relative
    # band above would tolerate it.  Enforcement gating mirrors the
    # floor field's class: wall/resource floors only on a matching
    # accelerator platform, compile floors only on a matching torch, and
    # none of them in --counters-only mode.
    floors = baseline.get("floors") or {}
    for metric, floor in sorted(floors.items()):
        cls = LEDGER_FIELDS.get(metric)
        if cls not in _GATED or not _numeric(floor):
            continue
        if counters_only:
            notes.append(f"floor {metric!r} skipped in counters-only "
                         "mode")
            continue
        if cls == "compile" and not fw_match:
            continue
        if cls in ("wall", "resource") and not wall_enforced:
            notes.append(f"floor {metric!r} skipped on platform "
                         f"{platform!r}")
            continue
        obs_val = obs.get(metric)
        if obs_val is None:
            # a floor may target a field only a specialized record kind
            # carries (tenant_snapshot's tenant_b_p99_gain): fall back
            # to the latest record of ANY kind in the ledger with it
            obs_val = next(
                (r[metric] for r in reversed(all_records or records)
                 if _numeric(r.get(metric))), None)
        if not _numeric(obs_val) or obs_val < floor:
            violations.append(_violation(metric, "floor", floor,
                                         obs_val, 0.0))
    return violations, notes


def build_baseline(records: list[dict], select: dict,
                   tolerances: dict | None = None) -> dict:
    """A fresh baseline document from observed records."""
    last = records[-1]
    return {
        "baseline_version": BASELINE_VERSION,
        "select": select,
        "torch_version": last.get("torch_version"),
        "platform": last.get("platform"),
        "tolerances": {**DEFAULT_TOLERANCES, **(tolerances or {})},
        "metrics": observed_metrics(records),
    }
