"""The tuner's objective: perf-ledger rows -> one comparable figure (a
copy of pbccs_tpu.tune.objective).

ZMW/s is primary (median across the candidate's repeat runs, mirroring
perf_gate's median-of-N statistic for wall-class fields); ties within
``REL_TIE_EPS`` break lexicographically on padding_waste (lower is
better: the knob reclaimed slot waste) then peak RSS (lower is better:
the knob costs less host memory).  p99 only exists on the serve leg.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any

#: relative ZMW/s difference under which two candidates tie and the
#: tie-breakers decide (CPU wall noise floor; perf_gate's wall band is
#: far wider because it guards regressions, not ranks candidates)
REL_TIE_EPS = 0.02


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Median figures over one candidate's repeat runs."""

    zmws_per_sec: float
    wall_s: float
    padding_waste: float | None = None
    peak_rss_bytes: float | None = None
    p99_ms: float | None = None
    repeats: int = 1

    def to_doc(self) -> dict[str, Any]:
        doc = {"zmws_per_sec": round(self.zmws_per_sec, 4),
               "wall_s": round(self.wall_s, 4),
               "repeats": self.repeats}
        if self.padding_waste is not None:
            doc["padding_waste"] = round(self.padding_waste, 4)
        if self.peak_rss_bytes is not None:
            doc["peak_rss_bytes"] = int(self.peak_rss_bytes)
        if self.p99_ms is not None:
            doc["p99_ms"] = round(self.p99_ms, 3)
        return doc


def _median(records: list[dict], field: str) -> float | None:
    vals = [r[field] for r in records
            if isinstance(r.get(field), (int, float))
            and not isinstance(r.get(field), bool)]
    return statistics.median(vals) if vals else None


def measure(records: list[dict], p99_ms: float | None = None
            ) -> Measurement | None:
    """Collapse one candidate's batch_run records (one per repeat) into
    a Measurement; None when the records carry no throughput figure."""
    zps = _median(records, "zmws_per_sec")
    wall = _median(records, "wall_s")
    if zps is None or wall is None:
        return None
    return Measurement(
        zmws_per_sec=zps, wall_s=wall,
        padding_waste=_median(records, "padding_waste"),
        peak_rss_bytes=_median(records, "peak_rss_bytes"),
        p99_ms=p99_ms, repeats=len(records))


def gain(candidate: Measurement, baseline: Measurement) -> float:
    """Relative ZMW/s improvement of candidate over baseline."""
    if baseline.zmws_per_sec <= 0:
        return 0.0
    return (candidate.zmws_per_sec - baseline.zmws_per_sec) \
        / baseline.zmws_per_sec


def better(candidate: Measurement, baseline: Measurement) -> bool:
    """Does candidate beat baseline?  Primary: ZMW/s.  Within the tie
    band, lexicographic tie-breakers: p99 (when both sides have one),
    padding_waste, then peak RSS -- all lower-is-better."""
    g = gain(candidate, baseline)
    if g > REL_TIE_EPS:
        return True
    if g < -REL_TIE_EPS:
        return False
    for cand_v, base_v in (
            (candidate.p99_ms, baseline.p99_ms),
            (candidate.padding_waste, baseline.padding_waste),
            (candidate.peak_rss_bytes, baseline.peak_rss_bytes)):
        if cand_v is None or base_v is None:
            continue
        if cand_v < base_v:
            return True
        if cand_v > base_v:
            return False
    # full tie: prefer the incumbent (a knob must EARN its profile slot)
    return False
