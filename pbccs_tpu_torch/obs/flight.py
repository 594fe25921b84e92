"""Refine-loop flight recorder: per-round convergence/occupancy records.

Port of pbccs_tpu.obs.flight, with the same metric names.  A lockstep
batch polishes Z ZMWs together until the last one converges, so the
question a continuous-batching change must answer is how much of each
round's batch was still doing useful work.  This module records that:

  * every refinement ROUND records (live slots, converged fraction,
    padding waste).  The port's refine loop runs on the device; the
    host reads a few flags and sizes each round (the live count, the
    longest template, whether any ZMW applied, one flag per pass of the
    greedy pick: some 9 blocking fetches a round) but fetches the
    per-ZMW counters once at the loop's end, so BatchPolisher.refine
    rebuilds its rounds from the fetched per-ZMW iteration counts (a ZMW
    with k iterations was live in rounds 0..k-1), with source="device";
  * the latest round's figures are exported as gauges
    (``ccs_refine_converged_fraction``, ``ccs_refine_slot_occupancy``,
    ``ccs_refine_padding_waste``) plus a ``ccs_refine_rounds_total``
    counter by source, which the perf ledger reads;
  * a BOUNDED ring buffer keeps the most recent records, and
    ``dump(reason)`` flushes them to the log when something goes wrong
    mid-polish (a quarantined ZMW, a memory-governor ceiling): the
    postmortem question is always "what was the loop doing just before".

Recording is a deque append + three gauge sets per round, so the
recorder is always on; there is no enable flag to forget.
"""

from __future__ import annotations

import collections
import json
import threading
from typing import Any

from pbccs_tpu_torch.obs.metrics import default_registry

_reg = default_registry()
_m_rounds = _reg.counter("ccs_refine_rounds_total",
                         "Refinement rounds recorded by the flight "
                         "recorder", source="host")
_m_rounds_dev = _reg.counter("ccs_refine_rounds_total", source="device")
_m_converged = _reg.gauge("ccs_refine_converged_fraction",
                          "Converged fraction of the most recent "
                          "refinement round's batch")
_m_occupancy = _reg.gauge("ccs_refine_slot_occupancy",
                          "Live (unconverged, real) slot fraction of the "
                          "most recent refinement round")
_m_padding = _reg.gauge("ccs_refine_padding_waste",
                        "Padding-slot fraction of the most recent "
                        "refinement round's Z axis")


class FlightRecorder:
    """Bounded ring of per-round refine records (thread-safe)."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._ring: collections.deque[dict[str, Any]] = \
            collections.deque(maxlen=capacity)
        self._seq = 0

    def record_round(self, batch: str, round_idx: int, live: int,
                     n_zmws: int, z: int, source: str = "host") -> None:
        """One refinement round: `live` unconverged real ZMWs out of
        `n_zmws` real in a Z-slot lockstep batch."""
        z = max(z, 1)
        n_real = max(min(n_zmws, z), 1)
        rec = {
            "batch": batch,
            "round": int(round_idx),
            "live": int(live),
            "n_zmws": int(n_zmws),
            "z": int(z),
            "converged_fraction": round(1.0 - live / n_real, 4),
            "slot_occupancy": round(live / z, 4),
            "padding_waste": round(1.0 - n_zmws / z, 4),
            "source": source,
        }
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
        (_m_rounds if source == "host" else _m_rounds_dev).inc()
        _m_converged.set(rec["converged_fraction"])
        _m_occupancy.set(rec["slot_occupancy"])
        _m_padding.set(rec["padding_waste"])

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str, logger=None, keep: bool = True) -> list:
        """Postmortem flush: log the ring's recent records (most recent
        last) under a single parseable line and count the dump.  `keep`
        leaves the ring intact (several dump sites may fire for one
        incident; the record stream stays continuous)."""
        with self._lock:
            records = list(self._ring)
            if not keep:
                self._ring.clear()
        _reg.counter("ccs_flight_dumps_total",
                     "Flight-recorder postmortem dumps by reason",
                     reason=reason).inc()
        if logger is not None:
            tail = records[-32:]
            logger.warn(
                f"flight recorder dump ({reason}): {len(records)} "
                f"record(s), last {len(tail)}: "
                + json.dumps(tail, separators=(",", ":")))
        return records


_default = FlightRecorder()


def default_recorder() -> FlightRecorder:
    """The process-wide flight recorder every refine loop records to."""
    return _default


def record_round(batch: str, round_idx: int, live: int, n_zmws: int,
                 z: int, source: str = "host") -> None:
    _default.record_round(batch, round_idx, live, n_zmws, z, source)


def dump(reason: str, logger=None) -> list:
    return _default.dump(reason, logger)
