"""Dynamic batcher: group pending ZMW requests into shape buckets.

Port of pbccs_tpu.serve.batcher, unchanged but for its imports.  The
continuous-batching core of the serving engine.  Each pending item
carries the (Jmax, Imax) length bucket its ZMW polishes in
(parallel.batch.length_bucket -- the same shape key the offline
BatchPolisher derives, so the ZMWs of one flush share their template
and read buckets) and a flush-by time.  A bucket flushes when

  * it FILLS (max_batch items: the device batch is worth dispatching), or
  * the OLDEST item's flush-by expires (max-wait flush: the item's
    deadline slack ran out, so it stops waiting for co-batchable traffic
    and ships with whatever company it has -- possibly alone).

This module is pure data structure + clock arithmetic: no threads, no
sockets, no device calls.  The engine (serve.engine.CcsEngine) owns the
thread that sleeps until next_deadline() and dispatches what due()
returns; tests drive the same API with a fake clock.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Hashable

from pbccs_tpu_torch.obs.metrics import default_registry

BucketKey = Hashable

_reg = default_registry()
_m_flushes = {reason: _reg.counter("ccs_serve_flushes_total",
                                   "Bucket flushes by trigger",
                                   reason=reason)
              for reason in ("fill", "deadline", "drain")}
_m_batch_zmws = _reg.histogram("ccs_serve_batch_zmws",
                               "ZMWs per flushed batch",
                               buckets=(1, 2, 4, 8, 16, 32, 64, 128))
_m_bucketed = _reg.gauge("ccs_serve_bucketed",
                         "Requests parked in the dynamic batcher")


def _record_flush(batch: "Batch") -> "Batch":
    _m_flushes[batch.reason].inc()
    _m_batch_zmws.observe(len(batch.items))
    return batch


@dataclasses.dataclass
class PendingItem:
    """One admitted request waiting for its bucket to flush."""

    key: BucketKey
    payload: Any        # opaque to the batcher (the engine stores requests)
    admit_t: float      # monotonic admission time
    flush_by: float     # monotonic max-wait deadline (admit_t + slack)


@dataclasses.dataclass
class Batch:
    """One flushed bucket, ready to polish."""

    key: BucketKey
    items: list[PendingItem]
    reason: str         # "fill" | "deadline" | "drain"


class DynamicBatcher:
    """Thread-safe bucketed pending pool with fill- and deadline-flush.

    All methods may be called from any thread; flushed batches are
    returned to exactly one caller (items leave the pool atomically)."""

    def __init__(self, max_batch: int):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._buckets: dict[BucketKey, list[PendingItem]] = {}

    def add(self, item: PendingItem) -> Batch | None:
        """Admit one item; returns the fill-triggered Batch if this item
        topped off its bucket, else None."""
        with self._lock:
            pending = self._buckets.setdefault(item.key, [])
            pending.append(item)
            if len(pending) >= self.max_batch:
                del self._buckets[item.key]
                _m_bucketed.dec(len(pending) - 1)
                return _record_flush(Batch(item.key, pending, "fill"))
            _m_bucketed.inc()
            return None

    def due(self, now: float) -> list[Batch]:
        """Pop every bucket whose OLDEST item's flush-by has expired.

        The whole bucket ships, not just the expired item: the remaining
        items ride along for free (their polish is one batched program
        either way), which is the latency-optimal choice under the
        one-device model."""
        out = []
        with self._lock:
            for key in [k for k, items in self._buckets.items()
                        if min(i.flush_by for i in items) <= now]:
                batch = Batch(key, self._buckets.pop(key), "deadline")
                _m_bucketed.dec(len(batch.items))
                out.append(_record_flush(batch))
        return out

    def drain(self) -> list[Batch]:
        """Pop everything (engine shutdown / flush-now)."""
        with self._lock:
            out = [_record_flush(Batch(k, items, "drain"))
                   for k, items in self._buckets.items()]
            for b in out:
                _m_bucketed.dec(len(b.items))
            self._buckets.clear()
        return out

    def next_deadline(self) -> float | None:
        """Earliest flush-by over all pending items (None when empty) --
        what the engine's batcher thread sleeps until."""
        with self._lock:
            deadlines = [i.flush_by for items in self._buckets.values()
                         for i in items]
        return min(deadlines) if deadlines else None

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._buckets.values())

    def depth_by_bucket(self) -> dict[str, int]:
        """Queue depth per bucket key (status introspection)."""
        with self._lock:
            return {str(k): len(v) for k, v in self._buckets.items()}
