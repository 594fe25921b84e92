"""Pipelined batch executor: host prepare overlapped with device polish.

Port of pbccs_tpu.sched.executor.  The work queue of the single-device
CLI runs each work item's draft and polish in turn on one thread; this
executor makes the overlap structural:

    reader ──> prepare threads (N: filter -> POA draft -> mapping ->
                   │            host marshalling of the polish)
                   │ prepared batches, keyed by polish-shape bucket
                   ▼
               DevicePool (one executor thread per device)
                   │ per-batch outcome tallies
                   ▼
               ordered emission (results yield in submission order, so
               checkpoint journaling and output order are those of the
               single-threaded driver)

Batch composition is untouched -- the same --chunkSize groups, prepared
and polished with the same shape derivation as pipeline.process_chunks --
so the output is the single-device run's, reordered in time only.

A batch the pool gives up on with a device error (device.is_device_error:
a fault of the card or the kernels, sticky on the only card) or with no
healthy device left fails the run, as on the work queue, so no later
batch is journaled behind it; pbccs_tpu tallies such a batch's ZMWs as
Other.  Any other failure that ran out of devices is tallied so here too.

A prepare thread makes no CUDA tensor: the prepare stages and the
prebake (pipeline.prebake_polish) are numpy, and the upload happens on
the device worker, whose torch ops and kernel launches run on its card's
current stream in issue order.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Iterator

from pbccs_tpu_torch import pipeline
from pbccs_tpu_torch.device import is_device_error
from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.obs.metrics import default_registry, log_buckets
from pbccs_tpu_torch.runtime.logging import Logger
from pbccs_tpu_torch.sched.pool import DevicePool, NoHealthyDevice

# per BATCH intervals through the prepare threads and the device fleet
_reg = default_registry()
_m_stages = {stage: _reg.histogram(
    "ccs_sched_stage_latency_seconds",
    "Per-batch stage intervals through the scheduled pipeline "
    "(prepare, dispatch wait, polish)",
    buckets=log_buckets(1e-4, 600.0), stage=stage)
    for stage in ("prepare", "dispatch", "polish")}
# batches the scheduled pipeline submitted to the device pool (the perf
# ledger's sched_batches)
_m_batches = _reg.counter(
    "ccs_sched_batches_total",
    "Prepared batches submitted to the device pool by the scheduled "
    "pipeline")

#: the longest one wait of the emitting thread blocks before it re-checks
_POLL_S = 0.2


class ScheduledPipeline:
    """Run (index, chunk-batch) work items through prepare threads and a
    DevicePool, yielding (index, ResultTally) in submission order."""

    def __init__(self, pool: DevicePool,
                 settings: "pipeline.ConsensusSettings",
                 prepare_workers: int = 2, on_error: str = "bisect",
                 max_inflight: int | None = None,
                 budget=None,
                 logger: Logger | None = None):
        self.pool = pool
        self.settings = settings
        self.prepare_workers = max(1, prepare_workers)
        self.on_error = on_error
        # bounds batches past the reader (prepping, queued on a device, or
        # done but not yet emitted)
        self.max_inflight = max_inflight or (
            self.prepare_workers + pool.n_devices + 2)
        # optional resources.HostBudget (--memBudget): each batch charges
        # its marshalled bytes before the prebake builds and releases when
        # its POLISH ends -- never at the ordered emission, where a waiter
        # could sit behind an earlier batch blocked in admit()
        self.budget = budget
        self._log = logger or Logger.default()

    # Each input item is (index, chunks, precomputed): precomputed is a
    # ResultTally restored from a checkpoint journal (emitted in its slot
    # without recomputation), None for real work.
    def run(self, items: Iterable[tuple[int, Any, Any]]
            ) -> Iterator[tuple[int, "pipeline.ResultTally"]]:
        cv = threading.Condition()
        done: dict[int, Any] = {}        # seq -> (idx, tally) | exception
        sem = threading.Semaphore(self.max_inflight)
        n_fed = [0]
        feeder_done = threading.Event()
        feeder_error: list[BaseException] = []
        stop = threading.Event()   # the consumer bailed: unwedge the feeder

        def finish(seq: int, payload) -> None:
            with cv:
                done[seq] = payload
                cv.notify_all()

        def polish_done(seq, idx, tally, preps, fut, lease=None) -> None:
            # a SchedFuture callback, whose exceptions the pool only logs:
            # anything raising here must still finish() this slot
            if lease is not None:
                lease.release()
            try:
                exc = fut.exception()
                if exc is not None and (is_device_error(exc) or isinstance(
                        exc, NoHealthyDevice)):
                    # a fault of the card or the kernels (sticky on the
                    # only card) or no card left: the run fails, as the
                    # work queue's does, and the batch is never journaled
                    finish(seq, exc)
                    return
                if exc is not None:
                    # the pool ran out of devices on this batch: account
                    # each ZMW (logged and counted), never drop silently
                    pipeline.record_zmw_failure(
                        "sched.polish", exc, zmw=f"batch[{len(preps)}]")
                    for _ in preps:
                        tally.tally(pipeline.Failure.OTHER)
                else:
                    outcomes = fut.result()
                    if len(outcomes) != len(preps):
                        raise RuntimeError(
                            f"polish returned {len(outcomes)} outcomes "
                            f"for {len(preps)} prepared ZMWs")
                    for failure, result in outcomes:
                        tally.tally(failure)
                        if result is not None:
                            tally.results.append(result)
                finish(seq, (idx, tally))
            except BaseException as e:  # noqa: BLE001 -- surfaced in run()
                finish(seq, e)

        def prep_one(seq: int, idx: int, chunks, precomputed) -> None:
            lease = None
            t_prep0 = time.monotonic()
            try:
                if precomputed is not None:
                    finish(seq, (idx, precomputed))
                    return
                tally, preps = pipeline.prepare_batch(chunks, self.settings)
                if not preps:
                    finish(seq, (idx, tally))
                    return
                imax, jmax, r = pipeline._pinned_batch_shapes(preps, None)
                key = (jmax, imax, r, len(preps))
                if self.budget is not None:
                    from pbccs_tpu_torch.parallel.batch import \
                        premarshal_nbytes

                    lease = self.budget.admit(
                        premarshal_nbytes((imax, jmax, r, len(preps))),
                        site="sched.prepare", abort=stop.is_set)
                    if stop.is_set():
                        if lease is not None:
                            lease.release()
                        return
                # the polish's host marshalling, built HERE while the
                # device workers polish earlier batches; Quiver polishes
                # per ZMW and never reads one.  A prebake failure falls
                # back to inline marshalling (accounted, never fatal)
                prebaked = None
                if self.settings.model != "quiver":
                    try:
                        prebaked = pipeline.prebake_polish(preps)
                    except Exception as e:  # noqa: BLE001 -- inline fallback
                        pipeline.record_zmw_failure(
                            "prepare.prebake", e,
                            zmw=f"batch[{len(preps)}]")
                settings, on_error = self.settings, self.on_error
                fleet = self.pool.n_devices > 1
                attempts = [0]
                t_submit = time.monotonic()
                _m_stages["prepare"].observe(max(t_submit - t_prep0, 0.0))

                def polish(device):
                    # first attempt on a fleet: a device-shaped failure
                    # (a hang, retries exhausted) escapes to the pool,
                    # which strikes the device and requeues the WHOLE
                    # batch; the requeued attempt quarantines locally
                    attempts[0] += 1
                    t_polish0 = time.monotonic()
                    if attempts[0] == 1:
                        _m_stages["dispatch"].observe(
                            max(t_polish0 - t_submit, 0.0))
                    try:
                        with obs_trace.span("polish", zmws=len(preps)):
                            return pipeline.polish_prepared_batch(
                                preps, settings, device=device,
                                on_error=on_error,
                                raise_device_shaped=fleet
                                and attempts[0] == 1,
                                prebaked=prebaked)
                    finally:
                        _m_stages["polish"].observe(
                            max(time.monotonic() - t_polish0, 0.0))

                from pbccs_tpu_torch.resilience import resources

                _m_batches.inc()
                self.pool.submit(
                    key, polish, zmws=len(preps),
                    capacity_bucket=resources.shape_bucket(imax, jmax, r),
                    callback=lambda fut: polish_done(seq, idx, tally,
                                                     preps, fut, lease))
            except BaseException as e:  # noqa: BLE001 -- surfaced in run()
                # the callback never ran (pool closed, prepare blew up):
                # the budget charge must not outlive the batch
                if lease is not None:
                    lease.release()
                finish(seq, e)

        prep_pool = ThreadPoolExecutor(
            self.prepare_workers, thread_name_prefix="ccs-sched-prep")

        def feed() -> None:
            try:
                for idx, chunks, precomputed in items:
                    while not sem.acquire(timeout=_POLL_S):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    seq = n_fed[0]
                    n_fed[0] += 1
                    prep_pool.submit(prep_one, seq, idx, chunks, precomputed)
            except BaseException as e:  # noqa: BLE001 -- surfaced in run()
                feeder_error.append(e)
            finally:
                feeder_done.set()
                with cv:
                    cv.notify_all()

        feeder = threading.Thread(target=feed, daemon=True,
                                  name="ccs-sched-feeder")
        feeder.start()
        try:
            next_seq = 0
            while True:
                with cv:
                    while next_seq not in done and not (
                            feeder_done.is_set() and next_seq >= n_fed[0]):
                        cv.wait(timeout=_POLL_S)
                    if next_seq not in done:
                        break  # feeder finished and everything emitted
                    payload = done.pop(next_seq)
                if isinstance(payload, BaseException):
                    raise payload
                yield payload
                sem.release()
                next_seq += 1
            if feeder_error:
                raise feeder_error[0]
        finally:
            # a consumer that bailed mid-stream leaves the feeder waiting
            # for a slot and prepare threads maybe waiting in admit(): both
            # poll the stop flag, so shutdown never hangs on them
            stop.set()
            sem.release()
            feeder.join(timeout=10.0)
            prep_pool.shutdown(wait=True)
