"""Ordered bounded work pipeline: produce tasks, consume results in order.

The host-side scheduling spine of the CLI: a bounded pool runs consensus
batches concurrently while a consumer drains results in submission order
(so the output BAM preserves input order), with worker exceptions propagated
to both producer and consumer.  Parity: reference include/pacbio/ccs/
WorkQueue.h:53-217 (bounded head set, FIFO future queue, Finalize).

The heavy lifting is batched device programs, so the pool's job is
overlap of host stages (BAM decode, POA drafts, writeback) with device
compute -- threads, not processes, are the right tool (the GIL is released
inside device calls and zlib).

The pipeline bound counts results not yet CONSUMED, not tasks not yet
finished: releasing the slot at task completion let `_futures` hold
unboundedly many completed results whenever the consumer lagged the pool
(the reference's bounded head set has the same consume-time semantics,
WorkQueue.h:129-166).
"""

from __future__ import annotations

import queue
import threading
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator, TypeVar

from pbccs_tpu_torch.obs.metrics import default_registry

T = TypeVar("T")

_reg = default_registry()
# shared across WorkQueue instances (concurrent queues sum; normally one)
_depth = _reg.gauge("ccs_workqueue_depth",
                    "Tasks produced but not yet consumed")
_produced = _reg.counter("ccs_workqueue_produced_total",
                         "Tasks submitted to the work queue")
_consumed = _reg.counter("ccs_workqueue_consumed_total",
                         "Task results consumed in order")
_failures = _reg.counter("ccs_workqueue_task_failures_total",
                         "Worker tasks that raised (propagated)")


class WorkQueue:
    """Bounded thread pool whose results are consumed in submission order."""

    def __init__(self, n_workers: int, max_pending: int | None = None):
        if n_workers < 1:
            raise ValueError("need at least one worker")
        self._pool = ThreadPoolExecutor(max_workers=n_workers,
                                        thread_name_prefix="pbccs-worker")
        self._sem = threading.BoundedSemaphore(max_pending or 3 * n_workers)
        self._futures: queue.Queue[Future | None] = queue.Queue()
        self._failed = threading.Event()
        self._first_error: BaseException | None = None
        self._error_lock = threading.Lock()

    def _raise_failed(self) -> None:
        with self._error_lock:
            err = self._first_error
        raise RuntimeError("work queue failed; no new tasks accepted"
                           ) from err

    def produce(self, fn: Callable[..., T], *args, **kwargs) -> None:
        """Submit a task; blocks when the pipeline is full (backpressure).

        The slot is held until the result is CONSUMED from results(), so
        max_pending bounds the completed-but-unconsumed backlog too.
        Raises the original worker exception if a prior task already failed
        (reference WorkQueue.h:108-111 exception propagation to the
        producer); a producer blocked on a full pipeline wakes up and
        raises when a worker fails while it waits."""
        if self._failed.is_set():
            self._raise_failed()
        while not self._sem.acquire(timeout=0.05):
            if self._failed.is_set():
                self._raise_failed()

        def run():
            try:
                from pbccs_tpu_torch.resilience import faults

                # chaos site: a worker-task crash exercises the
                # propagate-to-producer/consumer path (and, under the
                # CLI's --checkpoint, the resume-after-crash path)
                faults.maybe_fail("workqueue.task")
                return fn(*args, **kwargs)
            except BaseException as e:
                # a propagated task failure aborts the whole pipeline;
                # make sure the log carries the traceback even if the
                # caller only surfaces the message
                _failures.inc()
                from pbccs_tpu_torch.runtime.logging import Logger
                Logger.default().error(
                    "work queue task failed: "
                    + "".join(traceback.format_exception(
                        type(e), e, e.__traceback__)))
                # publish the error BEFORE the flag: a producer/consumer
                # woken by _failed must never observe _first_error unset
                with self._error_lock:
                    if self._first_error is None:
                        self._first_error = e
                self._failed.set()
                raise

        self._futures.put(self._pool.submit(run))
        _produced.inc()
        _depth.inc()

    def finalize(self) -> None:
        """Signal that no more tasks will be produced."""
        self._futures.put(None)

    def results(self) -> Iterator:
        """Yield task results in submission order; re-raises the first
        worker exception (reference WorkQueue.h:129-166).  Each task's
        pipeline slot is released here, when its result is consumed."""
        while True:
            fut = self._futures.get()
            if fut is None:
                break
            try:
                result = fut.result()
            finally:
                self._sem.release()
                _depth.dec()
                _consumed.inc()
            yield result

    def consume_with(self, consumer: Callable[[T], None]) -> None:
        for result in self.results():
            consumer(result)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
        # drain unconsumed results (consumer bailed early, e.g. on a worker
        # exception) so any producer still blocked in acquire() can wake
        while True:
            try:
                fut = self._futures.get_nowait()
            except queue.Empty:
                break
            if fut is not None:
                try:
                    self._sem.release()
                    _depth.dec()
                except ValueError:
                    pass  # bounded: already fully released
        # wake any consumer still blocked on the queue (producer aborted
        # before finalize); a stray sentinel in a discarded queue is harmless
        self._futures.put(None)

    def __enter__(self) -> "WorkQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
