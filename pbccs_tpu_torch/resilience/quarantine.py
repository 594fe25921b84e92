"""Poison-ZMW isolation: bisect a failed polish batch, quarantine the
culprit(s), optionally degrade them to draft-only consensus.

Port of pbccs_tpu.resilience.quarantine.  The lockstep batch fuses Z
ZMWs into one device program, so one poison ZMW fails the whole batch.
Bisection isolates k poison ZMWs in O(k log Z) re-dispatches;
sub-batches are pinned by the caller to the parent batch's (Imax, Jmax,
R) buckets, so the surviving ZMWs come out byte-identical (the band
width is a function of the bucket).

A singleton whose own pinned dispatch fails gets one serial-pipeline
rescue (the per-ZMW ArrowMultiReadScorer path, under the watchdog
deadline and with the polish.dispatch fault site inside it, as in
pbccs_tpu); only if that also fails is the ZMW quarantined:

  * default: tallied Failure.OTHER (the reference's outcome), with the
    exception class and traceback logged;
  * with ConsensusSettings.degrade_quarantined: emitted as a draft-only
    consensus -- the POA draft with QVs capped at DRAFT_QV_CAP and
    ConsensusResult.draft_only set (the CLI writes a `df` BAM tag).

Failures are classified capacity first, then device, then task, at
every level: a capacity error (resources.is_capacity_error, a CUDA OOM
among them) is never bisected -- the group is handed to the caller's
capacity split -- and in the serial rescue it quarantines; a device
error (device.is_device_error: a kernel build, load or launch failure,
a sticky CUDA error) is re-raised, so a broken card or kernel cannot
turn into a run of Other tallies.

Events are registry counters under pbccs_tpu's names
(ccs_quarantined_zmws_total, ccs_degraded_zmws_total,
ccs_quarantine_bisect_dispatches_total) and two of the port's own
(ccs_quarantine_isolations_total, ccs_quarantine_serial_rescues_total);
event_counts() reads them over a window that reset_event_counts()
restarts."""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import numpy as np

from pbccs_tpu_torch.device import is_device_error
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.resilience.resources import (CapacityError,
                                                  is_capacity_error)
from pbccs_tpu_torch.runtime.logging import Logger

# QV ceiling for draft-only consensus: a POA draft is typically ~Q10-Q20
# accurate; capping at Q10 keeps downstream consumers from mistaking an
# unpolished read for a polished one
DRAFT_QV_CAP = 10

_reg = default_registry()
#: event_counts() key -> (metric name, help)
_EVENTS = {
    "isolations": ("ccs_quarantine_isolations_total",
                   "Failed batch dispatches handed to bisection"),
    "bisect_dispatches": (
        "ccs_quarantine_bisect_dispatches_total",
        "Extra sub-batch dispatches spent isolating poison ZMWs"),
    "serial_rescues": ("ccs_quarantine_serial_rescues_total",
                       "Serial-pipeline rescues of single ZMWs"),
    "quarantined": (
        "ccs_quarantined_zmws_total",
        "ZMWs isolated by bisection whose serial rescue also failed"),
    "degraded": ("ccs_degraded_zmws_total",
                 "Quarantined ZMWs emitted as draft-only consensus"),
}
_m = {k: _reg.counter(name, help) for k, (name, help) in _EVENTS.items()}
_window_lock = threading.Lock()
_window = _reg.scope()


def event_counts() -> dict[str, int]:
    """Quarantine events since the last reset: batch failures handed to
    isolation, bisection sub-dispatches, serial rescues, ZMWs
    quarantined, and those of them emitted draft-only."""
    with _window_lock:
        win = _window
    return {k: int(win.counter_value(name))
            for k, (name, _) in _EVENTS.items()}


def reset_event_counts() -> None:
    """Start a new event_counts() window (the counters stay monotone)."""
    global _window
    with _window_lock:
        _window = _reg.scope()


def degrade_to_draft(prep, settings):
    """Draft-only consensus for a quarantined ZMW: the POA draft sequence
    with capped QVs, marked draft_only (-> `df` tag at emission)."""
    from pbccs_tpu_torch.models.arrow.params import decode_bases
    from pbccs_tpu_torch.models.arrow.refine import predicted_accuracy
    from pbccs_tpu_torch.pipeline import ConsensusResult, Failure

    qvs = np.full(len(prep.css), DRAFT_QV_CAP, np.float64)
    n_passes = sum(1 for m in prep.mapped if m.is_full_pass)
    nan = float("nan")
    return Failure.SUCCESS, ConsensusResult(
        id=prep.chunk.id,
        sequence=decode_bases(prep.css),
        qvs=qvs,
        num_passes=n_passes,
        predicted_accuracy=predicted_accuracy(qvs),
        global_zscore=nan,
        avg_zscore=nan,
        zscores=np.full(len(prep.mapped), nan),
        status_counts=[0] * 5,
        mutations_tested=0,
        mutations_applied=0,
        snr=np.asarray(prep.chunk.snr),
        elapsed_ms=prep.prep_ms,
        draft_only=True)


def quarantine_outcome(prep, settings, exc: BaseException):
    """The terminal outcome for a ZMW whose batch AND serial polishes
    failed: draft-only degradation when enabled, else Failure.OTHER."""
    from pbccs_tpu_torch.obs import flight
    from pbccs_tpu_torch.pipeline import Failure

    _m["quarantined"].inc()
    log = Logger.default()
    # postmortem: what the refine loops were doing just before this ZMW
    # went terminal
    flight.dump("quarantine", log)
    if getattr(settings, "degrade_quarantined", False):
        try:
            outcome = degrade_to_draft(prep, settings)
        except Exception as e:  # noqa: BLE001 -- degradation must never
            # re-poison the batch; fall through to the Other tally
            log.warn(f"ZMW {prep.chunk.id}: draft degradation failed "
                     f"({e!r}); dropping as Other")
            return Failure.OTHER, None
        _m["degraded"].inc()
        log.warn(f"ZMW {prep.chunk.id}: quarantined ({type(exc).__name__}); "
                 f"emitting draft-only consensus (QV cap {DRAFT_QV_CAP})")
        return outcome
    log.warn(f"ZMW {prep.chunk.id}: quarantined ({type(exc).__name__}); "
             "dropped as Other")
    return Failure.OTHER, None


def serial_rescue(prep, settings, batch_exc: BaseException, *, device=None):
    """One isolated singleton through the serial per-ZMW polish
    (pipeline.polish_prepared on the already prepared ZMW), under the
    same ambient watchdog deadline as the batch dispatch -- a
    persistently hung poison ZMW must quarantine, not stall the run --
    and with the polish.dispatch fault site inside it (a poison ZMW is
    poison however it is polished).  Quarantined if it fails too; a
    capacity error quarantines as well (this was the ZMW's last chance
    to fit), a device error is re-raised.  Shared by the bisection below,
    the capacity split's singletons and the pipeline's on_error="serial"
    loop, so the fallback modes cannot drift."""
    from pbccs_tpu_torch import pipeline
    from pbccs_tpu_torch.resilience import faults
    from pbccs_tpu_torch.resilience.watchdog import run_with_deadline

    def polish_one():
        faults.maybe_fail("polish.dispatch", keys=[prep.chunk.id])
        return pipeline.polish_prepared(prep, settings, device=device)

    _m["serial_rescues"].inc()
    try:
        return run_with_deadline(polish_one, site="polish.serial")
    except Exception as e:  # noqa: BLE001 -- the quarantine boundary
        if not is_capacity_error(e) and is_device_error(e):
            raise
        pipeline.record_zmw_failure("polish.serial", e, zmw=prep.chunk.id)
        return quarantine_outcome(prep, settings, e)


def isolate(preps: Sequence, dispatch: Callable[[Sequence], list], settings,
            first_error: BaseException, *,
            on_capacity: Callable[[Sequence, CapacityError], list],
            device=None) -> list:
    """Bisect `preps` (whose full-batch dispatch already raised
    `first_error`) down to the poison ZMW(s).

    dispatch(sub_preps) returns outcomes aligned with its input and
    raises on failure; it should pin bucket shapes to the PARENT batch's.
    A singleton split off a failed group is dispatched too (pbccs_tpu
    sends it straight to the serial rescue), so every healthy ZMW comes
    out of a pinned batch polish, byte-identical to the unfailed run;
    only a singleton whose own dispatch fails goes to serial_rescue on
    `device`.  A group whose dispatch fails for capacity is not bisected
    further: on_capacity(group, note) returns its outcomes (the
    pipeline's capacity split), called after the failed dispatch's
    exception -- and the tensors its traceback holds -- is gone.
    Returns outcomes aligned with `preps`."""
    from pbccs_tpu_torch import pipeline

    _m["isolations"].inc()
    n = len(preps)
    out: list = [None] * n
    pipeline.record_zmw_failure("polish.batch", first_error,
                                zmw=f"batch[{n}]")
    if n == 1:
        out[0] = serial_rescue(preps[0], settings, first_error,
                               device=device)
        return out
    mid = n // 2
    groups: list[list[int]] = [list(range(mid, n)), list(range(mid))]
    while groups:
        grp = groups.pop()
        sub = [preps[i] for i in grp]
        _m["bisect_dispatches"].inc()
        note = None
        try:
            results = dispatch(sub)
        except Exception as e:  # noqa: BLE001 -- keep splitting
            if is_capacity_error(e):
                pipeline.record_zmw_failure("polish.capacity", e,
                                            zmw=f"batch[{len(grp)}]")
                note = CapacityError.of(e)
            elif is_device_error(e):
                raise
            else:
                pipeline.record_zmw_failure("polish.batch", e,
                                            zmw=f"batch[{len(grp)}]")
                if len(grp) == 1:
                    out[grp[0]] = serial_rescue(preps[grp[0]], settings, e,
                                                device=device)
                    continue
                m = len(grp) // 2
                groups.append(grp[m:])
                groups.append(grp[:m])
                continue
        if note is not None:
            results = on_capacity(sub, note)
        for i, r in zip(grp, results):
            out[i] = r
    bad = sum(1 for o in out if o is None)
    if bad:  # defensive: dispatch returned short -- fail those ZMWs loudly
        from pbccs_tpu_torch.pipeline import Failure

        Logger.default().error(
            f"quarantine bisection left {bad} ZMW(s) unresolved")
        out = [o if o is not None else (Failure.OTHER, None) for o in out]
    return out
