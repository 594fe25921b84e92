"""Per-chunk checkpoint journal for the offline CLI (`--resume`).

Port of pbccs_tpu.resilience.checkpoint with the same record schema,
field for field (ConsensusResult has the same fields in both packages,
so a record either package wrote loads in the other).  The run
fingerprint names the implementation: the two packages agree within 1
QV, not bitwise, so splicing one's chunks into the other's run would
break the byte identity `--resume` promises, and a journal pbccs_tpu
wrote is refused here (logged) and the run starts fresh.

An hour-long batch run killed at 95% used to restart from zero.  The
journal is an append-only NDJSON file beside the output:

    {"type":"header","version":1,"fingerprint":{...}}
    {"type":"chunk","index":0,"counts":{"Success":3,...},"results":[...]}
    {"type":"chunk","index":1,...}

One line per COMPLETED work item (a --chunkSize batch of ZMWs), written
in consumption order (= submission order, the WorkQueue contract) and
fsynced, so a `kill -9` loses at most the in-flight chunks.  On
`--resume` the CLI re-reads its inputs (recomputing the CLI-level gate
tallies, which are deterministic), restores completed chunks from the
journal, and produces only the rest -- the final tally and output are
byte-identical to an uninterrupted run.

Robustness of the journal itself:

  * a torn final line (killed mid-write) or a corrupted record fails its
    json/schema parse and is DROPPED -- that chunk is simply recomputed;
  * the header fingerprints the inputs (path, size) and consensus
    settings; a mismatch (different inputs/flags) refuses the resume and
    starts fresh rather than splicing incompatible results;
  * NaN float fields (z-scores) survive the round trip (Python's JSON
    emits and parses NaN);
  * a full disk (ENOSPC / short write) mid-append raises a structured
    resources.OutputWriteError with bytes-written accounting instead of
    an unhandled traceback; the journal keeps every complete record,
    start(resume=True) trims the torn tail before appending, and the
    rerun completes byte-identically once space is freed.

Metrics: ccs_checkpoint_records_total{kind=written|restored|corrupt}.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.runtime.logging import Logger

JOURNAL_VERSION = 1
#: what the fingerprint names as the writer of the journal's results
IMPLEMENTATION = "pbccs_tpu_torch"

_reg = default_registry()
_m_records = {kind: _reg.counter("ccs_checkpoint_records_total",
                                 "Checkpoint journal records by kind",
                                 kind=kind)
              for kind in ("written", "restored", "corrupt")}


# ----------------------------------------------------------- serialization

def result_to_json(r) -> dict[str, Any]:
    """ConsensusResult -> JSON-safe dict (exact round trip: the restored
    result emits the identical BAM record)."""
    return {
        "id": r.id,
        "sequence": r.sequence,
        "qvs": [float(q) for q in np.asarray(r.qvs)],
        "num_passes": int(r.num_passes),
        "predicted_accuracy": float(r.predicted_accuracy),
        "global_zscore": float(r.global_zscore),
        "avg_zscore": float(r.avg_zscore),
        "zscores": [float(z) for z in np.asarray(r.zscores)],
        "status_counts": [int(c) for c in r.status_counts],
        "mutations_tested": int(r.mutations_tested),
        "mutations_applied": int(r.mutations_applied),
        "snr": [float(s) for s in np.asarray(r.snr)],
        "elapsed_ms": float(r.elapsed_ms),
        "draft_only": bool(r.draft_only),
    }


def result_from_json(d: dict[str, Any]):
    from pbccs_tpu_torch.pipeline import ConsensusResult

    return ConsensusResult(
        id=d["id"],
        sequence=d["sequence"],
        qvs=np.asarray(d["qvs"], np.float64),
        num_passes=int(d["num_passes"]),
        predicted_accuracy=float(d["predicted_accuracy"]),
        global_zscore=float(d["global_zscore"]),
        avg_zscore=float(d["avg_zscore"]),
        zscores=np.asarray(d["zscores"], np.float64),
        status_counts=[int(c) for c in d["status_counts"]],
        mutations_tested=int(d["mutations_tested"]),
        mutations_applied=int(d["mutations_applied"]),
        snr=np.asarray(d["snr"], np.float64),
        elapsed_ms=float(d["elapsed_ms"]),
        draft_only=bool(d.get("draft_only", False)))


def tally_to_json(tally) -> dict[str, Any]:
    return {
        "counts": {f.value: c for f, c in tally.counts.items() if c},
        "results": [result_to_json(r) for r in tally.results],
    }


def tally_from_json(d: dict[str, Any]):
    from pbccs_tpu_torch.pipeline import Failure, ResultTally

    tally = ResultTally()
    for name, c in d.get("counts", {}).items():
        tally.counts[Failure(name)] += int(c)
    tally.results = [result_from_json(r) for r in d.get("results", [])]
    return tally


def run_fingerprint(files: list[str], chunk_size: int, settings,
                    extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """What must match for journaled chunks to be splicable into a rerun:
    the implementation, the inputs (path + size + mtime -- a regenerated
    same-size file must NOT splice stale results; chunk batching is a
    pure function of the bytes), the batch size, and every consensus
    knob.  Erring toward
    refusal is safe: a refused resume only recomputes."""
    import dataclasses

    def stat(f: str) -> list:
        try:
            st = os.stat(f)
            return [os.path.abspath(f), st.st_size, st.st_mtime_ns]
        except OSError:
            return [os.path.abspath(f), -1, -1]

    return {
        "version": JOURNAL_VERSION,
        "implementation": IMPLEMENTATION,
        "inputs": [stat(f) for f in files],
        "chunk_size": int(chunk_size),
        "settings": dataclasses.asdict(settings),
        **(extra or {}),
    }


# ----------------------------------------------------------------- journal

class CheckpointJournal:
    """Append-only per-chunk journal (one instance per CLI run)."""

    def __init__(self, path: str, logger: Logger | None = None):
        self.path = path
        self._log = logger or Logger.default()
        self._fh = None

    # ------------------------------------------------------------- restore

    def load(self, fingerprint: dict[str, Any]) -> dict[int, Any]:
        """Restore completed chunks: {index: ResultTally}.  Returns {} on
        a missing journal, a fingerprint mismatch (refused, logged), or
        an unreadable header; corrupt chunk records are dropped."""
        if not os.path.exists(self.path):
            self._log.info(f"resume: no journal at {self.path}; "
                           "starting fresh")
            return {}
        restored: dict[int, Any] = {}
        header_ok = False
        # binary + per-line decode: a corrupted byte must drop ITS record
        # (UnicodeDecodeError == corrupt), not abort the whole restore
        with open(self.path, "rb") as fh:
            for lineno, raw in enumerate(fh):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw.decode())
                    rtype = rec["type"]
                    if rtype == "header":
                        theirs = rec.get("fingerprint")
                        if isinstance(theirs, dict) and \
                                theirs.get("implementation") != \
                                fingerprint.get("implementation"):
                            self._log.warn(
                                "resume refused: the journal was written "
                                "by another implementation "
                                f"({theirs.get('implementation', 'pbccs_tpu')}"
                                "), whose results are not byte-identical "
                                "to this one's; recomputing everything")
                            return {}
                        if theirs != fingerprint:
                            self._log.warn(
                                "resume refused: journal fingerprint does "
                                "not match this run's inputs/settings; "
                                "recomputing everything")
                            return {}
                        header_ok = True
                    elif rtype == "chunk":
                        if not header_ok:
                            raise ValueError("chunk before header")
                        restored[int(rec["index"])] = \
                            tally_from_json(rec)
                    # unknown types: forward-compatible skip
                except (ValueError, KeyError, TypeError) as e:
                    _m_records["corrupt"].inc()
                    self._log.warn(
                        f"resume: dropping corrupt journal record at "
                        f"{self.path}:{lineno + 1} ({type(e).__name__}); "
                        "that chunk will be recomputed")
        for _ in restored:
            _m_records["restored"].inc()
        if restored:
            self._log.info(
                f"resume: restored {len(restored)} completed chunk(s) "
                f"from {self.path}")
        return restored

    # -------------------------------------------------------------- append

    def start(self, fingerprint: dict[str, Any], resume: bool) -> None:
        """Open for appending.  A fresh (non-resume) run truncates; a
        resume first TRIMS any torn final line (a kill -9 or ENOSPC
        mid-record leaves a partial line with no newline -- appending a
        new record after it would concatenate the two into one corrupt
        line and lose BOTH chunks), then appends new chunk records
        after the existing ones (the loader takes the last record per
        index, so re-journaling is harmless)."""
        mode = "ab" if (resume and os.path.exists(self.path)) else "wb"
        if mode == "ab":
            self._trim_torn_tail()
        self._fh = open(self.path, mode)
        if mode == "wb" or os.path.getsize(self.path) == 0:
            self._write_line({"type": "header",
                              "version": JOURNAL_VERSION,
                              "fingerprint": fingerprint})

    def _trim_torn_tail(self) -> None:
        """Truncate the journal back to its last complete line (the
        torn-tail-tolerant half of the resume contract: load() already
        DROPS the torn record; this makes the file safe to append to)."""
        try:
            with open(self.path, "rb+") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                if size == 0:
                    return
                fh.seek(size - 1)
                if fh.read(1) == b"\n":
                    return
                keep, pos = 0, size
                while pos > 0:
                    step = min(1 << 16, pos)
                    fh.seek(pos - step)
                    nl = fh.read(step).rfind(b"\n")
                    if nl >= 0:
                        keep = pos - step + nl + 1
                        break
                    pos -= step
                fh.truncate(keep)
            _m_records["corrupt"].inc()
            self._log.warn(
                f"resume: trimmed {size - keep} byte(s) of torn record "
                f"off the journal tail at {self.path}; that chunk will "
                "be recomputed")
        except OSError as e:
            # the append-mode open below will surface a real I/O problem
            self._log.warn(f"resume: could not trim journal tail: {e}")

    def record_chunk(self, index: int, tally) -> None:
        """Journal one completed chunk (fsynced: survives kill -9)."""
        if self._fh is None:
            return
        self._write_line({"type": "chunk", "index": int(index),
                          **tally_to_json(tally)})
        _m_records["written"].inc()

    def _write_line(self, rec: dict[str, Any]) -> None:
        from pbccs_tpu_torch.resilience import faults
        from pbccs_tpu_torch.resilience.resources import OutputWriteError

        data = (json.dumps(rec) + "\n").encode()
        data = faults.corrupt("checkpoint.record", data)
        try:
            pre = self._fh.tell()
        except (OSError, ValueError):
            pre = 0
        try:
            # enospc-kind injection fires here: the exact OSError a full
            # disk raises, exercising the structured-error + torn-tail
            # resume path end to end
            faults.maybe_fail("checkpoint.record",
                              keys=[str(rec.get("type", "")),
                                    str(rec.get("index", ""))])
            self._fh.write(data)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except OSError as e:
            # `pre` = bytes durably on disk BEFORE this record: the
            # prefix the torn-tail-tolerant loader can still use
            written = pre
            # drop the handle but KEEP the journal: every complete
            # record in it restores on the next --resume once space is
            # freed (the torn tail, if any, trims then).  The close is
            # guarded: a BufferedWriter.close() re-flushes its tail and
            # re-raises the same ENOSPC, which would replace THIS
            # structured error with a raw traceback.
            fh, self._fh = self._fh, None
            try:
                fh.close()
            except OSError:
                pass  # the buffered tail is already accounted lost
            raise OutputWriteError("checkpoint", self.path, written,
                                   e) from e

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def remove(self) -> None:
        """Delete the journal (a completed run needs no resume point)."""
        self.close()
        try:
            os.remove(self.path)
        except OSError:
            pass
