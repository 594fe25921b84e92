"""End-of-run CSV yield report.

Parity: reference WriteResultsReport (src/main/ccs.cpp:233-262): one line
per yield category with count and percentage of total ZMWs.  Copy of
pbccs_tpu.io.report.
"""

from __future__ import annotations

from typing import TextIO

from pbccs_tpu_torch.pipeline import Failure, ResultTally

_LABELS: list[tuple[Failure, str]] = [
    (Failure.SUCCESS, "Success -- CCS generated"),
    (Failure.POOR_SNR, "Failed -- Below SNR threshold"),
    (Failure.NO_SUBREADS, "Failed -- No usable subreads"),
    (Failure.TOO_SHORT, "Failed -- Insert size too small"),
    (Failure.TOO_FEW_PASSES, "Failed -- Not enough full passes"),
    (Failure.TOO_MANY_UNUSABLE, "Failed -- Too many unusable subreads"),
    (Failure.NON_CONVERGENT, "Failed -- CCS did not converge"),
    (Failure.POOR_QUALITY, "Failed -- CCS below minimum predicted accuracy"),
    (Failure.OTHER, "Failed -- Exception thrown"),
]


def write_results_report(out: TextIO, tally: ResultTally) -> None:
    total = max(tally.total, 1)
    for failure, label in _LABELS:
        if failure == Failure.OTHER and tally.counts[failure] == 0:
            continue  # the reference has no Other line; only emit if nonzero
        count = tally.counts[failure]
        out.write(f"{label},{count},{100.0 * count / total:.2f}%\n")


def write_report_file(path: str, tally: ResultTally) -> None:
    """Disk-full-safe report write: the CSV lands through a same-dir
    temp file + rename (io.bam.atomic_output), so an ENOSPC mid-write
    surfaces as a structured OutputWriteError and never publishes a torn
    report."""
    from pbccs_tpu_torch.io.bam import atomic_output

    with atomic_output(path, "report") as out:
        write_results_report(out, tally)
