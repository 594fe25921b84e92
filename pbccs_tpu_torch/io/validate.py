"""The chunk contract the CLI reader enforces before a ZMW reaches the
pipeline: one validate_chunk() with structured machine-readable reasons.
A chunk that passes is safe to hand to pipeline.prepare_chunk -- no NaN
SNRs reaching device math, no pathological read counts/lengths, no
out-of-range accuracies skewing the read-score gate.

Copy of pbccs_tpu.io.validate with the same bounds and reasons, counted
under the ``ccs_input_invalid_records_total{reason}`` family the BAM
decoder uses (the caller logs the rejection).  Bounds are
deliberately generous (an order of magnitude past anything a real SMRT
cell produces) so they only ever reject hostile or corrupt input, never
legitimate workloads."""

from __future__ import annotations

import math

import numpy as np

from pbccs_tpu_torch.io.bam import count_invalid_record as _count

# generous physical bounds: real ZMWs top out around ~3k passes of ~50 kb
MAX_READS_PER_CHUNK = 8192
MAX_READ_LEN = 1 << 22          # 4 Mbase per subread
MAX_TOTAL_BASES = 1 << 26       # 64 Mbase per ZMW across all subreads


class ChunkValidationError(ValueError):
    """A chunk violates the input contract; ``reason`` is the
    machine-readable class."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


def _fail(reason: str, message: str) -> None:
    _count(reason)
    raise ChunkValidationError(reason, message)


def validate_chunk(chunk) -> None:
    """Raise ChunkValidationError (and count the rejection) unless
    `chunk` satisfies the input contract:

      * snr is 4 finite non-negative numbers (ACGT order);
      * 1..MAX_READS_PER_CHUNK reads, each 1..MAX_READ_LEN bases,
        MAX_TOTAL_BASES total;
      * every read_accuracy is a finite number in [0, 1].
    """
    try:
        snr = np.asarray(chunk.snr, dtype=np.float64)
    except (TypeError, ValueError):
        snr = None
    if snr is None or snr.shape != (4,):
        _fail("snr_shape", "snr must be 4 numbers (ACGT)")
    if not np.all(np.isfinite(snr)) or np.any(snr < 0):
        _fail("bad_snr", "snr values must be finite and non-negative")
    reads = chunk.reads
    if not reads:
        _fail("no_reads", "chunk has no reads")
    if len(reads) > MAX_READS_PER_CHUNK:
        _fail("reads_count",
              f"{len(reads)} reads exceeds the {MAX_READS_PER_CHUNK} bound")
    total = 0
    for i, read in enumerate(reads):
        n = len(read.seq)
        if n < 1 or n > MAX_READ_LEN:
            _fail("read_length",
                  f"reads[{i}] length {n} outside [1, {MAX_READ_LEN}]")
        total += n
        try:
            acc = float(read.read_accuracy)
        except (TypeError, ValueError):
            acc = float("nan")
        if not math.isfinite(acc) or not 0.0 <= acc <= 1.0:
            _fail("accuracy_range",
                  f"reads[{i}] accuracy {read.read_accuracy!r} "
                  "outside [0, 1]")
    if total > MAX_TOTAL_BASES:
        _fail("total_bases",
              f"{total} total bases exceeds the {MAX_TOTAL_BASES} bound")
