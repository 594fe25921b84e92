"""FASTA reading/writing and .fofn (file-of-filenames) flattening.

Parity: the reference loads subread fixtures via SeqAn FASTA
(tests/TestUtils.cpp:39-54) and flattens .fofn input lists recursively
(include/pacbio/ccs/Utility.h FlattenFofn, src/Utility.cpp:94-124).
Copy of pbccs_tpu.io.fasta.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator


def read_fasta(path: str) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) records; .gz files are decompressed."""
    name: str | None = None
    parts: list[str] = []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name = line[1:].split()[0]
                parts = []
            else:
                parts.append(line)
    if name is not None:
        yield name, "".join(parts)


def write_fasta(path: str, records, line_width: int = 70) -> None:
    # same publish discipline as the BAM/report writers: stream into a
    # same-dir temp file, fsync, rename -- a crash or ENOSPC mid-write
    # never leaves a torn FASTA under the output path, and the failure
    # surfaces as a structured OutputWriteError
    from pbccs_tpu_torch.io.bam import atomic_output

    with atomic_output(path, "fasta") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                f.write(seq[i:i + line_width] + "\n")


def flatten_fofn(paths: list[str]) -> list[str]:
    """Recursively expand .fofn files into the underlying file list."""
    out: list[str] = []
    for p in paths:
        if p.endswith(".fofn"):
            base = os.path.dirname(os.path.abspath(p))
            with open(p) as f:
                nested = []
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if not os.path.isabs(line):
                        line = os.path.join(base, line)
                    nested.append(line)
            out.extend(flatten_fofn(nested))
        else:
            out.append(p)
    return out
