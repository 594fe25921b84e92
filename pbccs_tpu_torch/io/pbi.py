"""PacBio BAM index (.pbi) writer/reader.

Parity target: pbbam's PbiBuilder as used by the reference CLI
(reference src/main/ccs.cpp:52-54, 120: `PbiBuilder` aggregates one row per
record so SMRT tools can address ZMWs without scanning the BAM).  pbbam is
not vendored in the reference tree; this implements the published PacBio
BAM index format spec (BasicData section): a BGZF-compressed file

  magic "PBI\\x01" | version u32 | pbi_flags u16 | n_reads u32 | 18B reserved
  rgId i32[n] | qStart i32[n] | qEnd i32[n] | holeNumber i32[n]
  readQual f32[n] | ctxtFlag u8[n] | fileOffset u64[n]

fileOffset is the BGZF virtual offset (coffset << 16 | uoffset) of the
record in the companion BAM.  Copy of pbccs_tpu.io.pbi."""

from __future__ import annotations

import io
import struct

import numpy as np

from pbccs_tpu_torch.io.bam import BgzfReader, BgzfWriter, atomic_output

PBI_MAGIC = b"PBI\x01"
PBI_VERSION = 0x00000301          # format 3.0.1
FLAG_BASIC = 0x0000


def read_group_numeric_id(rg_id: str) -> int:
    """pbbam convention: the read-group id is the first 8 hex chars of the
    MD5-derived id string, interpreted as a signed int32."""
    return np.int32(int(rg_id[:8], 16) - (1 << 32 if int(rg_id[:8], 16) >= 1 << 31 else 0))


class PbiBuilder:
    """Accumulates one index row per BAM record; close() publishes the
    .pbi ATOMICALLY (tmp+fsync+rename via io.bam.atomic_output), the
    same durability contract as the companion BamWriter: an ENOSPC or
    crash mid-index never leaves a torn .pbi beside a valid BAM, and a
    filesystem failure surfaces as a structured OutputWriteError
    (sink="pbi")."""

    def __init__(self, path: str):
        self._path = path
        self.rg_ids: list[int] = []
        self.q_starts: list[int] = []
        self.q_ends: list[int] = []
        self.holes: list[int] = []
        self.read_quals: list[float] = []
        self.ctxt_flags: list[int] = []
        self.offsets: list[int] = []

    def add_record(self, rg_id: int, q_start: int, q_end: int, hole: int,
                   read_qual: float, ctxt_flag: int, file_offset: int) -> None:
        self.rg_ids.append(int(rg_id))
        self.q_starts.append(int(q_start))
        self.q_ends.append(int(q_end))
        self.holes.append(int(hole))
        self.read_quals.append(float(read_qual))
        self.ctxt_flags.append(int(ctxt_flag))
        self.offsets.append(int(file_offset))

    def close(self) -> None:
        n = len(self.holes)
        payload = io.BytesIO()
        payload.write(PBI_MAGIC)
        payload.write(struct.pack("<IHI", PBI_VERSION, FLAG_BASIC, n))
        payload.write(b"\x00" * 18)
        payload.write(np.asarray(self.rg_ids, "<i4").tobytes())
        payload.write(np.asarray(self.q_starts, "<i4").tobytes())
        payload.write(np.asarray(self.q_ends, "<i4").tobytes())
        payload.write(np.asarray(self.holes, "<i4").tobytes())
        payload.write(np.asarray(self.read_quals, "<f4").tobytes())
        payload.write(np.asarray(self.ctxt_flags, "u1").tobytes())
        payload.write(np.asarray(self.offsets, "<u8").tobytes())
        with atomic_output(self._path, "pbi", mode="wb") as fh:
            w = BgzfWriter(fh)
            w.write(payload.getvalue())
            w.close()

    def __enter__(self) -> "PbiBuilder":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        # publish only on clean exit: an exception mid-accumulation must
        # not atomically rename a PARTIAL index over a previous valid one
        if exc_type is None:
            self.close()


class PbiIndex:
    """Parsed .pbi; arrays indexed per record."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            raw = fh.read()
        from pbccs_tpu_torch import native
        data = native.bgzf_decompress(raw)
        if data is None:                     # no native lib: python path
            rd = BgzfReader(io.BytesIO(raw))
            data = b""
            while True:
                chunk = rd.read(1 << 20)
                if not chunk:
                    break
                data += chunk
        if data[:4] != PBI_MAGIC:
            raise ValueError("not a PBI file")
        self.version, self.flags, n = struct.unpack_from("<IHI", data, 4)
        off = 4 + 10 + 18
        take = lambda dt: (np.frombuffer(data, dt, n, off), off + n * np.dtype(dt).itemsize)
        self.rg_ids, off = take("<i4")
        self.q_starts, off = take("<i4")
        self.q_ends, off = take("<i4")
        self.holes, off = take("<i4")
        self.read_quals, off = take("<f4")
        self.ctxt_flags, off = take("u1")
        self.offsets, off = take("<u8")
        self.n_reads = n

    def rows_for_zmw(self, hole: int) -> np.ndarray:
        return np.flatnonzero(self.holes == hole)
