"""BAM IO: BGZF (de)compression + unaligned PacBio BAM records, pure host.

Copy of pbccs_tpu.io.bam for the port's CLI: the same registry
counters, the same ``output.write`` fault site, and the disk-full-safe
output of resilience.resources (OutputWriteError, atomic_output,
re-exported here).

The reference delegates BAM IO to pbbam/htslib (CMakeLists.txt:54-66,
src/main/ccs.cpp:52-54); this module provides the same capabilities
natively: BGZF block framing over zlib raw-deflate, BAM record
encode/decode, PacBio read-group conventions (movie//READTYPE derived
read-group ids), and the CCS output tags (src/main/ccs.cpp:105-172).

The writer/reader operate streamingly block-by-block so full SMRT cells
never materialize in memory; runs of whole blocks go through the native
BGZF codec (pbccs_tpu_torch.native) when it is built.

Decode policies (htslib-style record-level salvage, input hardening):

  * ``strict``  -- any structural corruption aborts the read with a
    BamDecodeError (the default everywhere).  Like the pre-hardening
    reader it refuses corrupt data, but truncation is now an EXPLICIT
    TruncatedBamError with a byte count where the old reader silently
    treated a torn final block as EOF.
  * ``lenient`` -- a bad RECORD (unknown tag type, seq/qual overrun,
    non-ACGT base, malformed `sn` tag, lying length field) is skipped and
    counted under ``ccs_input_invalid_records_total{reason}``; a corrupt
    BGZF BLOCK or a torn final block ends the stream early with the lost
    byte count recorded (``DecodeStats.bytes_lost``) instead of raising.
  * ``salvage`` -- lenient, plus resynchronization: after a corrupt BGZF
    block the reader scans the compressed stream for the next valid BGZF
    header magic (``ccs_input_salvaged_blocks_total``), and after a
    record-framing loss it scans the decompressed stream for the next
    plausible record header.  One flipped bit costs at most the ~64 KiB
    block it lives in, not the rest of the SMRT cell.

Every skip/resync/truncation is counted in the metrics registry AND in the
reader's ``DecodeStats`` so callers (the CLI) can report exact rejection
accounting.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
import zlib
from typing import BinaryIO, Iterator

from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.resilience.resources import (  # noqa: F401
    OutputWriteError,
    atomic_output,
)

_BGZF_HEADER = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00")
_BGZF_MAGIC = b"\x1f\x8b\x08\x04"  # fixed prefix of every BGZF member
_BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_MAX_BLOCK = 64 * 1024 - 512  # uncompressed payload per BGZF block

# 4-bit nucleotide encoding ("=ACMGRSVTWYHKDBN")
_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_NIBBLE_INV = "=ACMGRSVTWYHKDBN"

DECODE_POLICIES = ("strict", "lenient", "salvage")

# record-framing plausibility bounds (salvage/lenient validation)
_MIN_RECORD = 33            # 32-byte fixed header + 1-byte NUL name
_MAX_RECORD = 1 << 26       # 64 MiB: no sane unaligned record is bigger
_MAX_SEQ = 1 << 22          # 4 Mbase: far beyond any PacBio read
_MAX_HEADER_TEXT = 1 << 28
_MAX_RESYNC_SCAN = 1 << 26  # give up salvage after scanning 64 MiB

_reg = default_registry()
_m_salvaged = _reg.counter(
    "ccs_input_salvaged_blocks_total",
    "BGZF resyncs: corrupt blocks skipped to the next valid header magic")
_m_bytes_lost = _reg.counter(
    "ccs_input_bytes_lost_total",
    "Input bytes dropped by lenient/salvage decode (corruption+truncation)")


def count_invalid_record(reason: str) -> None:
    """Increment the shared rejection counter (also used by
    io.validate, so chunk and record rejections feed one metric
    family)."""
    _reg.counter("ccs_input_invalid_records_total",
                 "Input records/blocks rejected by the decode policy",
                 reason=reason).inc()


class BamDecodeError(ValueError):
    """Structural corruption in a BAM/BGZF stream.

    ``reason`` is the machine-readable rejection class, the key counted
    in ``DecodeStats.invalid_records``."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class TruncatedBamError(BamDecodeError):
    """The stream ends mid-block/mid-record (torn download, partial
    write).  ``bytes_lost`` reports how many trailing bytes could not be
    decoded, so a checkpoint/resume caller can report exactly what a
    retry must re-fetch."""

    def __init__(self, message: str, bytes_lost: int):
        super().__init__("truncated_block", message)
        self.bytes_lost = bytes_lost


@dataclasses.dataclass
class DecodeStats:
    """Per-reader rejection accounting (mirrors the registry counters).

    ``bytes_lost`` is an APPROXIMATE loss indicator: depending on which
    layer detected the damage it counts compressed input bytes (BGZF
    block errors, truncation) or decompressed payload bytes (record
    framing losses, resync scans).  Treat it as "roughly how much input
    did not decode", not an exact re-fetch size."""

    invalid_records: dict[str, int] = dataclasses.field(default_factory=dict)
    salvaged_blocks: int = 0
    bytes_lost: int = 0
    truncated: bool = False

    def count(self, reason: str) -> None:
        self.invalid_records[reason] = self.invalid_records.get(reason, 0) + 1
        count_invalid_record(reason)

    def lose(self, nbytes: int) -> None:
        if nbytes > 0:
            self.bytes_lost += nbytes
            _m_bytes_lost.inc(nbytes)

    @property
    def total_invalid(self) -> int:
        return sum(self.invalid_records.values())


class BgzfWriter:
    def __init__(self, fh: BinaryIO):
        self._fh = fh
        self._buf = bytearray()
        self._upos = 0            # total uncompressed bytes accepted
        self._cpos = 0            # total compressed bytes emitted
        self._block_comp_starts: list[int] = []  # comp offset of each block

    def utell(self) -> int:
        """Total uncompressed bytes written so far (all blocks are exactly
        _MAX_BLOCK payload except the final one, so an uncompressed offset
        resolves to a BGZF virtual offset after close via voffset())."""
        return self._upos

    def voffset(self, upos: int) -> int:
        """BGZF virtual file offset (coffset << 16 | uoffset) of the
        uncompressed position `upos`; valid after the block containing it
        is flushed (always true after close())."""
        blk = upos // _MAX_BLOCK
        if blk >= len(self._block_comp_starts):
            raise ValueError(
                f"uncompressed offset {upos} is in a block that has not been "
                "flushed yet; resolve virtual offsets after close()")
        return (self._block_comp_starts[blk] << 16) | (upos - blk * _MAX_BLOCK)

    def write(self, data: bytes) -> None:
        self._upos += len(data)
        self._buf += data
        if len(self._buf) >= 4 * _MAX_BLOCK:
            # batch path: the native codec compresses whole-block runs
            # across threads (native/pbccs_native.cpp)
            from pbccs_tpu_torch import native
            nblocks = len(self._buf) // _MAX_BLOCK
            chunk = bytes(self._buf[: nblocks * _MAX_BLOCK])
            packed = native.bgzf_compress(chunk)
            if packed is not None:
                # walk the packed blocks to record their compressed starts
                off = 0
                while off < len(packed):
                    self._block_comp_starts.append(self._cpos + off)
                    bsize = packed[off + 16] | (packed[off + 17] << 8)
                    off += bsize + 1
                self._fh.write(packed)
                self._cpos += len(packed)
                del self._buf[: nblocks * _MAX_BLOCK]
                return
        while len(self._buf) >= _MAX_BLOCK:
            self._flush_block(self._buf[:_MAX_BLOCK])
            del self._buf[:_MAX_BLOCK]

    def _flush_block(self, chunk: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(bytes(chunk)) + co.flush()
        bsize = len(comp) + len(_BGZF_HEADER) + 2 + 8  # +BSIZE +CRC/ISIZE
        self._block_comp_starts.append(self._cpos)
        self._cpos += bsize
        self._fh.write(_BGZF_HEADER)
        self._fh.write(struct.pack("<H", bsize - 1))
        self._fh.write(comp)
        self._fh.write(struct.pack("<I", zlib.crc32(bytes(chunk)) & 0xFFFFFFFF))
        self._fh.write(struct.pack("<I", len(chunk) & 0xFFFFFFFF))

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(_BGZF_EOF)
        self._fh.flush()


class BgzfReader:
    """Streaming BGZF reader: decodes one block at a time.

    ``policy`` selects corruption behavior (module docstring); ``stats``
    lets a BamReader share one DecodeStats across both layers.  A
    salvage resync is a HARD BOUNDARY in the decompressed stream:
    ``lost_sync`` flips True, reads stop short once the pre-corruption
    buffer drains (never splicing pre- and post-resync bytes into one
    record), and the post-resync payload stays staged until the record
    layer acknowledges via ``cross_boundary()`` and rescans framing."""

    def __init__(self, fh: BinaryIO, policy: str = "strict",
                 stats: DecodeStats | None = None):
        if policy not in DECODE_POLICIES:
            raise ValueError(f"unknown decode policy {policy!r}")
        self._fh = fh
        self._buf = bytearray()
        self._pending = bytearray()  # compressed bytes pushed back by resync
        self._staged = b""           # first decompressed payload PAST a resync
        self._eof = False
        self._policy = policy
        self.stats = stats if stats is not None else DecodeStats()
        self.lost_sync = False
        self._resyncing = False
        self._saw_eof_marker = False

    # -------------------------------------------------------- raw access

    def _raw_read(self, n: int) -> bytes:
        if not self._pending:
            return self._fh.read(n)
        out = bytearray(self._pending[:n])
        del self._pending[:n]
        if len(out) < n:
            out += self._fh.read(n - len(out))
        return bytes(out)

    # ---------------------------------------------------------- decoding

    def _fill(self) -> bool:
        """Append one block's payload to the buffer; False at stream end."""
        while True:
            head = self._raw_read(12)
            if not head:
                # clean end of the compressed stream; a missing EOF-marker
                # block is suspicious (htslib warns) but not data loss we
                # can quantify, so it is counted, not raised
                if not self._saw_eof_marker and not self._eof:
                    self.stats.count("missing_eof_marker")
                self._eof = True
                return False
            if len(head) < 12:
                return self._torn(head, "torn BGZF block header at EOF")
            consumed = bytearray(head)
            if head[:4] != _BGZF_MAGIC:
                if not self._handle_block_error(
                        consumed, "bgzf_block", "not a BGZF/gzip stream"):
                    return False
                continue
            xlen = struct.unpack_from("<H", head, 10)[0]
            extra = self._raw_read(xlen)
            consumed += extra
            if len(extra) < xlen:
                return self._torn(consumed, "torn BGZF extra field at EOF")
            bsize = None
            off = 0
            while off + 4 <= len(extra):
                si1, si2, slen = extra[off], extra[off + 1], struct.unpack(
                    "<H", extra[off + 2: off + 4])[0]
                if (si1, si2) == (66, 67) and slen == 2:
                    bsize = struct.unpack("<H", extra[off + 4: off + 6])[0] + 1
                off += 4 + slen
            if bsize is None or bsize < 12 + xlen + 8:
                if not self._handle_block_error(
                        consumed, "bgzf_block",
                        "missing BGZF BC subfield (plain gzip?)"):
                    return False
                continue
            comp_len = bsize - 12 - xlen - 8
            comp = self._raw_read(comp_len)
            consumed += comp
            if len(comp) < comp_len:
                return self._torn(consumed, "torn BGZF block payload at EOF")
            tail = self._raw_read(8)
            consumed += tail
            if len(tail) < 8:
                return self._torn(consumed, "torn BGZF block trailer at EOF")
            crc, isize = struct.unpack("<II", tail)
            if isize > 1 << 16:
                if not self._handle_block_error(
                        consumed, "bgzf_block",
                        f"BGZF ISIZE {isize} exceeds the 64 KiB block bound"):
                    return False
                continue
            try:
                data = zlib.decompress(comp, -15)
            except zlib.error as e:
                if not self._handle_block_error(
                        consumed, "bgzf_block", f"corrupt BGZF block: {e}"):
                    return False
                continue
            if len(data) != isize or (zlib.crc32(data) & 0xFFFFFFFF) != crc:
                if not self._handle_block_error(
                        consumed, "bgzf_block", "corrupt BGZF block"):
                    return False
                continue
            if not data:  # EOF marker block (or a benign empty block)
                self._saw_eof_marker = True
                continue
            if self._resyncing:
                # first block that validates after a resync scan: the
                # stream is back in sync, one salvage event complete.
                # Its payload is NOT continuous with what is buffered, so
                # it stays staged behind the boundary until the record
                # layer crosses it -- appending here would let an
                # in-progress read() splice pre- and post-resync bytes
                # into one silently-corrupt record.
                self._resyncing = False
                self.stats.salvaged_blocks += 1
                _m_salvaged.inc()
                self.lost_sync = True
                self._staged = bytes(data)
                return False
            self._buf += data
            return True

    def _torn(self, consumed: bytes, message: str) -> bool:
        """A block cut short by EOF: the canonical torn-download case."""
        lost = len(consumed)
        self.stats.truncated = True
        if self._policy == "strict":
            raise TruncatedBamError(
                f"{message} ({lost} trailing compressed byte(s) lost)", lost)
        self.stats.count("truncated_block")
        self.stats.lose(lost)
        self._eof = True
        return False

    def _handle_block_error(self, consumed: bytearray, reason: str,
                            message: str) -> bool:
        """Corrupt (but complete) block.  strict raises; lenient abandons
        the stream; salvage rescans for the next header magic.  Returns
        True when _fill should try again (salvage found a candidate)."""
        if self._policy == "strict":
            raise BamDecodeError(reason, message)
        if not self._resyncing:
            # count one corrupt-block event per lost-sync episode (a
            # resync retry that fails again is the same episode)
            self.stats.count(reason)
        if self._policy == "lenient":
            self.stats.lose(len(consumed) + self._drain_remaining())
            self._eof = True
            return False
        # salvage: rescan everything but the first consumed byte
        self._resyncing = True
        self.stats.lose(1)
        self._pending[:0] = consumed[1:]
        scanned = 0
        while True:
            idx = self._pending.find(_BGZF_MAGIC)
            if idx >= 0:
                self.stats.lose(idx)
                del self._pending[:idx]
                return True
            # keep a 3-byte tail: the magic may straddle the read boundary
            keep = min(len(self._pending), 3)
            drop = len(self._pending) - keep
            self.stats.lose(drop)
            del self._pending[:drop]
            scanned += drop
            if scanned > _MAX_RESYNC_SCAN:
                self.stats.lose(keep + self._drain_remaining())
                self._pending.clear()
                self._eof = True
                return False
            chunk = self._fh.read(1 << 16)
            if not chunk:
                self.stats.lose(keep)
                self._pending.clear()
                self._eof = True
                return False
            self._pending += chunk

    def _drain_remaining(self) -> int:
        """Count (without decoding) the rest of the compressed stream;
        a seekable file is measured with fstat instead of read to EOF."""
        n = len(self._pending)
        self._pending.clear()
        try:
            pos = self._fh.tell()
            end = os.fstat(self._fh.fileno()).st_size
            self._fh.seek(end)
            return n + max(0, end - pos)
        except (OSError, ValueError, AttributeError):
            pass  # pipe/BytesIO: fall back to reading it out
        while True:
            chunk = self._fh.read(1 << 20)
            if not chunk:
                return n
            n += len(chunk)

    # ----------------------------------------------------------- reading

    def read(self, n: int) -> bytes:
        # a read never crosses a salvage-resync boundary: once the
        # pre-corruption buffer drains it returns short and the caller
        # must cross_boundary() + rescan framing
        while len(self._buf) < n and not self._eof and not self.lost_sync:
            self._fill()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def peek(self, n: int) -> bytes:
        """Up to n bytes without consuming them (short only at EOF or a
        resync boundary)."""
        while len(self._buf) < n and not self._eof and not self.lost_sync:
            self._fill()
        return bytes(self._buf[:n])

    def skip(self, n: int) -> int:
        """Discard up to n decompressed bytes; returns the count dropped."""
        while len(self._buf) < n and not self._eof and not self.lost_sync:
            self._fill()
        dropped = min(n, len(self._buf))
        del self._buf[:dropped]
        return dropped

    def push_back(self, data: bytes) -> None:
        """Prepend already-read decompressed bytes (record-layer resync)."""
        self._buf[:0] = data

    def cross_boundary(self) -> None:
        """Acknowledge a salvage resync: promote the staged post-resync
        payload into the read buffer.  Only the record layer may call
        this, after discarding its in-progress framing."""
        self.lost_sync = False
        self._buf += self._staged
        self._staged = b""

    def abandon(self) -> int:
        """Stop decoding this stream: drop everything buffered and count
        the remaining input (buffered + staged + compressed remainder)
        as lost.  Returns the byte count."""
        n = len(self._buf) + len(self._staged)
        self._buf.clear()
        self._staged = b""
        self.lost_sync = False
        n += self._drain_remaining()
        self._eof = True
        return n


def make_read_group_id(movie_name: str, read_type: str) -> str:
    """8-hex-digit read-group id from movie//READTYPE (PacBio convention
    used by MakeReadGroupId, src/main/ccs.cpp:134)."""
    return hashlib.md5(f"{movie_name}//{read_type}".encode()).hexdigest()[:8]


@dataclasses.dataclass
class ReadGroupInfo:
    """One @RG header line (PacBio conventions: PU = movie name, DS holds
    READTYPE/kits/basecaller-version key-values)."""

    movie_name: str
    read_type: str = "SUBREAD"
    binding_kit: str = ""
    sequencing_kit: str = ""
    basecaller_version: str = ""
    frame_rate_hz: str = ""

    @property
    def id(self) -> str:
        return make_read_group_id(self.movie_name, self.read_type)

    def to_sam(self) -> str:
        ds = [f"READTYPE={self.read_type}"]
        if self.binding_kit:
            ds.append(f"BINDINGKIT={self.binding_kit}")
        if self.sequencing_kit:
            ds.append(f"SEQUENCINGKIT={self.sequencing_kit}")
        if self.basecaller_version:
            ds.append(f"BASECALLERVERSION={self.basecaller_version}")
        if self.frame_rate_hz:
            ds.append(f"FRAMERATEHZ={self.frame_rate_hz}")
        return (f"@RG\tID:{self.id}\tPL:PACBIO\tDS:{';'.join(ds)}"
                f"\tPU:{self.movie_name}")

    @staticmethod
    def from_sam(line: str) -> "ReadGroupInfo":
        fields = dict(f.split(":", 1) for f in line.strip().split("\t")[1:]
                      if ":" in f)
        ds = dict(kv.split("=", 1) for kv in fields.get("DS", "").split(";")
                  if "=" in kv)
        return ReadGroupInfo(
            movie_name=fields.get("PU", ""),
            read_type=ds.get("READTYPE", ""),
            binding_kit=ds.get("BINDINGKIT", ""),
            sequencing_kit=ds.get("SEQUENCINGKIT", ""),
            basecaller_version=ds.get("BASECALLERVERSION", ""),
            frame_rate_hz=ds.get("FRAMERATEHZ", ""))


@dataclasses.dataclass
class BamHeader:
    read_groups: list[ReadGroupInfo] = dataclasses.field(default_factory=list)
    program_lines: list[str] = dataclasses.field(default_factory=list)
    version: str = "1.5"
    pacbio_version: str = "3.0b7"
    sort_order: str = "unknown"

    def to_text(self) -> str:
        lines = [f"@HD\tVN:{self.version}\tSO:{self.sort_order}"
                 f"\tpb:{self.pacbio_version}"]
        lines += [rg.to_sam() for rg in self.read_groups]
        lines += self.program_lines
        return "\n".join(lines) + "\n"

    @staticmethod
    def from_text(text: str) -> "BamHeader":
        header = BamHeader()
        for line in text.splitlines():
            if line.startswith("@RG"):
                header.read_groups.append(ReadGroupInfo.from_sam(line))
            elif line.startswith("@PG"):
                header.program_lines.append(line)
        return header


@dataclasses.dataclass
class BamRecord:
    """An unaligned BAM record: name + seq + quals + tag dict.

    Tag values: int, float, str, bytes (H), or list[int]/list[float]
    (B arrays)."""

    name: str
    seq: str
    qual: str = ""  # phred+33 ASCII, "" = absent (0xFF fill)
    tags: dict = dataclasses.field(default_factory=dict)
    flag: int = 4  # unmapped


def _encode_tags(tags: dict) -> bytes:
    out = bytearray()
    for key, val in tags.items():
        kb = key.encode()
        if isinstance(val, bool):
            raise TypeError("bool tag unsupported")
        if isinstance(val, int):
            out += kb + b"i" + struct.pack("<i", val)
        elif isinstance(val, float):
            out += kb + b"f" + struct.pack("<f", val)
        elif isinstance(val, str):
            out += kb + b"Z" + val.encode() + b"\x00"
        elif isinstance(val, (list, tuple)):
            if all(isinstance(v, int) for v in val):
                out += kb + b"B" + b"i" + struct.pack("<I", len(val))
                out += struct.pack(f"<{len(val)}i", *val)
            else:
                out += kb + b"B" + b"f" + struct.pack("<I", len(val))
                out += struct.pack(f"<{len(val)}f", *[float(v) for v in val])
        else:
            raise TypeError(f"unsupported tag type for {key}: {type(val)}")
    return bytes(out)


_TAG_SCALARS = {"A": ("c", 1), "c": ("b", 1), "C": ("B", 1), "s": ("h", 2),
                "S": ("H", 2), "i": ("i", 4), "I": ("I", 4), "f": ("f", 4)}


def _decode_tags(data: bytes) -> dict:
    tags = {}
    off = 0
    while off + 3 <= len(data):
        key = data[off: off + 2].decode("ascii")
        typ = chr(data[off + 2])
        off += 3
        if typ in _TAG_SCALARS:
            fmt, size = _TAG_SCALARS[typ]
            val = struct.unpack_from("<" + fmt, data, off)[0]
            if typ == "A":
                val = val.decode()
            off += size
        elif typ in ("Z", "H"):
            end = data.index(b"\x00", off)
            val = data[off:end].decode()
            off = end + 1
        elif typ == "B":
            sub = chr(data[off])
            if sub not in _TAG_SCALARS:
                raise BamDecodeError(
                    "tag_type", f"unknown B-array subtype {sub!r}")
            n = struct.unpack_from("<I", data, off + 1)[0]
            fmt, size = _TAG_SCALARS[sub]
            if off + 5 + n * size > len(data):
                raise BamDecodeError(
                    "tag_overflow", f"B-array of {n} overruns the record")
            val = list(struct.unpack_from(f"<{n}{fmt}", data, off + 5))
            off += 5 + n * size
        else:
            raise BamDecodeError("tag_type", f"unknown tag type {typ!r}")
        tags[key] = val
    return tags


def encode_record(rec: BamRecord) -> bytes:
    """One serialized record: <i block_size> + body (shared by BamWriter
    and the fuzz harness, which mutates encoded records pre-compression)."""
    name = rec.name.encode() + b"\x00"
    seq = rec.seq.upper()
    l_seq = len(seq)
    packed = bytearray()
    for i in range(0, l_seq - 1, 2):
        packed.append((_NIBBLE.get(seq[i], 15) << 4)
                      | _NIBBLE.get(seq[i + 1], 15))
    if l_seq % 2:
        packed.append(_NIBBLE.get(seq[-1], 15) << 4)
    if rec.qual:
        qual = bytes(ord(c) - 33 for c in rec.qual)
    else:
        qual = b"\xff" * l_seq
    tags = _encode_tags(rec.tags)
    body = struct.pack("<iiBBHHHiiii", -1, -1, len(name), 255, 0, 0,
                       rec.flag, l_seq, -1, -1, 0)
    body += name + bytes(packed) + qual + tags
    return struct.pack("<i", len(body)) + body


def _decode_record(body: bytes, policy: str) -> BamRecord:
    """Decode one record body; raises BamDecodeError with a structured
    reason on corruption.  Content checks beyond structure (non-ACGT
    bases, malformed `sn`) apply only under lenient/salvage -- strict
    preserves the historical pass-through for interop inputs."""
    if len(body) < 32:
        raise BamDecodeError("overflow", "record body shorter than the "
                             "32-byte fixed section")
    (_refid, _pos, l_name, _mapq, _bin, n_cigar, flag, l_seq,
     _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", body)
    if l_name < 1:
        raise BamDecodeError("name", "l_read_name is zero")
    if l_seq < 0 or l_seq > _MAX_SEQ:
        raise BamDecodeError("seq_qual", f"l_seq {l_seq} out of bounds")
    off = 32
    name_end = off + l_name
    nseq = (l_seq + 1) // 2
    if name_end + 4 * n_cigar + nseq + l_seq > len(body):
        raise BamDecodeError(
            "seq_qual", "name/cigar/seq/qual overrun the record body "
            "(lying length field)")
    try:
        name = body[off: name_end - 1].decode("ascii")
    except UnicodeDecodeError:
        raise BamDecodeError("name", "read name is not ASCII") from None
    if policy != "strict" and body[name_end - 1] != 0:
        raise BamDecodeError("name", "read name is not NUL-terminated")
    off = name_end + 4 * n_cigar
    seq_bytes = body[off: off + nseq]
    off += nseq
    seq = "".join(
        _NIBBLE_INV[(seq_bytes[i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF]
        for i in range(l_seq))
    qual_raw = body[off: off + l_seq]
    off += l_seq
    qual = ("" if not qual_raw or qual_raw[0] == 0xFF
            else "".join(chr(q + 33) for q in qual_raw))
    try:
        tags = _decode_tags(body[off:])
    except BamDecodeError:
        raise
    except (struct.error, IndexError):
        raise BamDecodeError(
            "tag_overflow", "tag data overruns the record body") from None
    except ValueError:  # bytes.index: unterminated Z/H string
        raise BamDecodeError(
            "tag_overflow", "unterminated Z/H tag string") from None
    except UnicodeDecodeError:
        raise BamDecodeError(
            "tag_string", "tag string is not decodable text") from None
    if policy != "strict":
        bad = set(seq) - set("ACGT")
        if bad:
            raise BamDecodeError(
                "non_acgt", f"sequence contains non-ACGT base(s) "
                f"{sorted(bad)}")
        sn = tags.get("sn")
        if sn is not None and not (
                isinstance(sn, list) and len(sn) == 4
                and all(isinstance(s, (int, float))
                        and s == s and abs(s) != float("inf") and s >= 0
                        for s in sn)):
            raise BamDecodeError(
                "bad_snr", "sn tag is not 4 finite non-negative numbers")
    return BamRecord(name=name, seq=seq, qual=qual, tags=tags, flag=flag)


class BamWriter:
    """Unaligned BAM writer (no reference sequences).

    Disk-full safe (resilience.resources): records stream to
    ``path + ".tmp"`` and the finished file renames into place at
    close(), so a crash or ENOSPC mid-run never publishes a torn BAM
    under the output path.  A failed filesystem write (short write,
    ENOSPC, quota) raises a structured ``OutputWriteError`` with
    bytes-written accounting and removes the temp file; re-running the
    emission (e.g. ``--resume`` after freeing space) produces a
    byte-identical file.  The ``output.write`` fault site (keys:
    ``bam``, path) lets chaos runs inject the failure deterministically.
    """

    def __init__(self, path: str, header: BamHeader):
        self.path = path
        self._tmp = path + ".tmp"
        self._finalized = False
        try:
            self._fh = open(self._tmp, "wb")
        except OSError as e:
            raise OutputWriteError("bam", path, 0, e) from e
        self._bgzf = BgzfWriter(self._fh)
        text = header.to_text().encode()
        self._guard(lambda: self._bgzf.write(
            b"BAM\x01" + struct.pack("<i", len(text)) + text
            + struct.pack("<i", 0)))

    def _guard(self, fn):
        """Run one write step under the fault site; an OSError discards
        the temp file and surfaces as a structured OutputWriteError
        carrying the compressed bytes the sink durably accepted."""
        from pbccs_tpu_torch.resilience import faults

        try:
            faults.maybe_fail("output.write", keys=["bam", self.path])
            return fn()
        except OSError as e:
            written = self._bgzf._cpos
            self.discard()
            raise OutputWriteError("bam", self.path, written, e) from e

    def write(self, rec: BamRecord) -> int:
        """Write one record; returns its uncompressed stream offset (resolve
        to a .pbi virtual file offset with `voffset()` after close)."""
        upos = self._bgzf.utell()
        self._guard(lambda: self._bgzf.write(encode_record(rec)))
        return upos

    def voffset(self, upos: int) -> int:
        return self._bgzf.voffset(upos)

    def close(self) -> None:
        """Finalize: flush + fsync the temp file, then atomically rename
        it under the output path (the publish step; a reader never sees
        a torn BAM)."""
        if self._finalized:
            return

        def finish():
            self._bgzf.close()
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            os.replace(self._tmp, self.path)

        self._guard(finish)
        self._finalized = True

    def discard(self) -> None:
        """Abandon the output without publishing (error-path teardown):
        closes and removes the temp file, leaving any previous file at
        the output path untouched."""
        if self._finalized:
            return
        self._finalized = True
        try:
            self._fh.close()
        except OSError:
            pass  # already failing; nothing actionable from a close error
        try:
            os.remove(self._tmp)
        except OSError:
            pass  # best-effort cleanup; the .tmp suffix marks it torn

    def __enter__(self) -> "BamWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        # an exception in the `with` body means the record stream is
        # incomplete: discard the temp file rather than publishing a
        # short (but well-formed-looking) BAM under the output path
        if exc_type is not None:
            self.discard()
        else:
            self.close()


def _scan_candidates(buf: bytes, limit: int):
    """Offsets in [0, limit) whose little-endian int32 is a plausible
    block_size -- a vectorized prefilter so the per-byte Python
    plausibility check only runs on the ~1% of offsets that can
    possibly start a record (a 64 KiB garbage window would otherwise
    cost 64k struct.unpack_from calls per lost-sync episode)."""
    import numpy as np

    if len(buf) < 4:
        return ()
    b = np.frombuffer(buf, dtype=np.uint8).astype(np.uint32)
    v = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16)
         | (b[3:] << 24)).astype(np.int64)
    v = np.where(v > 0x7FFFFFFF, v - (1 << 32), v)  # signed int32
    mask = (v[:limit] >= _MIN_RECORD) & (v[:limit] <= _MAX_RECORD)
    return np.nonzero(mask)[0].tolist()


def _plausible_record(buf: bytes, off: int) -> bool:
    """Heuristic: does a believable unaligned-record header start at
    `off`?  Used by salvage resync -- every check must hold for a true
    record, and the conjunction is strong enough that random bytes
    essentially never pass (block_size bounds + field ranges + internal
    length consistency + NUL-terminated printable name)."""
    if off + 4 + 32 > len(buf):
        return False
    block_size = struct.unpack_from("<i", buf, off)[0]
    if not _MIN_RECORD <= block_size <= _MAX_RECORD:
        return False
    (refid, pos, l_name, _mapq, _bin, n_cigar, _flag, l_seq,
     nref, npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, off + 4)
    if l_name < 1 or l_seq < 0 or l_seq > _MAX_SEQ:
        return False
    if refid < -1 or nref < -1 or pos < -1 or npos < -1:
        return False
    if 32 + l_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq > block_size:
        return False
    name_start = off + 4 + 32
    name_end = name_start + l_name
    if name_end > len(buf):
        return False
    if buf[name_end - 1] != 0:
        return False
    return all(33 <= c <= 126 for c in buf[name_start: name_end - 1])


class BamReader:
    """Iterate records of a BAM file (unaligned or aligned; alignments are
    exposed as plain records, cigars ignored).

    ``policy`` is one of strict|lenient|salvage (module docstring).
    ``stats`` exposes the rejection accounting after (or during)
    iteration."""

    _SCAN_WINDOW = 1 << 16

    def __init__(self, path: str, policy: str = "strict"):
        if policy not in DECODE_POLICIES:
            raise ValueError(f"unknown decode policy {policy!r}")
        self.policy = policy
        self.stats = DecodeStats()
        self._fh = open(path, "rb")
        self._bgzf = BgzfReader(self._fh, policy=policy, stats=self.stats)
        self.header = BamHeader()
        self._header_ok = self._read_header(path)

    def _read_header(self, path: str) -> bool:
        try:
            magic = self._bgzf.read(4)
            if magic != b"BAM\x01":
                raise BamDecodeError("header", f"{path}: not a BAM file")
            raw = self._bgzf.read(4)
            if len(raw) < 4:
                raise BamDecodeError("header", f"{path}: truncated header")
            l_text = struct.unpack("<i", raw)[0]
            if not 0 <= l_text <= _MAX_HEADER_TEXT:
                raise BamDecodeError(
                    "header", f"{path}: absurd header length {l_text}")
            text = self._bgzf.read(l_text)
            if len(text) < l_text:
                raise BamDecodeError("header", f"{path}: truncated header "
                                     "text")
            try:
                self.header = BamHeader.from_text(text.decode())
            except UnicodeDecodeError:
                raise BamDecodeError(
                    "header", f"{path}: header text is not UTF-8") from None
            raw = self._bgzf.read(4)
            if len(raw) < 4:
                raise BamDecodeError("header", f"{path}: truncated "
                                     "reference list")
            n_ref = struct.unpack("<i", raw)[0]
            if not 0 <= n_ref <= 1 << 24:
                raise BamDecodeError(
                    "header", f"{path}: absurd reference count {n_ref}")
            for _ in range(n_ref):
                raw = self._bgzf.read(4)
                if len(raw) < 4:
                    raise BamDecodeError(
                        "header", f"{path}: truncated reference list")
                l_name = struct.unpack("<i", raw)[0]
                if not 0 <= l_name <= 1 << 16:
                    raise BamDecodeError(
                        "header", f"{path}: absurd reference name length")
                self._bgzf.read(l_name + 4)
            return True
        except BamDecodeError as e:
            if self.policy == "strict":
                raise
            self.stats.count(e.reason if e.reason != "truncated_block"
                             else "header")
            # lenient: a file without a decodable header yields nothing,
            # and the whole input counts as lost (same accounting as the
            # record-layer abandon paths); salvage: keep the stream and
            # scan for the first plausible record anyway
            if self.policy == "lenient":
                self.stats.lose(self._bgzf.abandon())
            return False

    def __iter__(self) -> Iterator[BamRecord]:
        if not self._header_ok:
            if self.policy != "salvage" or not self._resync_records():
                return
        while True:
            if self._bgzf.lost_sync:
                # a corrupt block was skipped: cross the boundary and
                # rescan record framing in the post-resync stream
                self._bgzf.cross_boundary()
                if not self._resync_records():
                    return
                continue
            head = self._bgzf.read(4)
            if len(head) < 4 and self._bgzf.lost_sync:
                # read stopped AT the resync boundary: the interrupted
                # record is part of the already-counted block loss
                continue
            if len(head) == 0:
                return
            if len(head) < 4:
                self._lost_framing("truncated_record",
                                   f"{len(head)} trailing byte(s) after the "
                                   "last whole record", len(head))
                return
            block_size = struct.unpack("<i", head)[0]
            if not _MIN_RECORD <= block_size <= _MAX_RECORD:
                if self.policy == "strict":
                    raise BamDecodeError(
                        "block_size",
                        f"record block_size {block_size} out of bounds")
                self.stats.count("block_size")
                if self.policy == "lenient":
                    self.stats.lose(self._bgzf.abandon() + 4)
                    return
                # salvage: the length field lies -- rescan from one byte
                # past the record start
                self._bgzf.push_back(head[1:])
                self.stats.lose(1)
                if not self._resync_records():
                    return
                continue
            body = self._bgzf.read(block_size)
            if len(body) < block_size:
                if self._bgzf.lost_sync:
                    continue  # boundary mid-record; resync at loop top
                self._lost_framing(
                    "truncated_record",
                    f"record cut short ({len(body)}/{block_size} bytes)",
                    4 + len(body))
                return
            try:
                rec = _decode_record(body, self.policy)
            except BamDecodeError as e:
                if self.policy == "strict":
                    raise
                # framing was plausible: skip THIS record, keep the
                # stream position (an in-bounds length lie surfaces as a
                # block_size/overflow failure on the next iteration and
                # salvage rescans there)
                self.stats.count(e.reason)
                continue
            yield rec

    def _lost_framing(self, reason: str, message: str, nbytes: int) -> None:
        self.stats.truncated = True
        if self.policy == "strict":
            raise TruncatedBamError(message, nbytes)
        self.stats.count(reason)
        self.stats.lose(nbytes)

    def _resync_records(self) -> bool:
        """Salvage: scan the decompressed stream for the next plausible
        record header.  Returns False when the stream is exhausted."""
        scanned = 0
        while True:
            if self._bgzf.lost_sync:
                # another corrupt block was skipped mid-scan: what is
                # buffered pre-boundary held no record start, so drop it
                # whole before crossing (never scan spliced bytes)
                self.stats.lose(self._bgzf.skip(self._SCAN_WINDOW))
                self._bgzf.cross_boundary()
                continue
            buf = self._bgzf.peek(self._SCAN_WINDOW)
            if len(buf) < _MIN_RECORD + 4:
                if self._bgzf.lost_sync:
                    continue  # short because of a boundary, not EOF
                self.stats.lose(self._bgzf.abandon())
                return False
            # keep a full-header-sized tail (block_size + fixed section +
            # max 255-byte name) so a record start straddling the window
            # boundary is still found next round; at EOF nothing follows,
            # so the minimum-record tail suffices
            tail = (4 + 32 + 256) if len(buf) >= self._SCAN_WINDOW \
                else (_MIN_RECORD + 4)
            limit = max(1, len(buf) - tail + 1)
            for off in _scan_candidates(buf, limit):
                if _plausible_record(buf, off):
                    self._bgzf.skip(off)
                    self.stats.lose(off)
                    return True
            if self._bgzf.lost_sync:
                continue  # handled (whole-buffer drop) at loop top
            self._bgzf.skip(limit)
            self.stats.lose(limit)
            scanned += limit
            if scanned > _MAX_RESYNC_SCAN:
                self.stats.lose(self._bgzf.abandon())
                return False

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "BamReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
