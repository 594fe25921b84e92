"""The port's CLI input/output modules against the JAX package's copies.

The same records go through both packages' writers and readers:
BamWriter and PbiBuilder bytes identical, BamReader decodes (and
rejects under each decode policy) alike, validate_chunk rejects with the
same reasons, and the FASTA, whitelist, chemistry and report helpers
agree."""

import io

import numpy as np
import pytest
import torch

from pbccs_tpu.io import bam as jbam
from pbccs_tpu.io import pbi as jpbi
from pbccs_tpu.io.fasta import read_fasta as jread_fasta
from pbccs_tpu.io.report import write_results_report as jreport
from pbccs_tpu.io.validate import ChunkValidationError as JInvalid
from pbccs_tpu.io.validate import validate_chunk as jvalidate
from pbccs_tpu.pipeline import Chunk as JChunk
from pbccs_tpu.pipeline import Failure as JFailure
from pbccs_tpu.pipeline import ResultTally as JTally
from pbccs_tpu.pipeline import Subread as JSubread
from pbccs_tpu.runtime.chemistry import verify_chemistry as jchem
from pbccs_tpu.runtime.whitelist import Whitelist as JWhitelist

from pbccs_tpu_torch.io import bam as tbam
from pbccs_tpu_torch.io import pbi as tpbi
from pbccs_tpu_torch.io.fasta import flatten_fofn, read_fasta, write_fasta
from pbccs_tpu_torch.io.report import write_results_report
from pbccs_tpu_torch.io.validate import ChunkValidationError, validate_chunk
from pbccs_tpu_torch.pipeline import Chunk, Failure, ResultTally, Subread
from pbccs_tpu_torch.runtime.chemistry import verify_chemistry
from pbccs_tpu_torch.runtime.whitelist import Whitelist
from pbccs_tpu_torch.runtime.workqueue import WorkQueue

torch.set_num_threads(1)

MOVIE = "m140905_042212_sidney_c100564852550000001823085912221377_s1_X0"


def _records(pkg, n, seq_len, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seq = "".join("ACGT"[b] for b in rng.integers(0, 4, seq_len))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 60, seq_len))
        out.append(pkg.BamRecord(
            name=f"{MOVIE}/{i}/ccs", seq=seq, qual=qual, tags={
                "RG": pkg.make_read_group_id(MOVIE, "CCS"), "zm": i,
                "np": int(rng.integers(3, 20)), "rq": 990,
                "sn": [6.5, 7.25, 8.0, 9.5], "pq": 0.9925,
                "za": -0.5, "zs": [0.25, -1.5, 2.0], "rs": [3, 1, 0, 0, 0],
                **({"df": 1} if i % 3 == 0 else {})}))
    return out


def _header(pkg):
    return pkg.BamHeader(
        read_groups=[pkg.ReadGroupInfo(MOVIE, "CCS", binding_kit="100356300",
                                       sequencing_kit="100356200",
                                       basecaller_version="2.3.0")],
        program_lines=["@PG\tID:ccs-0.1.0\tPN:ccs\tVN:0.1.0"])


def _write(pkg, path, n, seq_len):
    offs = []
    with pkg.BamWriter(path, _header(pkg)) as bw:
        for rec in _records(pkg, n, seq_len):
            offs.append(bw.write(rec))
    return [bw.voffset(u) for u in offs]


# single block, and > 4 blocks (the native codec's batch path)
SIZES = [(6, 80), (300, 1200)]


@pytest.mark.parametrize("n,seq_len", SIZES)
def test_bam_writer_bytes_match_jax(tmp_path, n, seq_len):
    a, b = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    va = _write(jbam, a, n, seq_len)
    vb = _write(tbam, b, n, seq_len)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert va == vb


@pytest.mark.parametrize("n,seq_len", SIZES)
def test_bam_reader_matches_jax(tmp_path, n, seq_len):
    path = str(tmp_path / "t.bam")
    _write(tbam, path, n, seq_len)
    with tbam.BamReader(path) as r:
        mine, mine_rgs = list(r), r.header.read_groups
    with jbam.BamReader(path) as r:
        ref, ref_rgs = list(r), r.header.read_groups
    assert [vars(x) for x in mine] == [vars(x) for x in ref]
    assert [vars(x) for x in mine_rgs] == [vars(x) for x in ref_rgs]
    written = _records(tbam, n, seq_len)
    assert [(x.name, x.seq, x.qual, x.tags["zm"], x.tags.get("df"))
            for x in mine] == [(x.name, x.seq, x.qual, x.tags["zm"],
                                x.tags.get("df")) for x in written]


@pytest.mark.parametrize("n,seq_len", SIZES)
def test_pbi_bytes_match_jax(tmp_path, n, seq_len):
    bam = str(tmp_path / "t.bam")
    voffs = _write(tbam, bam, n, seq_len)
    rg = tpbi.read_group_numeric_id(tbam.make_read_group_id(MOVIE, "CCS"))
    assert rg == jpbi.read_group_numeric_id(
        jbam.make_read_group_id(MOVIE, "CCS"))
    paths = []
    for pkg in (jpbi, tpbi):
        p = str(tmp_path / f"{pkg.__name__.split('.')[0]}.pbi")
        with pkg.PbiBuilder(p) as b:
            for i, v in enumerate(voffs):
                b.add_record(rg, -1, -1, i, 0.99 - i * 1e-4, 0, v)
        paths.append(p)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    idx = tpbi.PbiIndex(paths[1])
    ref = jpbi.PbiIndex(paths[0])
    np.testing.assert_array_equal(idx.holes, ref.holes)
    np.testing.assert_array_equal(idx.offsets, ref.offsets)
    np.testing.assert_array_equal(idx.offsets, voffs)
    assert list(idx.rows_for_zmw(3)) == [3]


def _payload(pkg, records):
    text = _header(pkg).to_text().encode()
    out = bytearray(b"BAM\x01" + len(text).to_bytes(4, "little") + text
                    + (0).to_bytes(4, "little"))
    for rec in records:
        out += pkg.encode_record(rec)
    return out


def _bgzf(payload) -> bytes:
    buf = io.BytesIO()
    w = tbam.BgzfWriter(buf)
    w.write(bytes(payload))
    w.close()
    return buf.getvalue()


def _corrupt(kind: str) -> bytes:
    """A BAM stream with one corruption of `kind`."""
    recs = _records(tbam, 60 if kind == "crc" else 6, 1500 if kind == "crc"
                    else 40)
    payload = _payload(tbam, recs)
    if kind == "tag_type":
        at = payload.index(b"zmi", 200)
        at = payload.index(b"zmi", at + 1)
        payload[at + 2] = ord("q")
    elif kind == "nibble":
        at = payload.index(recs[1].name.encode())
        payload[at + len(recs[1].name) + 1 + 3] = 0xFF
    data = bytearray(_bgzf(payload))
    if kind == "crc":
        starts, off = [], 0
        while off < len(data) - 28:
            starts.append(off)
            off += (data[off + 16] | (data[off + 17] << 8)) + 1
        data[starts[2] + 200] ^= 0x10
    elif kind == "truncated":
        data = data[: len(data) - 60]
    return bytes(data)


@pytest.mark.parametrize("kind", ["tag_type", "nibble", "crc", "truncated"])
@pytest.mark.parametrize("policy", ["strict", "lenient", "salvage"])
def test_decode_policies_match_jax(tmp_path, kind, policy):
    path = str(tmp_path / f"{kind}.bam")
    with open(path, "wb") as f:
        f.write(_corrupt(kind))

    def decode(pkg):
        try:
            with pkg.BamReader(path, policy=policy) as r:
                names = [rec.name for rec in r]
                s = r.stats
            return ("ok", names, dict(s.invalid_records), s.salvaged_blocks,
                    s.bytes_lost, s.truncated)
        except pkg.BamDecodeError as e:
            return ("raised", type(e).__name__, e.reason)

    assert decode(tbam) == decode(jbam)


BAD_CHUNKS = [
    ("snr_shape", dict(snr=[1.0, 2.0])),
    ("bad_snr", dict(snr=[1.0, np.nan, 3.0, 4.0])),
    ("bad_snr", dict(snr=[1.0, -2.0, 3.0, 4.0])),
    ("no_reads", dict(reads=0)),
    ("read_length", dict(empty_read=True)),
    ("accuracy_range", dict(accuracy=1.5)),
    ("accuracy_range", dict(accuracy=float("nan"))),
    (None, dict()),
]


@pytest.mark.parametrize("reason,kw", BAD_CHUNKS)
def test_validate_chunk_matches_jax(reason, kw):
    def make(C, S):
        n = kw.get("reads", 3)
        reads = [S(f"m/1/{i}", np.zeros(0 if kw.get("empty_read") and i == 1
                                        else 20, np.int8),
                   read_accuracy=kw.get("accuracy", 0.9)) for i in range(n)]
        return C("m/1", reads, np.asarray(kw.get("snr", [8.0] * 4)))

    got = want = None
    try:
        validate_chunk(make(Chunk, Subread))
    except ChunkValidationError as e:
        got = e.reason
    try:
        jvalidate(make(JChunk, JSubread))
    except JInvalid as e:
        want = e.reason
    assert got == want == reason


@pytest.mark.parametrize("spec", ["all", "*:*", "1-3,5", "*:2", "mA:1-2;mB:*",
                                  "mB:7", "all;1-3", "1-3;mA:2", "x-1", "5-2"])
def test_whitelist_matches_jax(spec):
    def build(W):
        try:
            return W(spec)
        except ValueError:
            return None

    mine, ref = build(Whitelist), build(JWhitelist)
    assert (mine is None) == (ref is None)
    if mine is not None:
        for movie in ("mA", "mB", "mC"):
            for hole in range(10):
                assert mine.contains(movie, hole) == ref.contains(movie, hole)


@pytest.mark.parametrize("bc,sk,bk", [("2.3.0.1", "100356200", "100356300"),
                                      ("2.1.5", "100356200", "100372700"),
                                      ("3.0.0", "100356200", "100356300"),
                                      ("2.3.0", "999", "100356300"),
                                      ("2.3.0", "100356200", "999")])
def test_chemistry_gate_matches_jax(bc, sk, bk):
    kw = dict(binding_kit=bk, sequencing_kit=sk, basecaller_version=bc)
    assert verify_chemistry(tbam.ReadGroupInfo("m", **kw)) == \
        jchem(jbam.ReadGroupInfo("m", **kw))


def test_fasta_and_fofn(tmp_path):
    recs = [("m/1/0_10", "ACGTACGTAC" * 9), ("m/2/0_5", "ACGTA")]
    path = str(tmp_path / "a.fasta")
    write_fasta(path, recs)
    assert list(read_fasta(path)) == list(jread_fasta(path)) == recs
    fofn = tmp_path / "in.fofn"
    fofn.write_text("a.fasta\n\n")
    assert flatten_fofn([str(fofn)]) == [path]


def test_report_text_matches_jax():
    mine, ref = ResultTally(), JTally()
    for i, f in enumerate(Failure):
        for _ in range(i + (f == Failure.OTHER)):
            mine.tally(f)
            ref.tally(JFailure(f.value))
    a, b = io.StringIO(), io.StringIO()
    write_results_report(a, mine)
    jreport(b, ref)
    assert a.getvalue() == b.getvalue()
    assert "Failed -- Exception thrown" in a.getvalue()


def test_workqueue_keeps_order_and_propagates():
    import time

    with WorkQueue(3) as wq:      # 9 results may wait unconsumed
        for i in range(9):
            wq.produce(lambda i=i: (time.sleep(0.002 * (i % 3)), i)[1])
        wq.finalize()
        assert list(wq.results()) == list(range(9))
    with WorkQueue(2) as wq:
        wq.produce(lambda: 1 / 0)
        wq.finalize()
        with pytest.raises(ZeroDivisionError):
            list(wq.results())


def test_atomic_output_publishes_only_on_success(tmp_path):
    path = str(tmp_path / "out.txt")
    with tbam.atomic_output(path, "report") as fh:
        fh.write("ok\n")
    assert open(path).read() == "ok\n"
    with pytest.raises(RuntimeError):
        with tbam.atomic_output(path, "report") as fh:
            fh.write("torn")
            raise RuntimeError("mid-write")
    assert open(path).read() == "ok\n"
    assert not (tmp_path / "out.txt.tmp").exists()
    with pytest.raises(tbam.OutputWriteError) as e:
        with tbam.atomic_output(str(tmp_path / "no" / "x"), "bam"):
            pass
    assert e.value.sink == "bam"
