"""`ccs`-equivalent batch command line of the port.

    python -m pbccs_tpu_torch.cli [OPTIONS] OUTPUT FILES...

Reads subreads from BAM (PacBio conventions) or FASTA (records named
movie/zmw[/s_e], grouped by ZMW), runs the consensus pipeline over a
bounded ordered work queue on the card, and writes a CCS BAM with its
.pbi index (or a FASTA) plus a CSV yield report.  Flags, defaults,
CLI-level filters (whitelist, chemistry, SNR, read score, pass count) and
output tags mirror the reference `ccs` (reference src/main/ccs.cpp:
284-519) and pbccs_tpu.cli's single-device WorkQueue form; every flag is
one that pbccs_tpu's parser defines.  Left out: the subcommands (serve,
router, fleet, warmup, tune, analyze, top, roofline) and the flags of
tiers the port does not have (the device fleet, checkpoint/resume, the
memory budget, fault injection and the watchdog, tracing, profiling, the
perf ledger and tuned profiles) -- argparse rejects each of them.

`run(argv, device=...)` is the in-process entry: the polish runs on the
card unless `device` names another (the tests pass device="cpu")."""

from __future__ import annotations

import argparse
import math
import os
import sys
import threading
import time

import numpy as np

from pbccs_tpu_torch import __version__
from pbccs_tpu_torch.device import resolve_device
from pbccs_tpu_torch.io.bam import (
    BamDecodeError,
    BamHeader,
    BamReader,
    BamRecord,
    BamWriter,
    OutputWriteError,
    ReadGroupInfo,
    make_read_group_id,
)
from pbccs_tpu_torch.io.fasta import flatten_fofn, read_fasta
from pbccs_tpu_torch.io.report import write_report_file
from pbccs_tpu_torch.io.validate import ChunkValidationError, validate_chunk
from pbccs_tpu_torch.models.arrow.params import encode_bases
from pbccs_tpu_torch.pipeline import (
    Chunk,
    ConsensusSettings,
    Failure,
    ResultTally,
    Subread,
    process_chunks,
)
from pbccs_tpu_torch.runtime.chemistry import verify_chemistry
from pbccs_tpu_torch.runtime.logging import (Logger, LogLevel,
                                             install_signal_handlers)
from pbccs_tpu_torch.runtime.whitelist import Whitelist
from pbccs_tpu_torch.runtime.workqueue import WorkQueue

DESCRIPTION = ("Generate circular consensus sequences (ccs) from subreads "
               "-- PyTorch/CUDA implementation.")

FASTA_EXTS = (".fa", ".fasta", ".fsa", ".fa.gz", ".fasta.gz", ".fsa.gz")


def add_consensus_args(p: argparse.ArgumentParser) -> None:
    """The consensus-gate flags (pbccs_tpu.cli.add_consensus_args)."""
    p.add_argument("--minSnr", type=float, default=4.0,
                   help="Minimum SNR of input subreads. Default = %(default)s")
    p.add_argument("--minReadScore", type=float, default=0.75,
                   help="Minimum read score of input subreads. Default = %(default)s")
    p.add_argument("--minLength", type=int, default=10,
                   help="Minimum length of subreads. Default = %(default)s")
    p.add_argument("--minPasses", type=int, default=3,
                   help="Minimum number of subreads required. Default = %(default)s")
    p.add_argument("--minPredictedAccuracy", type=float, default=0.90,
                   help="Minimum predicted accuracy. Default = %(default)s")
    p.add_argument("--minZScore", type=float, default=-5.0,
                   help="Minimum subread z-score; NaN disables. Default = %(default)s")
    p.add_argument("--maxDropFraction", type=float, default=0.34,
                   help="Maximum fraction of droppable subreads. Default = %(default)s")
    p.add_argument("--model", choices=("arrow", "quiver"), default="arrow",
                   help="Polish model family (default: arrow, the ccs "
                        "model; quiver is the QV-feature model -- reads "
                        "without QV tracks use flat default tracks).")
    p.add_argument("--degradeQuarantined", action="store_true",
                   help="Emit quarantined poison ZMWs (batch AND serial "
                        "polish failed) as draft-only consensus with a "
                        "`df` tag and capped QVs instead of dropping "
                        "them as Other.")


def consensus_settings_from_args(args) -> ConsensusSettings:
    return ConsensusSettings(
        min_length=args.minLength,
        min_passes=args.minPasses,
        min_snr=args.minSnr,
        min_predicted_accuracy=args.minPredictedAccuracy,
        min_zscore=args.minZScore,
        max_drop_fraction=args.maxDropFraction,
        model=args.model,
        degrade_quarantined=args.degradeQuarantined)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ccs", description=DESCRIPTION)
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("--zmws", default="all",
                   help="ZMWs to process: all, or ranges like 1-3,5 or "
                        "movie:1-3,5;movie2:*. Default = %(default)s")
    add_consensus_args(p)
    p.add_argument("--numThreads", type=int, default=0,
                   help="Number of host pipeline threads (0 = auto). "
                        "Default = %(default)s")
    p.add_argument("--chunkSize", type=int, default=64,
                   help="ZMWs per work item; each work item polishes as one "
                        "lockstep device batch. Default = %(default)s")
    p.add_argument("--logFile", default=None, help="Log to a file vs stderr.")
    p.add_argument("--logLevel", default="INFO",
                   help="TRACE..FATAL. Default = %(default)s")
    p.add_argument("--reportFile", default="ccs_report.csv",
                   help="Where to write the yield report. Default = %(default)s")
    p.add_argument("--batchFallback", choices=("bisect", "serial"),
                   default="bisect",
                   help="Recovery when a lockstep polish batch fails: "
                        "bisect isolates the poison ZMW(s) in O(k log Z) "
                        "re-dispatches; serial re-runs the whole batch "
                        "per-ZMW. Default = %(default)s")
    p.add_argument("--decodePolicy", choices=("strict", "lenient", "salvage"),
                   default="strict",
                   help="BAM corruption handling: strict aborts on the "
                        "first corrupt byte (reference behavior); lenient "
                        "skips bad records and counts them; salvage "
                        "additionally resyncs past corrupt BGZF blocks. "
                        "Default = %(default)s")
    p.add_argument("--skipChemistryCheck", action="store_true",
                   help="Accept non-P6-C4 read groups (required for FASTA "
                        "input, which carries no chemistry metadata).")
    p.add_argument("output", help="Output BAM (or FASTA) path")
    p.add_argument("files", nargs="+", help="Input subread BAM/FASTA/FOFN files")
    return p


def iter_fasta_chunks(path: str, log: Logger):
    """Group FASTA records named movie/zmw[/s_e] into per-ZMW chunks;
    yields (chunk, None)."""
    current: Chunk | None = None
    for name, seq in read_fasta(path):
        parts = name.split("/")
        try:
            movie, zmw = parts[0], int(parts[1])
        except (IndexError, ValueError):
            log.warn(f"skipping read {name}: name is not movie/zmw[/s_e]")
            continue
        zid = f"{movie}/{zmw}"
        if current is None or current.id != zid:
            if current is not None:
                yield current, None
            current = Chunk(zid, [], np.full(4, 8.0))
        current.reads.append(Subread.from_str(name, seq))
    if current is not None:
        yield current, None


def iter_bam_chunks(path: str, log: Logger, policy: str = "strict"):
    """Group BAM subread records into per-ZMW chunks; yields
    (chunk, read group) so the caller can apply the chemistry gate."""
    reader = BamReader(path, policy=policy)
    rgs = {rg.id: rg for rg in reader.header.read_groups}
    current: Chunk | None = None
    current_rg: ReadGroupInfo | None = None
    for rec in reader:
        parts = rec.name.split("/")
        if len(parts) < 2:
            log.warn(f"skipping read {rec.name}: bad name")
            continue
        movie = parts[0]
        try:
            hole = int(rec.tags.get("zm", parts[1]))
        except (TypeError, ValueError):
            log.warn(f"skipping read {rec.name}: no usable ZMW number")
            continue
        zid = f"{movie}/{hole}"
        if current is None or current.id != zid:
            if current is not None:
                yield current, current_rg
            try:
                snr = np.asarray(rec.tags.get("sn", [8.0] * 4), np.float64)
            except (TypeError, ValueError):
                # validate_chunk downstream rejects the bad shape
                snr = np.full(4, np.nan)
            current = Chunk(zid, [], snr)
            current_rg = rgs.get(rec.tags.get("RG", ""))
        try:
            flags = int(rec.tags.get("cx", 3))
            accuracy = float(rec.tags.get("rq", 0.8))
        except (TypeError, ValueError) as e:
            # structurally valid record, semantically garbage tag values:
            # degrade the record, never the run
            if policy == "strict":
                raise BamDecodeError(
                    "bad_tag_value",
                    f"{rec.name}: cx/rq tag not numeric: {e}") from None
            reader.stats.count("bad_tag_value")
            log.warn(f"skipping read {rec.name}: cx/rq tag not numeric "
                     "[reason=bad_tag_value]")
            continue
        current.reads.append(Subread(rec.name, encode_bases(rec.seq),
                                     flags=flags, read_accuracy=accuracy))
    reader.close()
    stats = reader.stats
    if stats.total_invalid or stats.bytes_lost:
        by_reason = ", ".join(f"{k}={v}" for k, v
                              in sorted(stats.invalid_records.items()))
        log.warn(f"{path}: decode policy '{policy}' rejected "
                 f"{stats.total_invalid} record(s)/block(s) [{by_reason}], "
                 f"salvaged {stats.salvaged_blocks} block resync(s), "
                 f"{stats.bytes_lost} byte(s) lost"
                 + (" (input truncated mid-stream)" if stats.truncated
                    else ""))
    if current is not None:
        yield current, current_rg


def gated_chunks(files, whitelist: Whitelist, args, log, tally: ResultTally):
    """Apply the CLI-level gates and yield batches of --chunkSize chunks;
    gate failures tally into `tally`."""
    batch: list[Chunk] = []
    for path in files:
        is_fasta = any(path.endswith(e) for e in FASTA_EXTS)
        it = (iter_fasta_chunks(path, log) if is_fasta
              else iter_bam_chunks(path, log, policy=args.decodePolicy))
        for chunk, rg in it:
            movie, hole_s = chunk.id.split("/")[:2]
            if not whitelist.contains(movie, int(hole_s)):
                continue
            try:
                validate_chunk(chunk)
            except ChunkValidationError as e:
                log.warn(f"rejecting ZMW {chunk.id}: {e} "
                         f"[reason={e.reason}]")
                continue
            if not args.skipChemistryCheck:
                if rg is None or not verify_chemistry(rg):
                    log.notice(f"Skipping ZMW {chunk.id}, invalid chemistry "
                               "(not P6/C4)")
                    continue
            if float(np.min(chunk.snr)) < args.minSnr:
                log.debug(f"Skipping ZMW {chunk.id}, fails SNR threshold")
                tally.tally(Failure.POOR_SNR)
                continue
            chunk.reads = [r for r in chunk.reads
                           if r.read_accuracy >= args.minReadScore]
            if len(chunk.reads) < args.minPasses:
                log.debug(f"Skipping ZMW {chunk.id}, insufficient passes")
                tally.tally(Failure.TOO_FEW_PASSES)
                continue
            batch.append(chunk)
            if len(batch) >= args.chunkSize:
                yield batch
                batch = []
    if batch:
        yield batch


def run(argv: list[str] | None = None, *, device=None) -> int:
    """The `ccs` batch command; returns the exit code (2 on a usage
    error, 1 on an output failure)."""
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)

    log = Logger.default(Logger(
        stream=open(args.logFile, "w") if args.logFile else sys.stderr,
        level=LogLevel.from_string(args.logLevel)))
    install_signal_handlers(log)

    try:
        whitelist = Whitelist(args.zmws)
    except ValueError as e:
        print(f"option --zmws: invalid specification: {e}", file=sys.stderr)
        return 2
    settings = consensus_settings_from_args(args)
    files = flatten_fofn(args.files)
    for f in files:
        if not os.path.exists(f):
            print(f"input file does not exist: {f}", file=sys.stderr)
            return 2
    dev = resolve_device(device)

    t0 = time.monotonic()
    try:
        tally = _run_pipeline(args, files, whitelist, settings, log, dev)
    except OutputWriteError as e:
        # a full disk is an operational failure, not a bug: report what
        # was lost and exit nonzero without a traceback
        log.error(f"output failure: {e}")
        print(f"ccs: {e}\nccs: free disk space and re-run", file=sys.stderr)
        log.flush()
        return 1
    counts = ", ".join(f"{f.value}={c}" for f, c in tally.counts.items() if c)
    log.info(f"run summary: {tally.total} ZMWs in "
             f"{time.monotonic() - t0:.3f} s on {dev} [{counts}]")
    log.flush()
    return 0


def _run_pipeline(args, files, whitelist, settings, log,
                  device) -> ResultTally:
    """Reader -> WorkQueue -> batched polish -> writer."""
    # at least 2 workers, the reference's reader/worker/writer form
    # (ccs.cpp:388-499).  The threads share the GIL and the card's
    # default stream, and no overlap of one batch's host draft with
    # another's polish has been measured yet (PERF.md section 5).  Torch
    # ops and the kernels' ctypes launches of every thread run on that
    # stream in issue order, so no kernel reads a tensor another thread
    # is still writing.
    n_threads = args.numThreads or max(2, min(8, os.cpu_count() or 1))
    tally = ResultTally()
    movies: dict[str, ReadGroupInfo] = {}

    def run_batch(idx, batch):
        return idx, process_chunks(batch, settings,
                                   on_error=args.batchFallback,
                                   device=device)

    consumed = ResultTally()
    consumer_error: list[BaseException] = []
    # the queue's bound counts results not yet CONSUMED, so the consumer
    # runs beside the produce loop (a produce-then-consume loop would
    # deadlock once the pipeline fills)
    with WorkQueue(n_threads) as wq:
        def consume():
            try:
                for _, sub_tally in wq.results():
                    consumed.merge(sub_tally)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                consumer_error.append(e)

        consumer = threading.Thread(target=consume, name="pbccs-consumer")
        consumer.start()
        try:
            for idx, batch in enumerate(gated_chunks(files, whitelist, args,
                                                     log, tally)):
                for chunk in batch:
                    movie = chunk.id.split("/")[0]
                    movies.setdefault(movie, ReadGroupInfo(movie, "CCS"))
                wq.produce(run_batch, idx, batch)
        finally:
            wq.finalize()
            consumer.join()
    if consumer_error:
        raise consumer_error[0]
    tally.merge(consumed)
    log.info(f"processed {tally.total} ZMWs: "
             f"{tally.counts[Failure.SUCCESS]} successes")

    if any(args.output.endswith(e) for e in (".fa", ".fasta", ".fsa")):
        from pbccs_tpu_torch.io.fasta import write_fasta

        write_fasta(args.output,
                    ((f"{r.id}/ccs", r.sequence) for r in tally.results))
    else:
        _write_bam(args.output, tally, list(movies.values()))
    write_report_file(args.reportFile, tally)
    return tally


def result_record(result) -> BamRecord:
    """The CCS BAM record of one consensus result (reference
    src/main/ccs.cpp:105-172; `df` marks a draft-only quarantined ZMW)."""
    movie, hole = result.id.split("/")[:2]
    return BamRecord(
        name=f"{result.id}/ccs",
        seq=result.sequence,
        qual=result.qualities,
        tags={
            "RG": make_read_group_id(movie, "CCS"),
            "zm": int(hole),
            "np": int(result.num_passes),
            "rq": int(1000 * result.predicted_accuracy),
            "sn": [float(s) for s in result.snr],
            "pq": float(result.predicted_accuracy),
            "za": float(result.avg_zscore),
            "zs": [float(z) if math.isfinite(z) else 0.0
                   for z in result.zscores],
            "rs": [int(c) for c in result.status_counts],
            **({"df": 1} if result.draft_only else {}),
        })


def _write_bam(path: str, tally: ResultTally,
               read_groups: list[ReadGroupInfo]) -> None:
    """The CCS BAM and its companion .pbi (reference src/main/ccs.cpp:
    120, 380), both published atomically."""
    from pbccs_tpu_torch.io.pbi import PbiBuilder, read_group_numeric_id

    header = BamHeader(read_groups=read_groups, program_lines=[
        f"@PG\tID:ccs-{__version__}\tPN:ccs\tVN:{__version__}"])
    uposs = []
    with BamWriter(path, header) as bw:
        for result in tally.results:
            uposs.append(bw.write(result_record(result)))
    with PbiBuilder(path + ".pbi") as pbi:
        for result, upos in zip(tally.results, uposs):
            movie, hole = result.id.split("/")[:2]
            pbi.add_record(
                read_group_numeric_id(make_read_group_id(movie, "CCS")),
                -1, -1, int(hole), result.predicted_accuracy, 0,
                bw.voffset(upos))


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
