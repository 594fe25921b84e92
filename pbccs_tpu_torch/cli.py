"""`ccs`-equivalent batch command line of the port.

    python -m pbccs_tpu_torch.cli [OPTIONS] OUTPUT FILES...

Reads subreads from BAM (PacBio conventions) or FASTA (records named
movie/zmw[/s_e], grouped by ZMW), runs the consensus pipeline on the
card, and writes a CCS BAM with its .pbi index (or a FASTA) plus a CSV
yield report.  Flags, defaults, CLI-level filters (whitelist, chemistry,
SNR, read score, pass count) and output tags mirror the reference `ccs`
(reference src/main/ccs.cpp:284-519) and pbccs_tpu.cli's batch form;
every flag is one that pbccs_tpu's parser defines, with the same
meaning.  Two drivers: `--devices 1` (the default) is a bounded ordered
work queue of --numThreads threads, each drafting and polishing its work
item in turn; any other value is the device fleet (sched/): a pool of
prepare threads (--prepareWorkers, seeded by --numThreads) drafts and
marshals batches while one executor thread per card (--devices N, 0 =
all) polishes earlier ones, routed by --schedPolicy, with --memBudget
bounding the prepared backlog.  Both write the same output.  Also:
fault injection (--faults, --faultSeed), the dispatch watchdog
(--polishTimeout), the per-chunk checkpoint journal (--checkpoint,
--resume), span tracing (--trace-out), a torch.profiler capture
(--profile-dir), the perf ledger (--perfLedger: one `batch_run` record
per run, obs/ledger.py) and tuned knobs (--tuneProfile, runtime/
tuning.py).  Every run ends with the `run metrics:` table of its registry
window.  The kernels are built into and loaded from the build cache
(runtime/cache.py: build/kernels/ of the checkout, else
~/.cache/pbccs_tpu_torch/kernels).  Subcommands, every one of
pbccs_tpu.cli's: `ccs serve` (serve/server.py: the long-lived engine on
the card behind the NDJSON/TCP protocol; `ccs serve --port 0` prints
`CCS-SERVE-READY host port` and drains on SIGTERM), `ccs router`
(serve/router.py: the health-checked front door over `ccs serve`
replicas; it holds no CUDA context), `ccs fleet` (serve/supervisor.py:
a supervised router that spawns its `ccs serve` children, or an admin
action against one), `ccs top` (obs/console.py), `ccs roofline`
(obs/roofline.py), `ccs warmup` (sched/warmup.py), `ccs tune`
(tune/cli.py, with its serve leg) and `ccs analyze` (analysis/cli.py:
the static analysis of the port's own code, which imports neither torch
nor the code it reads); `ccs serve`, `ccs warmup` and `ccs fleet` take
`--compileCache DIR`.  On the card, a band width the kernels cannot
polish at (PBCCS_BAND_W, a tuned band_w; ops/fwdbwd_cuda.RUN_WIDTHS)
exits 2 before anything is written.

`run(argv, device=...)` is the in-process entry: the polish runs on the
card unless `device` names another (the tests pass device="cpu"; with
--devices N that is N CPU workers; the serve tests call
serve.server.run_serve(argv, device="cpu") in a child process, or run
its engine and server in-process; `ccs fleet` with device="cpu" spawns
children that do the same).  The fault injector, watchdog
deadline and tune profile a run arms are restored when it returns, so
in-process runs do not leak them into each other."""

from __future__ import annotations

import argparse
import contextlib
import itertools
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
from pbccs_tpu_torch.resilience import resources
from pbccs_tpu_torch.resilience.resources import OutputWriteError
from pbccs_tpu_torch.runtime import timing
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


def add_resilience_args(p: argparse.ArgumentParser) -> None:
    """The fault-handling flags (pbccs_tpu.cli.add_resilience_args)."""
    p.add_argument("--faults", default=None, metavar="SPEC",
                   help="Arm deterministic fault injection (chaos "
                        "testing), e.g. 'polish.dispatch:error~m/3'. "
                        "See pbccs_tpu_torch/resilience/faults.py for the "
                        "grammar; PBCCS_FAULTS is the env equivalent.")
    p.add_argument("--faultSeed", type=int, default=0,
                   help="Seed for probabilistic fault specs. "
                        "Default = %(default)s")
    p.add_argument("--polishTimeout", type=float, default=None,
                   metavar="SECONDS",
                   help="Watchdog deadline per device dispatch: a hung "
                        "polish becomes a structured timeout and the "
                        "affected ZMWs quarantine instead of stalling "
                        "the run (default: PBCCS_WATCHDOG_S, else off).")


@contextlib.contextmanager
def apply_resilience_args(args):
    """Arm --faults and --polishTimeout for the enclosed run, then put
    back the process's previous injector and deadline."""
    from pbccs_tpu_torch.resilience import faults, watchdog

    prev_injector = faults.get()
    if args.faults is not None:
        faults.configure(args.faults, seed=args.faultSeed)
    if args.polishTimeout is not None:
        prev_deadline = watchdog.configure(args.polishTimeout)
    try:
        yield
    finally:
        faults.install(prev_injector)
        if args.polishTimeout is not None:
            watchdog.configure(prev_deadline)


def band_width_refused(device, widths=()) -> bool:
    """Whether a band width this run would fix (PBCCS_BAND_W, a tuned
    band_w, the schedule, each of ``widths``: a tuner's band_w
    candidates) is one the card cannot polish at: then the reason goes
    to stderr and the entry point exits 2 before it writes anything.
    Every width polishes on the CPU."""
    from pbccs_tpu_torch.ops.fwdbwd_cuda import check_run_band_width

    try:
        check_run_band_width("cuda" if device is None else device,
                             widths=widths)
    except ValueError as e:
        print(f"ccs: {e}", file=sys.stderr)
        return True
    return False


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
                   help="Number of host pipeline threads (0 = auto); with "
                        "--devices it seeds the prepare pool unless "
                        "--prepareWorkers is given. Default = %(default)s")
    p.add_argument("--chunkSize", type=int, default=64,
                   help="ZMWs per work item; each work item polishes as one "
                        "lockstep device batch. Default = %(default)s")
    p.add_argument("--devices", type=int, default=1,
                   help="Polish across a device fleet (pbccs_tpu_torch."
                        "sched): N>1 uses the first N CUDA devices, 0 all "
                        "of them, 1 the single-device WorkQueue driver. "
                        "Default = %(default)s")
    p.add_argument("--prepareWorkers", type=int, default=0,
                   help="Host prepare (POA draft) threads overlapping "
                        "in-flight device polishes in the scheduled "
                        "driver (0 = auto; only used with --devices). "
                        "Default = %(default)s")
    p.add_argument("--schedPolicy", choices=("sticky", "least", "roundrobin"),
                   default="sticky",
                   help="Device-fleet routing: sticky keeps a polish-"
                        "shape bucket on the device that already ran it "
                        "(least-loaded otherwise). "
                        "Default = %(default)s")
    p.add_argument("--logFile", default=None, help="Log to a file vs stderr.")
    p.add_argument("--logLevel", default="INFO",
                   help="TRACE..FATAL. Default = %(default)s")
    p.add_argument("--trace-out", dest="trace_out", default=None,
                   metavar="FILE",
                   help="Write a Chrome-trace/Perfetto JSON of per-ZMW "
                        "spans (filter/draft/polish/emit, wall vs "
                        "device-wait) to FILE.")
    p.add_argument("--profile-dir", dest="profile_dir", default=None,
                   metavar="DIR",
                   help="Capture a torch.profiler trace of the run (CPU "
                        "and CUDA activities) into DIR as Chrome-trace "
                        "JSON.")
    p.add_argument("--reportFile", default="ccs_report.csv",
                   help="Where to write the yield report. Default = %(default)s")
    p.add_argument("--perfLedger", default=None, metavar="PATH",
                   help="Append one schema-versioned NDJSON performance "
                        "record for this run (obs/ledger.py) to PATH: "
                        "refine/padding counters, wall time, peak RSS, "
                        "governor interventions, roofline work -- the "
                        "record tools/perf_gate.py defends baselines "
                        "against. Default: off.")
    p.add_argument("--tuneProfile", default=None, metavar="PATH|auto",
                   help="Apply a `ccs tune` host profile: tuned knob "
                        "defaults (band width, prepare workers, memory "
                        "budget) resolved as explicit flag/env > "
                        "profile > hand-tuned constants.  `auto` scans "
                        "the profiles/ directory for this host's "
                        "fingerprint; a mismatched or corrupt profile "
                        "degrades to defaults with a note "
                        "(PBCCS_TUNE_PROFILE is the env equivalent). "
                        "Default: off.")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="Journal completed chunks to FILE (NDJSON) so a "
                        "killed run can restart with --resume. Default: "
                        "off (--resume implies OUTPUT.ckpt).")
    p.add_argument("--resume", action="store_true",
                   help="Restore completed chunks from the checkpoint "
                        "journal and compute only the rest; the final "
                        "tally and output are identical to an "
                        "uninterrupted run.")
    p.add_argument("--memBudget", default=None, metavar="SIZE",
                   help="Host-memory budget for batch backlog in the "
                        "fleet driver (--devices != 1), e.g. 8G or "
                        "512M: the prepare pool throttles (visible as "
                        "ccs_resource_throttles_total, never a crash) "
                        "while prepared-batch bytes in flight would "
                        "exceed it.  Default: unbounded.")
    p.add_argument("--batchFallback", choices=("bisect", "serial"),
                   default="bisect",
                   help="Recovery when a lockstep polish batch fails: "
                        "bisect isolates the poison ZMW(s) in O(k log Z) "
                        "re-dispatches; serial re-runs the whole batch "
                        "per-ZMW. Default = %(default)s")
    add_resilience_args(p)
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
    if argv and argv[0] == "serve":
        # `ccs serve`: the long-lived online engine (serve/)
        from pbccs_tpu_torch.serve.server import run_serve

        return run_serve(argv[1:], device=device)
    if argv and argv[0] == "router":
        # `ccs router`: multi-replica front door (serve/router.py)
        from pbccs_tpu_torch.serve.router import run_router

        return run_router(argv[1:])
    if argv and argv[0] == "fleet":
        # `ccs fleet`: self-healing supervised fleet (serve/supervisor.py)
        from pbccs_tpu_torch.serve.supervisor import run_fleet

        return run_fleet(argv[1:], device=device)
    if argv and argv[0] == "top":
        # `ccs top`: live fleet console over a router/serve endpoint
        from pbccs_tpu_torch.obs.console import run_top

        return run_top(argv[1:])
    if argv and argv[0] == "roofline":
        # `ccs roofline`: per-bucket counted bound vs measured report
        from pbccs_tpu_torch.obs.roofline import run_roofline

        return run_roofline(argv[1:])
    if argv and argv[0] == "warmup":
        # `ccs warmup`: build the kernels, drive a declared bucket menu
        from pbccs_tpu_torch.sched.warmup import run_warmup

        return run_warmup(argv[1:], device=device)
    if argv and argv[0] == "tune":
        # `ccs tune`: the autotuner's batch leg
        from pbccs_tpu_torch.tune.cli import run_tune

        return run_tune(argv[1:], device=device)
    if argv and argv[0] == "analyze":
        # `ccs analyze`: static analysis of the port (analysis/)
        from pbccs_tpu_torch.analysis.cli import run_analyze

        return run_analyze(argv[1:])
    args = build_parser().parse_args(argv)
    from pbccs_tpu_torch.runtime import tuning

    with apply_resilience_args(args), tuning.scope():
        return _run(args, device)


def _run(args, device) -> int:
    from pbccs_tpu_torch.runtime.cache import enable_compilation_cache

    enable_compilation_cache()

    log = Logger.default(Logger(
        stream=open(args.logFile, "w") if args.logFile else sys.stderr,
        level=LogLevel.from_string(args.logLevel)))
    install_signal_handlers(log)

    from pbccs_tpu_torch.runtime import tuning

    # opt-in tuned-knob resolution: explicit flag / env still beats
    # anything a profile carries
    tuning.configure(args.tuneProfile, logger=log, device=device)
    if args.model == "arrow" and band_width_refused(device):
        return 2
    try:
        whitelist = Whitelist(args.zmws)
    except ValueError as e:
        print(f"option --zmws: invalid specification: {e}", file=sys.stderr)
        return 2
    if args.devices < 0:
        print(f"option --devices: must be >= 0, got {args.devices}",
              file=sys.stderr)
        return 2
    if args.memBudget is not None:
        try:
            args.memBudget = resources.parse_size(args.memBudget)
            if args.memBudget < 1:
                raise ValueError(f"must be >= 1 byte, got {args.memBudget}")
        except ValueError as e:
            print(f"option --memBudget: {e}", file=sys.stderr)
            return 2
    elif args.devices != 1:
        # no explicit --memBudget: a tuned profile's byte budget applies
        # (the single-device driver has no prepare backlog to gate)
        args.memBudget = tuning.knob_int("mem_budget_bytes")
    settings = consensus_settings_from_args(args)
    files = flatten_fofn(args.files)
    for f in files:
        if not os.path.exists(f):
            print(f"input file does not exist: {f}", file=sys.stderr)
            return 2
    dev = resolve_device(device)

    from pbccs_tpu_torch.obs import profiling
    from pbccs_tpu_torch.obs import trace as obs_trace
    from pbccs_tpu_torch.obs.metrics import default_registry

    # a measurement window over this run (the summary table below reports
    # its deltas) plus the opt-in captures (--trace-out, --profile-dir)
    run_window = timing.window()
    tracer = None
    if args.trace_out:
        tracer = obs_trace.Tracer()
        if not obs_trace.install_tracer(tracer):
            log.warn("--trace-out ignored: another span capture is "
                     "already running in this process")
            tracer = None
    t0 = time.monotonic()
    try:
        with profiling.profile_capture(args.profile_dir):
            tally = _run_pipeline(args, files, whitelist, settings, log, dev)
    except OutputWriteError as e:
        # a full disk is an operational failure, not a bug: report what
        # was lost and how to resume, exit nonzero without a traceback.
        # The checkpoint journal (if any) keeps every completed chunk.
        log.error(f"output failure: {e}")
        print(f"ccs: {e}\n"
              "ccs: free disk space and re-run (add --resume to restore "
              "completed chunks from the checkpoint journal)",
              file=sys.stderr)
        log.flush()
        return 1
    finally:
        if tracer is not None:
            obs_trace.clear_tracer(tracer)
            tracer.write_json(args.trace_out)
            log.info(f"trace spans written to {args.trace_out}")
    counts = ", ".join(f"{f.value}={c}" for f, c in tally.counts.items() if c)
    log.info(f"run summary: {tally.total} ZMWs in "
             f"{time.monotonic() - t0:.3f} s on {dev} [{counts}]")
    log.info("run metrics:\n" + default_registry().summary_table(run_window))
    if args.perfLedger:
        # one perf-ledger record per run: the registry deltas over this
        # run's window + what only the driver knows (wall, yield)
        from pbccs_tpu_torch.obs.ledger import PerfLedger, run_record

        ledger = PerfLedger(args.perfLedger, logger=log)
        ledger.append(run_record(
            run_window, kind="batch_run", source="ccs",
            workload={"files": [os.path.basename(f) for f in files],
                      "chunk_size": args.chunkSize,
                      "devices": args.devices,
                      "model": args.model},
            wall_s=time.monotonic() - t0, zmws=tally.total,
            results=len(tally.results), device=dev))
        ledger.close()
        log.info(f"perf ledger record appended to {args.perfLedger}")
    log.flush()
    return 0


def _open_journal(args, files, settings, log):
    """The checkpoint journal of this run and the chunks it restores:
    (journal or None, {index: ResultTally}).  Only a contiguous prefix of
    restored chunks is used: results splice ahead of recomputed ones, so
    a dropped record mid-journal invalidates everything after it."""
    ckpt_path = args.checkpoint or (args.output + ".ckpt"
                                    if args.resume else None)
    if not ckpt_path:
        return None, {}
    from pbccs_tpu_torch.resilience.checkpoint import (CheckpointJournal,
                                                       run_fingerprint)

    # every knob that changes chunk COMPOSITION must fingerprint:
    # minReadScore filters reads and skipChemistryCheck drops ZMWs
    # before batching (the rest ride in via settings/files)
    fp = run_fingerprint(
        files, args.chunkSize, settings,
        extra={"zmws": args.zmws, "min_read_score": args.minReadScore,
               "skip_chemistry_check": bool(args.skipChemistryCheck)})
    journal = CheckpointJournal(ckpt_path, logger=log)
    restored: dict[int, ResultTally] = {}
    if args.resume:
        restored = journal.load(fp)
        k = 0
        while k in restored:
            k += 1
        if len(restored) > k:
            log.warn(f"resume: journal has a gap at chunk {k}; "
                     f"recomputing {len(restored) - k} chunk(s) "
                     "after it to preserve output order")
        restored = {i: t for i, t in restored.items() if i < k}
    journal.start(fp, resume=args.resume and bool(restored))
    return journal, restored


def _run_queue(args, settings, log, device, tally: ResultTally, journal,
               restored, read_batches) -> None:
    """The single-device driver: a bounded ordered work queue whose
    threads each draft and polish one work item."""
    # at least 2 workers, the reference's reader/worker/writer form
    # (ccs.cpp:388-499).  The threads share the GIL and the card's
    # default stream.  Torch ops and the kernels' ctypes launches of
    # every thread run on that stream in issue order, so no kernel reads
    # a tensor another thread is still writing.
    n_threads = args.numThreads or max(2, min(8, os.cpu_count() or 1))
    if args.memBudget is not None:
        log.warn("--memBudget gates the fleet driver's prepare backlog; "
                 "the single-device WorkQueue driver (--devices 1) is "
                 "already bounded by --numThreads work items, so the flag "
                 "is ignored here")

    from pbccs_tpu_torch.sched.pool import device_name

    # the memory governor keys its ceilings by the card, under the name
    # the fleet's worker on that card has (cuda:0)
    governor_key = device_name(device)

    def run_batch(idx, batch):
        with resources.device_scope(governor_key):
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
            # after a journal write fails the consumer keeps draining
            # (discarding) results, so a producer waiting for a pipeline
            # slot wakes, sees the error and stops
            try:
                for idx, sub_tally in wq.results():
                    if consumer_error:
                        continue
                    consumed.merge(sub_tally)
                    if journal is None:
                        continue
                    try:
                        journal.record_chunk(idx, sub_tally)
                    except OutputWriteError as e:
                        consumer_error.append(e)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                consumer_error.append(e)

        consumer = threading.Thread(target=consume, name="pbccs-consumer")
        consumer.start()
        try:
            for idx, batch in read_batches(tally):
                if consumer_error:
                    break
                if idx in restored:
                    # journaled chunks are a prefix: they merge before any
                    # computed chunk, so the output order is the
                    # uninterrupted run's
                    tally.merge(restored[idx])
                    continue
                with timing.stage("queue"):
                    wq.produce(run_batch, idx, batch)
        finally:
            wq.finalize()
            consumer.join()
    if consumer_error:
        raise consumer_error[0]
    tally.merge(consumed)


def _run_fleet(args, settings, log, device, tally: ResultTally, journal,
               restored, read_batches) -> None:
    """The device fleet (sched/): prepare threads draft and marshal
    batches while one executor thread per card polishes earlier ones;
    results come out in input order, so the output is the work queue's."""
    from pbccs_tpu_torch.runtime import tuning
    from pbccs_tpu_torch.sched import (DevicePool, DevicePoolConfig,
                                       ScheduledPipeline, select_devices)

    devs = select_devices(args.devices, device)
    # --numThreads sizes the work queue; here it seeds the prepare pool
    # (an explicit --prepareWorkers wins), then a tuned profile's count,
    # then the default
    prep_workers = (args.prepareWorkers or args.numThreads
                    or tuning.knob_int("prepare_workers")
                    or max(2, min(4, os.cpu_count() or 1)))
    budget = None
    if args.memBudget is not None:
        budget = resources.HostBudget(args.memBudget, logger=log)
    pool = DevicePool(devs, DevicePoolConfig(policy=args.schedPolicy),
                      logger=log)
    pipe = ScheduledPipeline(pool, settings, prepare_workers=prep_workers,
                             on_error=args.batchFallback, budget=budget,
                             logger=log)
    # the reader runs on the pipeline's feeder thread, so its gate skips
    # tally apart (merged below); journal-restored chunks ride through
    # as precomputed tallies and come out at their index
    gate_tally = ResultTally()
    items = ((idx, batch, restored.get(idx))
             for idx, batch in read_batches(gate_tally))
    try:
        for idx, sub_tally in pipe.run(items):
            tally.merge(sub_tally)
            if journal is not None and idx not in restored:
                journal.record_chunk(idx, sub_tally)
    except BaseException:
        # the run is doomed: fail queued batches fast instead of
        # polishing work nothing will consume
        pool.close(wait=False)
        raise
    pool.close()
    tally.merge(gate_tally)


def _run_pipeline(args, files, whitelist, settings, log,
                  device) -> ResultTally:
    """Reader -> the work queue (--devices 1) or the device fleet's
    scheduled pipeline (otherwise) -> batched polish -> writer."""
    tally = ResultTally()
    movies: dict[str, ReadGroupInfo] = {}
    journal, restored = _open_journal(args, files, settings, log)

    def read_batches(gate_tally: ResultTally):
        """The reader of both drivers: (idx, batch) with read-stage
        timing and the output header's movies; CLI-gate skips tally into
        `gate_tally` (the fleet passes its own: this generator runs on
        its feeder thread there)."""
        batches = iter(gated_chunks(files, whitelist, args, log,
                                    gate_tally))
        for idx in itertools.count():
            with timing.stage("read"):
                batch = next(batches, None)
            if batch is None:
                return
            for chunk in batch:
                movie = chunk.id.split("/")[0]
                movies.setdefault(movie, ReadGroupInfo(movie, "CCS"))
            yield idx, batch

    try:
        if args.devices != 1:
            _run_fleet(args, settings, log, device, tally, journal,
                       restored, read_batches)
        else:
            _run_queue(args, settings, log, device, tally, journal,
                       restored, read_batches)
    finally:
        if journal is not None:
            journal.close()
    log.info(f"processed {tally.total} ZMWs: "
             f"{tally.counts[Failure.SUCCESS]} successes")

    from pbccs_tpu_torch.obs import trace as obs_trace

    with obs_trace.span("emit", results=len(tally.results)), \
            timing.stage("write"):
        if any(args.output.endswith(e) for e in (".fa", ".fasta", ".fsa")):
            from pbccs_tpu_torch.io.fasta import write_fasta

            write_fasta(args.output,
                        ((f"{r.id}/ccs", r.sequence) for r in tally.results))
        else:
            _write_bam(args.output, tally, list(movies.values()))
    write_report_file(args.reportFile, tally)
    if journal is not None:
        # only a run whose outputs landed needs no resume point: a
        # disk-full failure above keeps the journal for --resume
        journal.remove()
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
