#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pbccs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the
script exits non-zero):
  1. build: card name and power limit, torch/CUDA versions, the nvcc
     build of every kernel (all sources compiled in parallel) with the
     ptxas register / shared-memory report, and the host draft stage's
     native library (make, when the checkout has none yet);
  2. arrow_fill (K1): simulated 2 kb, 3-10-pass reads at the main path's
     shapes (384 reads, 2113 columns); the kernel against its plain torch
     version on the card at the schedule's W (96) and the 2x retry's W
     (192), forward, backward and both in one launch (the launch the
     main path makes): band values bitwise, log-scales within 1e-6
     relative; CUDA-event times of each launch and of the plain version;
     the bound counted by operation type (k1_bound, from
     obs/roofline.py's k1_work);
  3. dense_score (K3): on the fused fills of phase 2 at W = 96 and 192,
     and on K1's fills at W = 256 (the 2x retry of an explicit
     band_width of 128, spilled), the kernel against its plain version with every 64-position block
     live and with half of them dead: interior slots within 1e-6
     relative (expected bitwise), dead blocks zeros; CUDA-event times of
     the kernel and of the plain version; the bound counted by operation
     type (k3_bound); and how many of the batch's stick values PyTorch's
     CUDA division by the Python scalar 3 rounds otherwise than an IEEE
     divide (the plain versions divide through fwdbwd_cuda._third);
  4. main_path: process_chunks over 64 simulated ZMWs (2 kb, 3-10 passes,
     two batches of 32) on the card, with the launch counters zeroed
     just before and read just after; tally, yield, identity to the
     true template, wall time, ZMW/s, peak device memory, the full-size
     operand planes built (K1 coefficient planes, read-window planes,
     patch grids: must be none), and the live (read, 64-position) blocks
     K3 scored over its launches with K3's bound on them;
  5. cross_device: 4 ZMWs of the draw through process_chunks on the card
     and on the CPU: same consensus sequences, QVs within 1;
  6. quiver_fill (K2): the Quiver path's mutation-scoring fills of a
     2 kb ZMW of the draw (its true template as the draft, flat default
     QV tracks, the default QuiverConfig with every move, W=96).  At
     PR 2's shape, one read against 349 single-mutation windows (2002
     columns), the kernel in its band-value mode against its plain
     version on the card, forward and backward: log-likelihoods within
     1e-4 absolute, band values within 1e-5 relative (expected 0); its
     log-likelihood-only mode against the band-value mode (log-scales
     and final cells bitwise); CUDA-event times of the kernel in both
     modes and of the plain version.  At the scorer's own batch (the
     forward-strand reads against as many single-mutation windows as
     QuiverMultiReadScorer._chunk puts in one batch), the launch the
     Quiver path makes: the kernel's log-likelihood-only mode timed, and
     its outputs on a spread sample of the batch's rows (the first and
     last 64 and every (R // 256)-th, every read of the group among them)
     against the plain version on those rows (rows are independent):
     log-likelihoods within 1e-4 absolute, log-scales within 1e-5
     (expected 0);
  7. quiver_path: process_chunks with ConsensusSettings(model="quiver")
     over 4 simulated 2 kb, 3-10-pass ZMWs on the card, launch counters
     zeroed just before and read just after; then one ~300 bp, 5-pass
     ZMW on the card and on the CPU: same consensus, QVs within 1;
  8. refine_fallbacks: a tiny-window task (a read clipped to 6 template
     columns) and a bucket-growth task (a draft missing every fifth
     base) through BatchPolisher.refine + consensus_qvs on the card and
     on the CPU: the same results, K1 launched by the tiny window's
     refills, the bucket grown;
  9. serial: process_chunks(batch_polish=False) over the draw's first 4
     ZMWs (ArrowMultiReadScorer per ZMW: fills on K1, interior scores on
     K3, edge pairs refilled on K1), launch counters and quarantine
     events zeroed just before and read just after: the same sequences
     as phase 4's batch results, QVs within 1, K1 and K3 launched, no
     quarantine event; seconds and launches per ZMW;
 10. cli: the 64 ZMWs written as a P6-C4 subread BAM under build/, then
     pbccs_tpu_torch.cli.run([... "--chunkSize", "32"]) on the card
     (two worker threads), counters zeroed just before and read just
     after; its BAM, .pbi and report read back: the records byte-equal
     to process_chunks on the same gated batches (the port's reader and
     CLI gates on that BAM), no Other tally, no quarantine event, K1 and
     K3 launched, yield and mean identity at least phase 4's (within
     CLI_IDENT_SLACK); wall time and peak device memory beside phase
     4's, and the wall of the same run on one worker thread (the same
     BAM bytes), which the work queue's overlap is measured against;
 11. resilience: the CLI of phase 10 on the same subread BAM under the
     resilience and observability tiers, launch counters zeroed and the
     metrics registry windowed around each run, phase 10's records the
     reference: (1) poison, `--faults polish.dispatch:error~<one ZMW>`:
     the other 63 records byte-equal, the ZMW tallied Other (with
     --degradeQuarantined one `df` record, QVs capped), one quarantined
     ZMW; (2) transient, one retried dispatch, every record byte-equal;
     (3) hang, --polishTimeout HANG_TIMEOUT_S with the first dispatch
     delayed past it: one watchdog timeout, every record recovered by
     bisection byte-equal, the abandoned worker joined before the
     counters are read; (4) capacity, a real CUDA OOM on one worker
     thread: the allocator capped between the reserved peaks of a
     16-ZMW and a 32-ZMW pinned dispatch (limit printed), the first
     batch splits and records a ceiling of 16, the second is pre-split
     at admission, nothing quarantined, every record byte-equal; the
     memory allocated when the first half is dispatched printed beside
     the failed attempt's peak; (5) checkpoint/resume, a subprocess run
     at --chunkSize 16 with --checkpoint killed by a workqueue.task
     fault on its third task, then --resume in process: BAM, .pbi and
     report byte-identical to an uninterrupted run at --chunkSize 16,
     chunks restored, fewer K1 launches than the uninterrupted run, the
     journal gone; (6) trace and profile, one run with --trace-out and
     --profile-dir: the spans filter, draft, polish, polish.setup,
     polish.refine, polish.qv and emit, device wait on every polish and
     polish.refine span, the torch.profiler trace naming K1's and K3's
     kernels, the run's wall beside phase 10's and its stage seconds.
     The poison run dumps the flight recorder (ccs_flight_dumps_total
     {reason=quarantine} at least 1, the logged records all
     source "device") and the capacity run once ({reason=oom-ceiling});
 12. ledger: the CLI of phase 10 with --perfLedger on the card, launch
     counters zeroed and the registry windowed around it: one batch_run
     record with platform "gpu" and torch_version, its counter, compile
     and ratio fields equal to the window's, roofline_flops the sum of
     card.flops_for(Z) over the run's setups, 0 < roofline_efficiency
     <= 1, the BAM byte-equal to phase 10's; `ccs roofline --ledger` and
     `--cards` exit 0; then score_read (K1) and score_read_quiver (K2) of
     one 2 kb read on the card against the CPU within SCORE_ATOL, their
     launches counted;
 13. fleet: the CLI of phase 10 on the same BAM through the device fleet
     (`--devices 0`: one worker, cuda:0, prepare threads drafting the
     next batch while the card polishes) at --prepareWorkers 1, 2 and 4,
     counters zeroed and the registry windowed around each run: records,
     .pbi holes and report byte-equal to phase 10's, K1 and K3 launched
     as often as in phase 10, ccs_sched_batches_total 2 and
     ccs_sched_tasks_total{device="cuda:0"} 2, no quarantine; each wall,
     the summed prepare, dispatch and polish stage seconds and the peak
     device memory beside phase 10's default and one-worker walls; then
     `--faults sched.dispatch:oom@1*1` (one capacity requeue on cuda:0,
     one OOM split, records byte-equal), a --memBudget of one batch's
     premarshal_nbytes (at least one throttle, records byte-equal),
     `ccs warmup --bucket 32x10x2000` in a fresh process (one `warmed`
     entry on cuda:0 with its shapes and cost card) between two fresh
     `ccs` processes on the BAM before it and two after it (each BAM
     byte-equal to phase 10's; each wall and its first batch's latency,
     the end of the first polish span from the run's start, read from
     its --trace-out), and one --perfLedger record (sched_batches 2,
     platform gpu);
 14. tune: `ccs tune` on the card in a fresh process (8 ZMWs, 3 passes,
     300 bp, --knobs prepare_workers, --tuneBudget 90, --serveLeg over
     its default grid of five candidates): exit 0, the journal
     holding the defaults run and each candidate, a serve leg whose `ccs
     serve` processes all answered (a candidate rejected only for other
     sequences), and a shipped profile naming this card's device_kind
     and torch_version or the summary's "nothing to ship"; then a profile for this card with
     prepare_workers 2, written by tune.profile.save_profile and applied
     to phase 13's fleet run with --tuneProfile and --perfLedger: its
     record's tuned_profile the profile's id, its records byte-equal to
     phase 10's;
 15. serve: an in-process CcsEngine + CcsServer on cuda:0 (max_batch 32,
     max_wait SERVE_WAIT_MS, one prep thread, --perfLedger) fed phase
     10's gated ZMWs in input order by the port's CcsClient, each
     request's trace id its ZMW id, the launch counters zeroed just
     before and read just after, a span capture started and stopped
     over the wire (`trace` verb): every flush's size, reason and
     (Imax, Jmax, R, Z) from its serve.polish span; each reply's
     consensus fields (sequence, qual, predicted accuracy, passes,
     z-score) byte-equal to polish_prepared_batch on the flush's ZMWs at
     those shapes (the contract: the batcher groups by length bucket,
     so no flush holds one of phase 10's input-order batches), and
     against phase 10's record the same sequence with QVs within 1 (the
     count that differ in bytes printed); the status verb
     and the engine's serve_snapshot ledger record; peak device memory;
     then the same ZMWs again to the warm server (byte-equal to the
     first pass), each pass's first-reply latency and its client-side
     and ccs_serve_request_latency_seconds p50/p99 beside phase 13's
     fresh-process first batches.  Then `python -m pbccs_tpu_torch.cli
     serve --port 0 --metricsPort -1 --perfLedger ...` (max_batch 4):
     CCS-SERVE-READY, 4 ZMWs of one length bucket byte-equal to an
     in-process max_batch 4 server's, /metrics and /healthz scraped,
     SIGTERM with a request in flight: CCS-SERVE-DRAINING, the request
     answered, exit 0, a final serve_snapshot record; and
     `PBCCS_BAND_W=80 ... serve` exiting 2 with the allowed widths
     named.
Then each phase's seconds as one JSON line, the card's name and power
limit, the kernel table as one JSON line, and as the last line
{"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX."""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
TPL_LEN = 2000
PASSES = (3, 10)
N_ZMWS = 64
BATCH = 32
N_CROSS = 4
N_QUIVER = 4
N_SERIAL = 4
QUIVER_SMALL = (300, 5)     # template length, passes of the card-vs-CPU ZMW


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def simulate_chunks(rng, n: int, tpl_len: int, passes: tuple[int, int]):
    """n simulated ZMWs (full-pass subreads, alternating strands)."""
    from pbccs_tpu_torch.pipeline import Chunk, Subread
    from pbccs_tpu_torch.simulate import simulate_zmw

    chunks, truths = [], []
    for z in range(n):
        npass = int(rng.integers(passes[0], passes[1] + 1))
        tpl, reads, _, snr = simulate_zmw(rng, tpl_len, npass)
        chunks.append(Chunk(f"smoke/{z}", [Subread(f"smoke/{z}/{i}", r)
                                           for i, r in enumerate(reads)],
                            snr))
        truths.append(tpl)
    return chunks, truths


def edit_distance(a: str, b: str) -> int:
    """Global Levenshtein distance (Myers / Hyyro bit-parallel)."""
    m = len(a)
    if m == 0:
        return len(b)
    peq: dict[str, int] = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    mask = (1 << m) - 1
    high = 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score


def identity(seq: str, tpl: np.ndarray) -> float:
    """1 - edit distance / template length, best strand."""
    from pbccs_tpu_torch.models.arrow.params import decode_bases, revcomp

    fwd, rev = decode_bases(tpl), decode_bases(revcomp(tpl))
    d = min(edit_distance(fwd, seq), edit_distance(rev, seq))
    return 1.0 - d / len(tpl)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches (after one warm-up),
    by CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_build() -> dict:
    from pbccs_tpu_torch import native
    from pbccs_tpu_torch.ops import cuda_lib

    t0 = time.monotonic()
    log = cuda_lib.build(cuda_lib.KERNELS, force=True)
    for name in cuda_lib.KERNELS:
        cuda_lib.load(name)
    t1 = time.monotonic()
    native_ok = native.available()
    out = {"phase": "build", "card": card_line(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "build_s": t1 - t0,
           "native_draft_library": native_ok,
           "native_build_s": time.monotonic() - t1,
           "nvcc_s": {n: log[n]["seconds"] for n in cuda_lib.KERNELS},
           "ptxas": {n: [ln.strip() for ln in log[n]["output"].splitlines()
                         if "registers" in ln or "spill" in ln
                         or "smem" in ln or "entry function" in ln]
                     for n in cuda_lib.KERNELS}}
    emit(out)
    return out


def kernel_fixture(chunks, device):
    """Main-path-shaped fill inputs: one batch's ZMWs (true templates as
    drafts, full-window reads) through the BatchPolisher setup."""
    from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask

    tasks = [ZmwTask(c.id, truth, c.snr, [r.seq for r in c.reads],
                     [i % 2 for i in range(len(c.reads))],
                     [0] * len(c.reads), [len(truth)] * len(c.reads))
             for c, truth in chunks]
    pol = BatchPolisher(tasks, device=device)
    s = pol._state
    ZR = pol._Z * pol._R
    flat = lambda a: a.reshape((ZR,) + a.shape[2:])  # noqa: E731
    tables = flat(pol._tables_dev[:, None].expand(
        (pol._Z, pol._R) + pol._tables_dev.shape[1:]))
    return dict(reads=flat(pol._reads_dev), rlens=flat(pol._rlens_dev),
                win_tpl=flat(s.win_tpl), win_trans=flat(s.win_trans),
                wlens=flat(s.wlens), tables=tables, W=pol._W,
                shape=dict(Z=pol._Z, R=pol._R, Jmax=pol._Jmax,
                           Imax=pol._Imax))


def _bound(work):
    """(bound ms, bound_by, bytes, (integer ops, float32 ops)) of a work
    count (obs/roofline.py: bytes at the H100's HBM rate against the
    operations, whose integer and float32 pipes issue side by side)."""
    from pbccs_tpu_torch.obs.roofline import bound_seconds

    n_bytes, n_int, n_f32 = work
    t, by = bound_seconds(n_bytes, n_int, n_f32)
    return t * 1e3, by, n_bytes, (n_int, n_f32)


def k1_bound(reads, tpls, W: int, dirs):
    """The bound of one K1 launch over the directions `dirs` (False
    forward, True backward) on these reads and template windows
    (roofline.k1_work: each input read once, each output written once,
    the operations per lane of every column by type)."""
    from pbccs_tpu_torch.obs.roofline import k1_work

    R, Imax = reads.shape
    return _bound(k1_work(R, Imax, tpls.shape[1], W, dirs))


def timed(fn):
    """(fn(), its milliseconds by CUDA events) of one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


#: the launches phase 2 times: directions of each
K1_MODES = {"fused": (False, True), "forward": (False,), "backward": (True,)}


def phase_fill(fx) -> dict:
    from pbccs_tpu_torch.ops import fwdbwd_cuda as fc
    from pbccs_tpu_torch.ops.fwdbwd import BandedMatrix, band_offsets

    reads = fx["reads"].to(torch.int8).contiguous()
    rlens = fx["rlens"].to(torch.int32).contiguous()
    tpls = fx["win_tpl"].to(torch.int8).contiguous()
    trans = fx["win_trans"].float().contiguous()
    J = fx["wlens"].to(torch.int32).contiguous()
    R, Jmax = tpls.shape
    nc = Jmax + 1
    rows, kept = [], {}
    launches0 = fc.arrow_fill.launches
    for W in (fx["W"], 2 * fx["W"]):
        offsets = band_offsets(rlens, J, nc, W)
        args = (reads, rlens, tpls, trans, J, offsets, W,
                fc.MISMATCH_PROBABILITY)

        def loglik(d, v, ls):
            bm = BandedMatrix(v, offsets, ls)
            return (fc.backward_loglik_batch(bm, J) if d
                    else fc.forward_loglik_batch(bm, rlens, J))

        plain, plain_ms = {}, {}
        for d in (False, True):
            out, plain_ms[d] = timed(lambda: fc.arrow_fill_plain(
                *args, alpha=not d, beta=d))
            plain[d] = out[d]
        for mode, dirs in K1_MODES.items():
            call = lambda: fc.arrow_fill(  # noqa: E731
                *args, alpha=False in dirs, beta=True in dirs)
            got = call()
            torch.cuda.synchronize()
            vals_bitwise = all(torch.equal(got[d][0], plain[d][0])
                               for d in dirs)
            ls_bitwise = all(torch.equal(got[d][1], plain[d][1])
                             for d in dirs)
            ls_rel = max(float(((got[d][1] - plain[d][1]).abs()
                                / plain[d][1].abs().clamp(min=1e-30)).max())
                         for d in dirs)
            ll_err = max(float((loglik(d, *got[d]) - loglik(d, *plain[d]))
                               .abs().max()) for d in dirs)
            if mode == "fused":
                kept[W] = (BandedMatrix(got[0][0], offsets, got[0][1]),
                           BandedMatrix(got[1][0], offsets, got[1][1]))
            del got
            ms = cuda_ms(call, 5)
            b_ms, b_by, n_bytes, n_ops = k1_bound(reads, tpls, W, dirs)
            row = {"W": W, "mode": mode, "vals_bitwise": vals_bitwise,
                   "ls_bitwise": ls_bitwise, "ls_max_rel_err": ls_rel,
                   "ll_max_abs_err": ll_err, "ms": ms,
                   "plain_ms": sum(plain_ms[d] for d in dirs),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                   "ops": n_ops}
            rows.append(row)
            if not vals_bitwise or ls_rel > 1e-6 or ll_err > 1e-4:
                raise AssertionError(f"arrow_fill disagrees with its plain "
                                     f"version: {row}")
        del plain
    out = {"phase": "arrow_fill", "reads": R, "nc": nc, "rows": rows,
           "launches": fc.arrow_fill.launches - launches0}
    emit(out)
    return out, kept


def k3_bound(R: int, nc: int, Imax: int, Jm: int, W: int,
             positions: int | None = None, blocks: int | None = None):
    """The bound of K3 over `positions` scored (read, position) cells in
    `blocks` live (read, 64-position) blocks, default all
    (roofline.k3_work)."""
    from pbccs_tpu_torch.obs.roofline import k3_work

    return _bound(k3_work(R, nc, Imax, Jm, W, positions, blocks))


def k1_fills(fx, W: int):
    """K1's fused alpha and beta fills of the fixture at band width W, as
    two BandedMatrix."""
    from pbccs_tpu_torch.ops import fwdbwd_cuda as fc
    from pbccs_tpu_torch.ops.fwdbwd import BandedMatrix, band_offsets

    rlens = fx["rlens"].to(torch.int32).contiguous()
    J = fx["wlens"].to(torch.int32).contiguous()
    offsets = band_offsets(rlens, J, fx["win_tpl"].shape[1] + 1, W)
    got = fc.arrow_fill(fx["reads"].to(torch.int8).contiguous(), rlens,
                        fx["win_tpl"].to(torch.int8).contiguous(),
                        fx["win_trans"].float().contiguous(), J, offsets, W,
                        fc.MISMATCH_PROBABILITY)
    return tuple(BandedMatrix(got[d][0], offsets, got[d][1]) for d in (0, 1))


def phase_dense(fx, kept) -> dict:
    """K3 against its plain version on phase 2's fused fills at both of
    its widths, and on K1's fills at W = 256 (the 2x retry of an explicit
    band_width of 128; K1 there is held against its plain version by the
    GPU tests): all blocks live, and half the 64-position blocks dead."""
    from pbccs_tpu_torch.ops import dense_score_cuda as ds
    from pbccs_tpu_torch.ops import fwdbwd_cuda as fc
    from pbccs_tpu_torch.ops.mutation_score import scale_prefix, scale_suffix

    R, Jm = fx["win_tpl"].shape
    Imax = fx["reads"].shape[1]
    nc = Jm + 1
    NB = -(-Jm // ds.PB)
    i32 = torch.int32
    dev = fx["reads"].device
    p = torch.arange(Jm, device=dev)[None, :, None]
    endoff = torch.as_tensor([1, 1, 1, 1, 0, 0, 0, 0, 1], device=dev)
    J = fx["wlens"].to(torch.int64)[:, None, None]
    interior = (p >= 3) & (p + endoff <= J - 2)
    all_live = torch.ones(R, NB, dtype=i32, device=dev)
    blk = torch.arange(NB, device=dev)
    # runs of four 64-position blocks dead and live in turn, as a late
    # refinement round's neighbourhoods leave them
    half = ((torch.arange(R, device=dev)[:, None] + blk // 4) % 2).to(i32)
    dead_pos = (half[:, torch.arange(Jm, device=dev) // ds.PB] == 0)
    rows = []
    launches0 = ds.dense_score.launches
    for W in dict.fromkeys((fx["W"], 2 * fx["W"], max(ds.K3_WIDTHS))):
        alpha, beta = kept[W] if W in kept else k1_fills(fx, W)
        base = (alpha.vals, beta.vals, alpha.offsets.to(i32).contiguous(),
                scale_prefix(alpha.log_scales).contiguous(),
                scale_suffix(beta.log_scales).contiguous(),
                fx["reads"].to(torch.int8).contiguous(),
                fx["rlens"].to(i32).contiguous(),
                fx["win_tpl"].to(torch.int8).contiguous(),
                fx["wlens"].to(i32).contiguous(),
                fx["win_trans"].float().contiguous(),
                fx["tables"].float().contiguous())
        for mode, live in (("all_live", all_live), ("half_dead", half)):
            args = base + (live,)
            got = ds.dense_score(*args)
            want, plain_ms = timed(lambda: ds.dense_score_plain(*args))
            torch.cuda.synchronize()
            err = (got - want).abs()
            rel = err / want.abs().clamp(min=1e-30)
            max_rel = float(torch.where(interior, rel, 0.0).max())
            max_abs = float(torch.where(interior, err, 0.0).max())
            dead_zero = (bool((got[dead_pos] == 0).all())
                         if mode == "half_dead" else None)
            ms = cuda_ms(lambda: ds.dense_score(*args), 3)
            n_pos = int((~dead_pos).sum()) if mode == "half_dead" else None
            n_blk = int(live.sum()) if mode == "half_dead" else None
            b_ms, b_by, n_bytes, n_ops = k3_bound(R, nc, Imax, Jm, W, n_pos,
                                                  n_blk)
            row = {"W": W, "mode": mode, "interior_slots": int(interior.sum()),
                   "bitwise": bool(torch.equal(got, want)),
                   "interior_bitwise": bool(torch.equal(got[interior],
                                                        want[interior])),
                   "max_rel_err": max_rel, "max_abs_err": max_abs,
                   "dead_blocks_zero": dead_zero, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "bytes": n_bytes, "ops": n_ops}
            rows.append(row)
            del got, want, err, rel
            if max_rel > 1e-6 or dead_zero is False:
                raise AssertionError(f"dense_score disagrees with its plain "
                                     f"version: {row}")
    # PyTorch's CUDA division by a Python scalar multiplies by the rounded
    # reciprocal: the batch's distinct stick values whose stick / 3 it
    # rounds otherwise than the IEEE divide of the kernels and of
    # fwdbwd_cuda._third, which the plain versions now take
    sticks = torch.unique(torch.cat([fx["tables"][..., 2].reshape(-1),
                                     fx["win_trans"][..., 2].reshape(-1)]))
    scalar_div_off = int((sticks / 3.0 != fc._third(sticks)).sum())
    out = {"phase": "dense_score", "reads": R, "Jm": Jm, "rows": rows,
           "launches": ds.dense_score.launches - launches0,
           "stick_values": int(sticks.numel()),
           "stick_third_scalar_divide_differs": scalar_div_off}
    emit(out)
    return out


def phase_main(chunks, truths) -> dict:
    from pbccs_tpu_torch.ops import dense_score_cuda as ds
    from pbccs_tpu_torch.ops import fwdbwd_cuda as fc
    from pbccs_tpu_torch.pipeline import Failure, ResultTally, process_chunks

    # the plain versions' operand planes, counted: K1 builds its
    # coefficients and K3 its read windows and patch rows in the kernel,
    # and the edge programs and refills build only the columns and rows
    # they read, so the card's path must build no full plane
    planes = {"k1_coefficients": 0, "read_windows": 0, "patch_grids": 0}
    dense_score, k3_batch = ds.dense_score, ds.dense_interior_scores_batch
    # per K3 launch: its shape and, as device scalars, its live (read,
    # 64-position) blocks and the positions they hold
    k3_calls = []

    def counted(key, fn, subset=None):
        # a plane builder counts when it leaves its column / position
        # list `subset` at None, however its arguments are passed
        sig = inspect.signature(fn)

        def wrapper(*args, **kwargs):
            if (subset is None or sig.bind(*args, **kwargs)
                    .arguments.get(subset) is None):
                planes[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    def k3_counted(*args, **kwargs):
        reads, win_tpl, alpha = args[0], args[2], args[6]
        live = args[11] if len(args) > 11 else kwargs.get("live")
        R, nc, W = alpha.vals.shape
        Jm = win_tpl.shape[1]
        NB = -(-Jm // ds.PB)
        per_block = (Jm - torch.arange(NB, device=reads.device)
                     * ds.PB).clamp(max=ds.PB)
        on = (torch.ones(R, NB, dtype=torch.bool, device=reads.device)
              if live is None else live != 0)
        k3_calls.append(((R, nc, reads.shape[1], Jm, W), on.sum(),
                         (on * per_block).sum()))
        return k3_batch(*args, **kwargs)

    originals = (fc._forward_coeffs, fc._backward_coeffs,
                 ds.band_read_windows, ds.dense_patch_grids,
                 ds.dense_interior_scores_batch)
    fc._forward_coeffs = counted("k1_coefficients", originals[0])
    fc._backward_coeffs = counted("k1_coefficients", originals[1])
    ds.band_read_windows = counted("read_windows", originals[2], "cols")
    ds.dense_patch_grids = counted("patch_grids", originals[3], "pos")
    ds.dense_interior_scores_batch = k3_counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.arrow_fill.launches = 0
    dense_score.launches = 0
    t0 = time.monotonic()
    tally = ResultTally()
    try:
        for lo in range(0, len(chunks), BATCH):
            tally.merge(process_chunks(chunks[lo: lo + BATCH],
                                       device="cuda"))
        torch.cuda.synchronize()
    finally:
        (fc._forward_coeffs, fc._backward_coeffs, ds.band_read_windows,
         ds.dense_patch_grids, ds.dense_interior_scores_batch) = originals
    wall = time.monotonic() - t0
    launches = {"arrow_fill": fc.arrow_fill.launches,
                "dense_score": dense_score.launches}
    # K3's path bound: its bound on the blocks each launch really scored
    blocks = positions = all_blocks = 0
    path_bound = 0.0
    for (R, nc, Imax, Jm, W), n_blk, n_pos in k3_calls:
        n_blk, n_pos = int(n_blk), int(n_pos)
        blocks += n_blk
        positions += n_pos
        all_blocks += R * -(-Jm // ds.PB)
        path_bound += k3_bound(R, nc, Imax, Jm, W, n_pos, n_blk)[0]
    truth = {c.id: t for c, t in zip(chunks, truths)}
    idents = [identity(r.sequence, truth[r.id]) for r in tally.results]
    out = {"phase": "main_path", "zmws": len(chunks), "batch": BATCH,
           "tally": {f.value: c for f, c in tally.counts.items() if c},
           "yield": len(tally.results) / len(chunks),
           "identity_mean": float(np.mean(idents)) if idents else None,
           "identity_min": float(np.min(idents)) if idents else None,
           "exact": int(sum(i == 1.0 for i in idents)),
           "wall_s": wall, "zmw_per_s": len(chunks) / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "full_planes_built": planes,
           "k3_live_blocks": blocks, "k3_blocks": all_blocks,
           "k3_live_positions": positions, "k3_path_bound_ms": path_bound}
    emit(out)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    if any(planes.values()):
        raise AssertionError(f"the main path built full planes: {planes}")
    if tally.counts[Failure.OTHER]:
        raise AssertionError("main path tallied ZMWs as Other")
    if tally.total != len(chunks):
        raise AssertionError(f"tally counts {tally.total} of {len(chunks)}")
    return out, tally


def phase_cross(chunks) -> dict:
    from pbccs_tpu_torch.pipeline import process_chunks

    t0 = time.monotonic()
    gpu = process_chunks(chunks, device="cuda")
    t1 = time.monotonic()
    cpu = process_chunks(chunks, device="cpu")
    t2 = time.monotonic()
    a = {r.id: r for r in gpu.results}
    b = {r.id: r for r in cpu.results}
    same_ids = sorted(a) == sorted(b)
    seq_same = same_ids and all(a[k].sequence == b[k].sequence for k in a)
    qv_diff = max((int(np.abs(a[k].qvs.astype(np.int64)
                              - b[k].qvs.astype(np.int64)).max())
                   for k in a if k in b
                   and len(a[k].qvs) == len(b[k].qvs)), default=0)
    out = {"phase": "cross_device", "zmws": len(chunks),
           "results_cuda": len(a), "results_cpu": len(b),
           "same_sequences": seq_same, "qv_max_abs_diff": qv_diff,
           "cuda_s": t1 - t0, "cpu_s": t2 - t1}
    emit(out)
    if not seq_same or qv_diff > 1 or not a:
        raise AssertionError("card and CPU disagree on the cross-device ZMWs")
    return out


#: rows of PR 2's K2 fill batch (2^26 cells // (2002 columns x 96 lanes)):
#: the shape at which phase 6 holds K2 against its plain version
K2_CHECK_ROWS = 349
#: rows of the scorer's batch held against the plain version: the first
#: and last K2_SAMPLE_EDGE and every (R // K2_SAMPLE_STRIDE)-th
K2_SAMPLE_EDGE, K2_SAMPLE_STRIDE = 64, 256
def quiver_fixture(chunk, truth, device):
    """K2 inputs at the Quiver path's shapes: a QuiverMultiReadScorer over
    one ZMW (its true template as the draft, flat default QV tracks) and
    single-mutation windows spread over the template.  "check": the
    first read against K2_CHECK_ROWS windows.  "batch": the forward-strand
    reads (one window geometry, as _fill_lls_group groups them) against
    enough windows for one batch of the scorer's _chunk rows, read-major."""
    from pbccs_tpu_torch.models.arrow import mutations as mutlib
    from pbccs_tpu_torch.models.quiver.features import flat_default_features
    from pbccs_tpu_torch.models.quiver.scorer import QuiverMultiReadScorer

    n, L = len(chunk.reads), len(truth)
    scorer = QuiverMultiReadScorer(
        truth, [flat_default_features(r.seq) for r in chunk.reads],
        [i % 2 for i in range(n)], [0] * n, [L] * n, device=device)
    muts = mutlib.enumerate_unique(truth)
    dev = scorer.device

    def rows(n_wins, reads, n_rows):
        pick = np.linspace(0, len(muts) - 1, n_wins).round().astype(np.int64)
        tw, wl = scorer._windows([mutlib.apply_mutations(truth, [muts[k]])
                                  for k in pick])
        rr = np.repeat(np.asarray(reads, np.int32), n_wins)[:n_rows]
        rw = np.tile(np.arange(n_wins, dtype=np.int32), len(reads))[:n_rows]
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        return dict(wins=tw, wlens=wl, row_read=t(rr), row_win=t(rw))

    group = list(range(0, n, 2))
    # the longest windows, an insertion's, are one column past the template
    big = scorer._chunk(L + 1)
    return dict(tables=scorer._tables, rlens=scorer._rlens,
                config=scorer.config, W=scorer._W,
                check=rows(K2_CHECK_ROWS, [0], K2_CHECK_ROWS),
                batch=rows(-(-big // len(group)), group, big))


def k2_bound(qx, rows, vals: bool):
    """The bound of one K2 launch over `rows` (roofline.k2_work): the
    tables of the reads the rows name, every column in the band-value
    mode (`vals`), J + 1 per row in the log-likelihood-only mode."""
    from pbccs_tpu_torch.obs.roofline import k2_work

    R = rows["row_read"].shape[0]
    M, Jmax = rows["wins"].shape
    n_tab = int(torch.unique(rows["row_read"]).numel())
    J = rows["wlens"][rows["row_win"].long()]
    cols = R * (Jmax + 1) if vals else int((J + 1).sum())
    return _bound(k2_work(R, M, Jmax, qx["W"], n_tab, qx["tables"].shape[1],
                          cols, vals))


def phase_quiver_fill(qx) -> dict:
    from pbccs_tpu_torch.models.quiver import fill as qf
    from pbccs_tpu_torch.ops import quiver_fill_cuda as qk
    from pbccs_tpu_torch.ops.fwdbwd import band_offsets

    W = qx["W"]
    merge = qf._use_merge(qx["config"])

    def args(rows):
        I = qx["rlens"][rows["row_read"].long()]
        J = rows["wlens"][rows["row_win"].long()]
        offsets = band_offsets(I, J, rows["wins"].shape[1] + 1, W)
        return (qx["tables"], qx["rlens"], rows["wins"], rows["wlens"],
                rows["row_read"], rows["row_win"], offsets, W, merge), J

    out_rows = []
    launches0 = qk.quiver_fill.launches
    chk, J = args(qx["check"])
    for backward in (False, True):
        vk, lk, fk = qk.quiver_fill(*chk, backward)
        _, lb, fb = qk.quiver_fill(*chk, backward, vals=False)
        vp, lp, fp = qk.quiver_fill_plain(*chk, backward)
        torch.cuda.synchronize()
        ll_err = float((qf._loglik(fk, lk, J) - qf._loglik(fp, lp, J))
                       .abs().max())
        rel = float(((vk - vp).abs() / vp.abs().clamp(min=1e-30)).max())
        modes_equal = bool(torch.equal(lk, lb) and torch.equal(fk, fb))
        ms = cuda_ms(lambda: qk.quiver_fill(*chk, backward), 5)
        ll_ms = cuda_ms(lambda: qk.quiver_fill(*chk, backward, vals=False), 5)
        plain_ms = cuda_ms(lambda: qk.quiver_fill_plain(*chk, backward), 1)
        b_ms, b_by, n_bytes, n_ops = k2_bound(qx, qx["check"], True)
        lb_ms, lb_by, _, _ = k2_bound(qx, qx["check"], False)
        row = {"shape": "check", "W": W, "backward": backward,
               "rows": int(J.numel()), "nc": chk[2].shape[1] + 1,
               "ll_max_abs_err": ll_err, "vals_max_rel_err": rel,
               "ll_mode_bitwise": modes_equal, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
               "ops": n_ops, "ll_mode_ms": ll_ms, "ll_mode_bound_ms": lb_ms,
               "ll_mode_bound_by": lb_by}
        out_rows.append(row)
        if ll_err > 1e-4 or rel > 1e-5 or not modes_equal:
            raise AssertionError(f"quiver_fill disagrees with its plain "
                                 f"version or across its modes: {row}")
        del vk, vp
    big, J = args(qx["batch"])
    R = J.numel()
    idx = torch.unique(torch.cat([
        torch.arange(min(K2_SAMPLE_EDGE, R)),
        torch.arange(max(0, R - K2_SAMPLE_EDGE), R),
        torch.arange(0, R, max(1, R // K2_SAMPLE_STRIDE))])).to(J.device)
    # the sampled rows as a fill of their own: same tables, windows and
    # band offsets (the batch's column count), so the plain version's
    # planes stay at a few hundred rows
    sub = big[:4] + (big[4][idx], big[5][idx], big[6][idx]) + big[7:]
    reads_covered = bool(torch.equal(torch.unique(big[4][idx]),
                                     torch.unique(big[4])))
    for backward in (False, True):
        _, lk, fk = qk.quiver_fill(*big, backward, vals=False)
        _, lp, fp = qk.quiver_fill_plain(*sub, backward, vals=False)
        torch.cuda.synchronize()
        ll_err = float((qf._loglik(fk[idx], lk[idx], J[idx])
                        - qf._loglik(fp, lp, J[idx])).abs().max())
        ls_err = float((lk[idx] - lp).abs().max())
        ms = cuda_ms(lambda: qk.quiver_fill(*big, backward, vals=False), 3)
        sample_ms = cuda_ms(lambda: qk.quiver_fill(*sub, backward,
                                                   vals=False), 3)
        plain_ms = cuda_ms(lambda: qk.quiver_fill_plain(*sub, backward,
                                                        vals=False), 1)
        b_ms, b_by, n_bytes, n_ops = k2_bound(qx, qx["batch"], False)
        row = {"shape": "batch", "W": W, "backward": backward, "rows": R,
               "nc": big[2].shape[1] + 1, "ll_mode_ms": ms,
               "us_per_row": 1e3 * ms / R, "ll_mode_bound_ms": b_ms,
               "ll_mode_bound_by": b_by, "bytes": n_bytes, "ops": n_ops,
               "checked_rows": int(idx.numel()),
               "checked_reads_cover_group": reads_covered,
               "ll_max_abs_err": ll_err, "ls_max_abs_err": ls_err,
               "checked_rows_ms": sample_ms, "plain_ms": plain_ms}
        out_rows.append(row)
        if ll_err > 1e-4 or ls_err > 1e-5 or not reads_covered:
            raise AssertionError(f"quiver_fill disagrees with its plain "
                                 f"version at the scorer's batch: {row}")
    out = {"phase": "quiver_fill", "rows": out_rows,
           "launches": qk.quiver_fill.launches - launches0}
    emit(out)
    return out


def _launch_counts() -> dict:
    from pbccs_tpu_torch.ops.dense_score_cuda import dense_score
    from pbccs_tpu_torch.ops.fwdbwd_cuda import arrow_fill
    from pbccs_tpu_torch.ops.quiver_fill_cuda import quiver_fill

    return {"arrow_fill": arrow_fill.launches,
            "quiver_fill": quiver_fill.launches,
            "dense_score": dense_score.launches}


def _zero_launch_counts() -> None:
    from pbccs_tpu_torch.ops.dense_score_cuda import dense_score
    from pbccs_tpu_torch.ops.fwdbwd_cuda import arrow_fill
    from pbccs_tpu_torch.ops.quiver_fill_cuda import quiver_fill

    arrow_fill.launches = quiver_fill.launches = dense_score.launches = 0


def _same_results(a, b) -> tuple[bool, int]:
    """(same ids, tallies and sequences; max QV difference)."""
    ra = {r.id: r for r in a.results}
    rb = {r.id: r for r in b.results}
    same = (sorted(ra) == sorted(rb) and a.counts == b.counts
            and all(ra[k].sequence == rb[k].sequence for k in ra))
    qv = max((int(np.abs(ra[k].qvs.astype(np.int64)
                         - rb[k].qvs.astype(np.int64)).max())
              for k in ra if k in rb and len(ra[k].qvs) == len(rb[k].qvs)),
             default=0)
    return same, qv


def phase_quiver(chunks, truths, small) -> dict:
    from pbccs_tpu_torch.pipeline import (ConsensusSettings, Failure,
                                          process_chunks)

    settings = ConsensusSettings(model="quiver")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.monotonic()
    tally = process_chunks(chunks, settings, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    truth = {c.id: t for c, t in zip(chunks, truths)}
    idents = [identity(r.sequence, truth[r.id]) for r in tally.results]

    t1 = time.monotonic()
    gpu = process_chunks(small, settings, device="cuda")
    t2 = time.monotonic()
    cpu = process_chunks(small, settings, device="cpu")
    t3 = time.monotonic()
    same, qv_diff = _same_results(gpu, cpu)
    out = {"phase": "quiver_path", "zmws": len(chunks),
           "tally": {f.value: c for f, c in tally.counts.items() if c},
           "yield": len(tally.results) / len(chunks),
           "identity_mean": float(np.mean(idents)) if idents else None,
           "identity_min": float(np.min(idents)) if idents else None,
           "exact": int(sum(i == 1.0 for i in idents)),
           "wall_s": wall, "zmw_per_s": len(chunks) / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "small": {"tpl_len": QUIVER_SMALL[0], "passes": QUIVER_SMALL[1],
                     "tally": {f.value: c for f, c in gpu.counts.items()
                               if c},
                     "same_sequences": same, "qv_max_abs_diff": qv_diff,
                     "cuda_s": t2 - t1, "cpu_s": t3 - t2}}
    emit(out)
    if launches["quiver_fill"] <= 0:
        raise AssertionError("the Quiver path did not launch K2")
    if tally.counts[Failure.OTHER] or tally.total != len(chunks):
        raise AssertionError(f"Quiver tally {out['tally']} of {len(chunks)}")
    if not same or qv_diff > 1 or not gpu.results:
        raise AssertionError("card and CPU disagree on the small Quiver ZMW")
    return out


def fallback_tasks(rng):
    """(name, ZmwTask) of the two cases the JAX device loop hands to its
    host loop: a read clipped to a 6-column window, and a draft missing
    every fifth base of its 300 bp truth (it outgrows its bucket)."""
    from pbccs_tpu_torch.parallel.batch import ZmwTask
    from pbccs_tpu_torch.simulate import simulate_zmw

    tpl, reads, strands, snr = simulate_zmw(rng, 60, 5)
    reads = list(reads)
    reads[1] = reads[1][:6]
    tends = [len(tpl)] * 5
    tends[1] = 6
    tiny = ZmwTask("tiny", tpl, snr, reads, strands, [0] * 5, tends)
    tpl, reads, strands, snr = simulate_zmw(rng, 300, 5)
    draft = np.delete(tpl, np.arange(4, len(tpl), 5))
    grow = ZmwTask("grow", draft, snr, reads, strands, [0] * 5,
                   [len(draft)] * 5)
    return [("tiny_window", tiny), ("bucket_growth", grow)]


def phase_fallbacks(rng) -> dict:
    from pbccs_tpu_torch.ops.fwdbwd_cuda import arrow_fill
    from pbccs_tpu_torch.parallel import device_refine as dr
    from pbccs_tpu_torch.parallel.batch import (MIN_FAST_EDGE_WLEN,
                                                BatchPolisher)

    rows = []
    for name, task in fallback_tasks(rng):
        got = {}
        for dev in ("cuda", "cpu"):
            t0 = time.monotonic()
            pol = BatchPolisher([task], device=dev)
            j0 = pol._Jmax
            st = pol._state
            arrow_fill.launches = 0
            dr.score_slot_grid(st, pol._reads_dev, pol._rlens_dev,
                               pol._strands_dev, pol._tables_dev,
                               pol._real_dev, *dr.slot_grid(j0, st.tpl.device),
                               dr.slot_candidates(st.tpl, st.tlens),
                               min_fast_edge=MIN_FAST_EDGE_WLEN)
            refills = arrow_fill.launches
            res = pol.refine()[0]
            qvs = pol.consensus_qvs()[0]
            got[dev] = dict(tpl=pol.tpls[0], res=vars(res), qvs=qvs,
                            jmax=(j0, pol._Jmax), refill_launches=refills,
                            s=time.monotonic() - t0)
        a, b = got["cuda"], got["cpu"]
        same = (np.array_equal(a["tpl"], b["tpl"]) and a["res"] == b["res"]
                and len(a["qvs"]) == len(b["qvs"]))
        qv_diff = int(np.abs(a["qvs"].astype(np.int64)
                             - b["qvs"].astype(np.int64)).max()) if same \
            else None
        rows.append({"task": name, "same": same, "qv_max_abs_diff": qv_diff,
                     "result": a["res"], "jmax": a["jmax"],
                     "k1_refill_launches": a["refill_launches"],
                     "cuda_s": a["s"], "cpu_s": b["s"]})
    out = {"phase": "refine_fallbacks", "tasks": rows}
    emit(out)
    for r in rows:
        if not r["same"] or r["qv_max_abs_diff"] > 1:
            raise AssertionError(f"card and CPU disagree on {r['task']}")
    tiny, grow = rows
    if tiny["k1_refill_launches"] <= 0:
        raise AssertionError("the tiny window's refills did not launch K1")
    if grow["jmax"][1] <= grow["jmax"][0]:
        raise AssertionError(f"the bucket did not grow: {grow['jmax']}")
    return out


def _quarantine_events() -> dict:
    from pbccs_tpu_torch.resilience import quarantine

    return quarantine.event_counts()


def _check_no_quarantine(where: str, events: dict) -> None:
    if any(events.values()):
        raise AssertionError(f"{where}: quarantine events {events}")


def phase_serial(chunks, truths, batch_tally) -> dict:
    """The serial Arrow path (ArrowMultiReadScorer per ZMW) on the card
    against phase 4's batch results for the same ZMWs."""
    from pbccs_tpu_torch.pipeline import Failure, process_chunks
    from pbccs_tpu_torch.resilience import quarantine

    quarantine.reset_event_counts()
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.monotonic()
    tally = process_chunks(chunks, batch_polish=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    events = _quarantine_events()
    ids = {c.id for c in chunks}
    batch = {r.id: r for r in batch_tally.results if r.id in ids}
    serial = {r.id: r for r in tally.results}
    same_ids = sorted(batch) == sorted(serial)
    same_seq = same_ids and all(serial[k].sequence == batch[k].sequence
                                for k in serial)
    qv_diff = max((int(np.abs(serial[k].qvs.astype(np.int64)
                              - batch[k].qvs.astype(np.int64)).max())
                   for k in serial if k in batch
                   and len(serial[k].qvs) == len(batch[k].qvs)), default=0)
    truth = {c.id: t for c, t in zip(chunks, truths)}
    out = {"phase": "serial", "zmws": len(chunks),
           "tally": {f.value: c for f, c in tally.counts.items() if c},
           "s_per_zmw": wall / len(chunks), "wall_s": wall,
           "launches": launches,
           "launches_per_zmw": {k: v / len(chunks)
                                for k, v in launches.items()},
           "same_sequences_as_batch": same_seq,
           "qv_max_abs_diff_vs_batch": qv_diff,
           "identity": [identity(r.sequence, truth[r.id])
                        for r in tally.results],
           "quarantine_events": events}
    emit(out)
    if launches["arrow_fill"] <= 0 or launches["dense_score"] <= 0:
        raise AssertionError(f"the serial path did not launch K1 and K3: "
                             f"{launches}")
    _check_no_quarantine("serial", events)
    if tally.counts[Failure.OTHER] or not serial:
        raise AssertionError(f"serial tally {out['tally']}")
    if not same_seq or qv_diff > 1:
        raise AssertionError("the serial path disagrees with phase 4's "
                             "batch results")
    return out


#: the read group of the CLI phase's subread BAM: P6-C4 (the chemistry
#: the CLI's gate accepts)
CLI_MOVIE = "m140905_042212_sidney_c100564852550000001823085912221377_s1_X0"
CLI_CHUNK = 32
#: mean identity the CLI may lose against phase 4: 0.1 base per 2 kb ZMW
CLI_IDENT_SLACK = 5e-5


def write_subread_bam(path: str, chunks) -> None:
    """The simulated ZMWs as a PacBio subread BAM (one P6-C4 read group,
    hole numbers 0..n-1, full-pass context flags, per-ZMW `sn`)."""
    from pbccs_tpu_torch.io.bam import (BamHeader, BamRecord, BamWriter,
                                        ReadGroupInfo, make_read_group_id)
    from pbccs_tpu_torch.models.arrow.params import decode_bases

    header = BamHeader(read_groups=[ReadGroupInfo(
        CLI_MOVIE, "SUBREAD", binding_kit="100356300",
        sequencing_kit="100356200", basecaller_version="2.3.0")])
    rg = make_read_group_id(CLI_MOVIE, "SUBREAD")
    with BamWriter(path, header) as bw:
        for hole, chunk in enumerate(chunks):
            start = 0
            for read in chunk.reads:
                end = start + len(read.seq)
                bw.write(BamRecord(
                    name=f"{CLI_MOVIE}/{hole}/{start}_{end}",
                    seq=decode_bases(read.seq), tags={
                        "RG": rg, "zm": hole, "cx": 3,
                        "rq": float(read.read_accuracy),
                        "sn": [float(x) for x in chunk.snr]}))
                start = end + 50


def phase_cli(chunks, truths, main_path) -> dict:
    """The batch CLI on the card over the simulated ZMWs as a subread
    BAM, held against process_chunks on the same gated batches."""
    import os

    from pbccs_tpu_torch import cli
    from pbccs_tpu_torch.io.bam import BamReader, encode_record
    from pbccs_tpu_torch.io.pbi import PbiIndex
    from pbccs_tpu_torch.pipeline import ResultTally, process_chunks
    from pbccs_tpu_torch.resilience import quarantine
    from pbccs_tpu_torch.runtime.logging import Logger
    from pbccs_tpu_torch.runtime.whitelist import Whitelist

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "cli_smoke")
    os.makedirs(d, exist_ok=True)
    in_bam, out_bam = os.path.join(d, "subreads.bam"), os.path.join(
        d, "ccs.bam")
    report = os.path.join(d, "ccs_report.csv")
    write_subread_bam(in_bam, chunks)
    argv = [out_bam, in_bam, "--chunkSize", str(CLI_CHUNK), "--reportFile",
            report, "--logLevel", "WARN"]

    quarantine.reset_event_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.monotonic()
    rc = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    events = _quarantine_events()
    peak = torch.cuda.max_memory_allocated()
    # the same run on one worker thread: draft and polish in turn, so
    # the difference is what the work queue's overlap hides
    one_bam = os.path.join(d, "ccs_1worker.bam")
    t1 = time.monotonic()
    cli.run([one_bam, *argv[1:], "--numThreads", "1"])
    torch.cuda.synchronize()
    wall_one = time.monotonic() - t1

    with BamReader(out_bam) as r:
        records = list(r)
    pbi = PbiIndex(out_bam + ".pbi")
    text = open(report).read()
    # the reference: the port's reader and CLI gates on the same BAM, then
    # process_chunks on each gated batch
    args = cli.build_parser().parse_args(argv)
    gate_tally = ResultTally()
    want = []
    batches = list(cli.gated_chunks([in_bam], Whitelist("all"), args,
                                    Logger.default(), gate_tally))
    for batch in batches:
        want += process_chunks(batch, device="cuda").results
    same = [encode_record(r) for r in records] == [
        encode_record(cli.result_record(r)) for r in want]
    truth = {int(c.id.split("/")[1]): t for c, t in zip(chunks, truths)}
    idents = [identity(r.seq, truth[r.tags["zm"]]) for r in records]
    out = {"phase": "cli", "zmws": len(chunks), "chunk_size": CLI_CHUNK,
           "exit_code": rc, "wall_s": wall, "one_worker_wall_s": wall_one,
           "one_worker_same_bam": open(one_bam, "rb").read()
           == open(out_bam, "rb").read(),
           "phase4_draft_polish_s": main_path["wall_s"],
           "max_memory_allocated": peak,
           "records": len(records), "pbi_reads": pbi.n_reads,
           "pbi_holes_match": [int(h) for h in pbi.holes]
           == [r.tags["zm"] for r in records],
           "report": text.strip().splitlines(),
           "same_as_process_chunks": same,
           "identity_mean": float(np.mean(idents)) if idents else None,
           "identity_min": float(np.min(idents)) if idents else None,
           "phase4_identity_mean": main_path["identity_mean"],
           "launches": launches, "quarantine_events": events}
    emit(out)
    # for phase 15: the gated batches the CLI polished and their results
    out["batches"], out["results"] = batches, want
    if rc != 0 or not records or not same or not out["pbi_holes_match"] \
            or not out["one_worker_same_bam"]:
        raise AssertionError("the CLI's records, index or exit code are "
                             "wrong")
    if "Exception thrown" in text:
        raise AssertionError("the CLI tallied ZMWs as Other")
    _check_no_quarantine("cli", events)
    if launches["arrow_fill"] <= 0 or launches["dense_score"] <= 0:
        raise AssertionError(f"the CLI did not launch K1 and K3: {launches}")
    # the BAM's `sn` tag is float32, so the SNR tables may differ from
    # phase 4's in their last bit: the identity may move by a fraction of
    # a base per ZMW, not more
    if len(records) < main_path["tally"].get("Success", 0) or \
            out["identity_mean"] < main_path["identity_mean"] - CLI_IDENT_SLACK:
        raise AssertionError("the CLI's yield or identity fell below "
                             "phase 4's")
    return out


#: the watchdog deadline of phase 11's hang check and the delay injected
#: into the first dispatch: a 32-ZMW dispatch takes ~1-2 s on the card
HANG_TIMEOUT_S = 10.0
HANG_DELAY_S = 15.0
#: the spans phase 11 requires in a --trace-out capture
TRACE_SPANS = ("filter", "draft", "polish", "polish.setup", "polish.refine",
               "polish.qv", "emit")


def _join_watchdog_threads() -> int:
    """Join every abandoned pbccs-watchdog-* worker (its late polish
    launches kernels and holds memory until it ends); returns how many."""
    import threading

    workers = [t for t in threading.enumerate()
               if t.name.startswith("pbccs-watchdog-")]
    for t in workers:
        t.join(300)
        if t.is_alive():
            raise AssertionError(f"{t.name} did not finish")
    return len(workers)


def phase_resilience(cli_out) -> dict:
    """The CLI's resilience and observability tiers on the card, each
    held against phase 10's records (see the module docstring)."""
    import os

    from pbccs_tpu_torch import cli
    from pbccs_tpu_torch import pipeline as tp
    from pbccs_tpu_torch.io.bam import BamReader, encode_record
    from pbccs_tpu_torch.obs.metrics import default_registry
    from pbccs_tpu_torch.resilience import quarantine, resources
    from pbccs_tpu_torch.runtime import timing
    from pbccs_tpu_torch.runtime.logging import Logger
    from pbccs_tpu_torch.runtime.whitelist import Whitelist

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "cli_smoke")
    in_bam = os.path.join(d, "subreads.bam")
    reg = default_registry()

    def records(path):
        with BamReader(path) as r:
            return {rec.tags["zm"]: (rec, encode_record(rec)) for rec in r}

    ref = {k: v[1] for k, v in records(os.path.join(d, "ccs.bam")).items()}

    def run(name, *extra, chunk=CLI_CHUNK, expect_rc=0):
        out = os.path.join(d, f"p11_{name}.bam")
        report = os.path.join(d, f"p11_{name}.csv")
        quarantine.reset_event_counts()
        torch.cuda.synchronize()
        _zero_launch_counts()
        scope = reg.scope()
        t0 = time.monotonic()
        rc = cli.run([out, in_bam, "--chunkSize", str(chunk), "--reportFile",
                      report, "--logLevel", "WARN", *extra])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        joined = _join_watchdog_threads()
        if rc != expect_rc:
            raise AssertionError(f"{name}: exit code {rc}")
        return {"out": out, "report": open(report).read(), "wall_s": wall,
                "launches": _launch_counts(), "deltas": scope.delta(),
                "stages": timing.stage_seconds(scope),
                "events": _quarantine_events(), "records": records(out),
                "joined_watchdog_threads": joined}

    def counter(r, name, **labels):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        return float(r["deltas"].get(key, 0.0))

    def flight_dumps(log_path, reason):
        """The records of each flight-recorder dump a run logged."""
        tag = f"flight recorder dump ({reason}): "
        return [json.loads(line.split(tag, 1)[1].split(": ", 1)[1])
                for line in open(log_path) if tag in line]

    def differing(r, skip=()):
        """Holes whose record is not byte-equal to phase 10's."""
        got = {k: v[1] for k, v in r["records"].items() if k not in skip}
        want = {k: v for k, v in ref.items() if k not in skip}
        return sorted(k for k in set(got) | set(want)
                      if got.get(k) != want.get(k))

    out = {"phase": "resilience", "card": card_line(), "zmws": len(ref)}
    # (1) poison: one ZMW fails every dispatch and its serial rescue
    hole = sorted(ref)[5]          # a ZMW phase 10 polished
    zid = f"{CLI_MOVIE}/{hole}"
    poison_log = os.path.join(d, "p11_poison.log")
    poison = run("poison", "--faults", f"polish.dispatch:error~{zid}",
                 "--logFile", poison_log)
    poison_dumps = flight_dumps(poison_log, "quarantine")
    degraded = run("degraded", "--faults", f"polish.dispatch:error~{zid}",
                   "--degradeQuarantined")
    df = degraded["records"].get(hole, (None,))[0]
    out["poison"] = {
        "wall_s": poison["wall_s"], "launches": poison["launches"],
        "bisect_dispatches": counter(
            poison, "ccs_quarantine_bisect_dispatches_total"),
        "quarantined": counter(poison, "ccs_quarantined_zmws_total"),
        "others_differing": differing(poison, skip=(hole,)),
        "poison_absent": hole not in poison["records"],
        "degraded_wall_s": degraded["wall_s"],
        "degraded_launches": degraded["launches"],
        "degraded": counter(degraded, "ccs_degraded_zmws_total"),
        "degraded_df_record": df is not None and df.tags.get("df") == 1
        and set(df.qual) == {chr(33 + quarantine.DRAFT_QV_CAP)},
        "degraded_others_differing": differing(degraded, skip=(hole,)),
        "flight_dumps": counter(poison, "ccs_flight_dumps_total",
                                reason="quarantine"),
        "flight_dumps_logged": len(poison_dumps),
        "flight_records_logged": sum(map(len, poison_dumps)),
        "flight_sources": sorted({r["source"] for dump in poison_dumps
                                  for r in dump})}
    # (2) transient: one dispatch fails with a transient marker
    transient = run("transient", "--faults",
                    "polish.dispatch:error=transient*1")
    out["transient"] = {
        "wall_s": transient["wall_s"], "launches": transient["launches"],
        "retries": counter(transient, "ccs_retries_total",
                           site="polish.dispatch"),
        "differing": differing(transient)}
    # (3) hang: the first dispatch sleeps past the watchdog deadline
    hang = run("hang", "--polishTimeout", str(HANG_TIMEOUT_S), "--faults",
               f"polish.dispatch:delay={HANG_DELAY_S}*1")
    out["hang"] = {
        "timeout_s": HANG_TIMEOUT_S, "delay_s": HANG_DELAY_S,
        "wall_s": hang["wall_s"], "launches": hang["launches"],
        "watchdog_timeouts": counter(hang, "ccs_watchdog_timeouts_total",
                                     site="polish.dispatch"),
        "bisect_dispatches": counter(
            hang, "ccs_quarantine_bisect_dispatches_total"),
        "joined_watchdog_threads": hang["joined_watchdog_threads"],
        "quarantine_events": hang["events"],
        "differing": differing(hang)}
    # (4) capacity: a real CUDA OOM under a capped allocator
    args = cli.build_parser().parse_args(["x.bam", in_bam, "--chunkSize",
                                          str(CLI_CHUNK)])
    batches = [tp.prepare_batch(b)[1] for b in cli.gated_chunks(
        [in_bam], Whitelist("all"), args, Logger.default(), tp.ResultTally())]
    pins = [tp._pinned_batch_shapes(p, None) for p in batches]
    settings = tp.ConsensusSettings()

    def reserved_peak(preps, pin):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_reserved()
        tp._polish_batch_arrow(preps, settings, torch.device("cuda"),
                               buckets=pin)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_reserved() - base

    half = max(reserved_peak(p[lo:lo + CLI_CHUNK // 2], pin)
               for p, pin in zip(batches, pins)
               for lo in (0, CLI_CHUNK // 2))
    full = min(reserved_peak(p, pin) for p, pin in zip(batches, pins))
    del batches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    limit = torch.cuda.memory_reserved() + (half + full) // 2
    total = torch.cuda.get_device_properties(0).total_memory
    split_seen = []
    real_part = tp._polish_split_part

    def first_part(preps, *a, **kw):
        if not split_seen:
            split_seen.append(torch.cuda.memory_allocated())
        return real_part(preps, *a, **kw)

    if full <= half:
        raise AssertionError(f"a 32-ZMW dispatch reserves no more than a "
                             f"16-ZMW one: {full} <= {half}")
    torch.cuda.set_per_process_memory_fraction(limit / total)
    tp._polish_split_part = first_part
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    try:
        cap_log = os.path.join(d, "p11_capacity.log")
        cap = run("capacity", "--numThreads", "1", "--logFile", cap_log)
    finally:
        tp._polish_split_part = real_part
        torch.cuda.set_per_process_memory_fraction(1.0)
    ceiling = resources.default_governor().cap(
        resources.shape_bucket(*pins[0]), device="cuda:0")
    resources.default_governor().reset_device("cuda:0")
    out["capacity"] = {
        "pins": pins, "half_reserved_peak": half,
        "full_reserved_peak": full, "limit_bytes": limit,
        "fraction": limit / total, "wall_s": cap["wall_s"],
        "launches": cap["launches"],
        "max_memory_reserved": torch.cuda.max_memory_reserved(),
        "allocated_before_run": allocated_before,
        "allocated_at_first_half": split_seen[0] if split_seen else None,
        "oom_failures": counter(cap, "ccs_zmw_failures_total",
                                stage="polish.capacity",
                                exc="OutOfMemoryError"),
        "oom_splits": counter(cap, "ccs_resource_oom_splits_total"),
        "presplit_batches": counter(cap,
                                    "ccs_resource_presplit_batches_total"),
        "ceiling": ceiling, "quarantine_events": cap["events"],
        "flight_dumps": counter(cap, "ccs_flight_dumps_total",
                                reason="oom-ceiling"),
        "flight_dumps_logged": len(flight_dumps(cap_log, "oom-ceiling")),
        "differing": differing(cap)}
    # (5) checkpoint/resume at --chunkSize 16
    whole = run("whole16", chunk=16)
    ckpt = os.path.join(d, "p11_resume.ckpt")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    killed = subprocess.run(
        [sys.executable, "-m", "pbccs_tpu_torch.cli",
         os.path.join(d, "p11_resume.bam"), in_bam, "--chunkSize", "16",
         "--reportFile", os.path.join(d, "p11_resume.csv"), "--checkpoint",
         ckpt, "--numThreads", "1", "--faults", "workqueue.task:error@3",
         "--logLevel", "ERROR"], cwd=os.path.dirname(os.path.abspath(
             __file__)), capture_output=True, text=True, timeout=600)
    journaled = sum(1 for line in open(ckpt)
                    if json.loads(line)["type"] == "chunk") \
        if os.path.exists(ckpt) else 0
    resumed = run("resume", "--checkpoint", ckpt, "--resume", chunk=16)
    out["checkpoint"] = {
        "killed_exit_code": killed.returncode,
        "killed_stderr_tail": killed.stderr.strip().splitlines()[-1:],
        "journaled_chunks": journaled,
        "whole_wall_s": whole["wall_s"], "whole_launches": whole["launches"],
        "resume_wall_s": resumed["wall_s"],
        "resume_launches": resumed["launches"],
        "restored": counter(resumed, "ccs_checkpoint_records_total",
                            kind="restored"),
        "written": counter(resumed, "ccs_checkpoint_records_total",
                           kind="written"),
        "byte_identical": {ext: open(resumed["out"].replace(".bam", "")
                                     + ext, "rb").read()
                           == open(whole["out"].replace(".bam", "") + ext,
                                   "rb").read()
                           for ext in (".bam", ".bam.pbi", ".csv")},
        "journal_removed": not os.path.exists(ckpt)}
    # (6) trace and profile
    trace_path = os.path.join(d, "p11_trace.json")
    prof_dir = os.path.join(d, "p11_profile")
    if os.path.isdir(prof_dir):
        for f in os.listdir(prof_dir):
            os.remove(os.path.join(prof_dir, f))
    traced = run("trace", "--trace-out", trace_path, "--profile-dir",
                 prof_dir)
    events = json.load(open(trace_path))["traceEvents"]
    names = {e["name"] for e in events}
    wait = {}
    for e in events:
        wait.setdefault(e["name"], []).append(e["args"]["device_wait_ms"])
    (prof_file,) = os.listdir(prof_dir)
    kernels = {e["name"] for e in json.load(open(os.path.join(
        prof_dir, prof_file)))["traceEvents"] if e.get("cat") == "kernel"}
    out["trace"] = {
        "wall_s": traced["wall_s"], "phase10_wall_s": cli_out["wall_s"],
        "launches": traced["launches"], "spans": sorted(names),
        "device_wait_ms": {k: [min(v), sum(v)] for k, v in wait.items()},
        "profiled_kernels": sorted(
            k for k in kernels
            if "arrow_fill_kernel" in k or "dense_score_kernel" in k),
        "stage_seconds": traced["stages"],
        "differing": differing(traced)}
    emit(out)

    def require(ok, what):
        if not ok:
            raise AssertionError(f"resilience: {what}")

    p, tr, hg, c, ck, tc = (out[k] for k in ("poison", "transient", "hang",
                                              "capacity", "checkpoint",
                                              "trace"))
    require(not p["others_differing"] and p["poison_absent"]
            and "Failed -- Exception thrown,1," in poison["report"]
            and p["quarantined"] == 1, "poison ZMW not quarantined alone")
    require(p["flight_dumps"] >= 1 and p["flight_dumps_logged"] >= 1
            and p["flight_records_logged"] >= 1
            and p["flight_sources"] == ["device"],
            "no flight-recorder dump of device rounds on the quarantine")
    require(c["flight_dumps"] == 1 and c["flight_dumps_logged"] == 1,
            "no flight-recorder dump on the OOM ceiling")
    require(p["degraded_df_record"] and p["degraded"] == 1
            and not p["degraded_others_differing"], "draft-only degradation")
    require(tr["retries"] == 1 and not tr["differing"], "transient retry")
    require(hg["watchdog_timeouts"] == 1 and not hg["differing"]
            and hg["joined_watchdog_threads"] >= 1
            and not hg["quarantine_events"]["quarantined"], "hang recovery")
    require(c["oom_failures"] >= 1 and c["oom_splits"] >= 1
            and c["ceiling"] == CLI_CHUNK // 2 and c["presplit_batches"] >= 1
            and not any(c["quarantine_events"].values())
            and not c["differing"], "capacity split on a real CUDA OOM")
    require(ck["killed_exit_code"] != 0 and ck["journaled_chunks"] >= 1
            and all(ck["byte_identical"].values()) and ck["restored"] >= 1
            and ck["resume_launches"]["arrow_fill"]
            < ck["whole_launches"]["arrow_fill"]
            and ck["journal_removed"], "checkpoint/resume")
    require(set(TRACE_SPANS) <= set(tc["spans"])
            and all(tc["device_wait_ms"][k][0] > 0
                    for k in ("polish", "polish.refine"))
            and any("arrow_fill_kernel" in k for k in tc["profiled_kernels"])
            and any("dense_score_kernel" in k
                    for k in tc["profiled_kernels"])
            and not tc["differing"], "trace spans or profiler kernels")
    for r in (poison, degraded, transient, hang, cap, whole, resumed,
              traced):
        require(r["launches"]["arrow_fill"] > 0
                and r["launches"]["dense_score"] > 0, "K1 or K3 not launched")
    return out


#: the tolerance of score_read / score_read_quiver on the card against the
#: CPU: the fills' contract on a log-likelihood (fwdbwd_pallas.py:45-47)
SCORE_ATOL = 1e-4


def phase_ledger(chunks, truths, cli_out) -> dict:
    """The CLI of phase 10 with --perfLedger on the card: its record held
    against the run's registry window and the roofline cards of the
    run's setups, `ccs roofline` over the ledger and the cards; then
    score_read (K1) and score_read_quiver (K2) of one 2 kb read on the
    card against the CPU."""
    import contextlib
    import io
    import os

    from pbccs_tpu_torch import cli
    from pbccs_tpu_torch.models.quiver.features import flat_default_features
    from pbccs_tpu_torch.models.readscorer import (score_read,
                                                   score_read_quiver)
    from pbccs_tpu_torch.obs import roofline
    from pbccs_tpu_torch.obs.ledger import (LEDGER_FIELDS, read_ledger,
                                            run_record)
    from pbccs_tpu_torch.obs.metrics import default_registry
    from pbccs_tpu_torch.parallel.batch import BatchPolisher

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "cli_smoke")
    in_bam, out_bam = (os.path.join(d, "subreads.bam"),
                       os.path.join(d, "p12_ledger.bam"))
    ledger = os.path.join(d, "p12_ledger.ndjson")
    if os.path.exists(ledger):
        os.remove(ledger)
    setups = []
    real_setup = BatchPolisher._setup

    def setup(self):
        setups.append((self._Imax, self._Jmax, self._R, self._Z))
        return real_setup(self)

    torch.cuda.synchronize()
    _zero_launch_counts()
    scope = default_registry().scope()
    BatchPolisher._setup = setup
    t0 = time.monotonic()
    try:
        rc = cli.run([out_bam, in_bam, "--chunkSize", str(CLI_CHUNK),
                      "--reportFile", os.path.join(d, "p12_ledger.csv"),
                      "--logLevel", "WARN", "--perfLedger", ledger])
        torch.cuda.synchronize()
    finally:
        BatchPolisher._setup = real_setup
    wall = time.monotonic() - t0
    launches = _launch_counts()
    records, skipped = read_ledger(ledger)
    rec = records[0] if len(records) == 1 and not skipped else {}
    # the same record built from this script's window around the run
    window = run_record(scope, kind="batch_run", source="ccs",
                        device="cuda")
    gated = [k for k, c in LEDGER_FIELDS.items()
             if c in ("counter", "compile", "ratio") and k in window]
    cards = roofline.tracker()
    want_flops = sum(cards.card(roofline.bucket_label(i, j, r)).flops_for(z)
                     for i, j, r, z in setups)

    def roofline_cmd(*args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                code = cli.run(["roofline", *args])
            except SystemExit as e:
                code = e.code
        return code, buf.getvalue().strip().splitlines()

    rl_ledger = roofline_cmd("--ledger", ledger)
    rl_cards = roofline_cmd("--cards", roofline.cards_path())

    # one 2 kb forward-strand read of the draw against its true template
    read, tpl, snr = chunks[0].reads[0].seq, truths[0], chunks[0].snr
    scores = {}
    for name, fn, args in (
            ("score_read", score_read, (read, tpl, snr)),
            ("score_read_quiver", score_read_quiver,
             (flat_default_features(read), tpl))):
        _zero_launch_counts()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        card = fn(*args, device="cuda")
        t2 = time.monotonic()
        on_card = _launch_counts()
        cpu = fn(*args, device="cpu")
        scores[name] = {"cuda": card, "cpu": cpu, "abs_err": abs(card - cpu),
                        "cuda_s": t2 - t1, "cpu_s": time.monotonic() - t2,
                        "launches": on_card}
    out = {"phase": "ledger", "exit_code": rc, "wall_s": wall,
           "phase10_wall_s": cli_out["wall_s"], "launches": launches,
           "same_bam_as_phase10": open(out_bam, "rb").read()
           == open(os.path.join(d, "ccs.bam"), "rb").read(),
           "records": len(records), "skipped_lines": skipped,
           "record": rec,
           "differing_from_window": {k: [rec.get(k), window[k]]
                                     for k in gated
                                     if rec.get(k) != window[k]},
           "setups": setups, "cards_flops": want_flops,
           "roofline_ledger": rl_ledger, "roofline_cards": rl_cards,
           "scores": scores, "score_atol": SCORE_ATOL}
    emit(out)

    def require(ok, what):
        if not ok:
            raise AssertionError(f"ledger: {what}")

    require(rc == 0 and rec, "no single batch_run record")
    require(rec.get("platform") == "gpu"
            and rec.get("torch_version") == torch.__version__
            and "jax_version" not in rec, "record's platform or version")
    require(not out["differing_from_window"],
            "record's counters differ from the run's registry window")
    require(rec.get("roofline_flops") == want_flops > 0,
            "roofline_flops is not the cards' charge of the run's setups")
    require(0 < rec.get("roofline_efficiency", 0) <= 1,
            "roofline_efficiency outside (0, 1]")
    require(rl_ledger[0] == 0 and rl_cards[0] == 0,
            "ccs roofline --ledger / --cards failed")
    require(launches["arrow_fill"] > 0 and launches["dense_score"] > 0
            and out["same_bam_as_phase10"],
            "the ledger run's kernels or records")
    sr, sq = scores["score_read"], scores["score_read_quiver"]
    require(sr["abs_err"] <= SCORE_ATOL and sr["launches"]["arrow_fill"] > 0,
            "score_read on the card")
    require(sq["abs_err"] <= SCORE_ATOL and sq["launches"]["quiver_fill"] > 0,
            "score_read_quiver on the card")
    return out


#: the --prepareWorkers counts phase 13 runs the fleet at
FLEET_PREPARE = (1, 2, 4)
#: the bucket phase 13's `ccs warmup` drives: a batch of the main path
WARMUP_BUCKET = "32x10x2000"
#: phase 14's `ccs tune`: calibration geometry and wall-clock budget
TUNE_ARGS = ("--zmws", "8", "--passes", "3", "--tplLen", "300",
             "--chunkSize", "8", "--repeat", "1", "--knobs",
             "prepare_workers", "--tuneBudget", "90", "--serveLeg")
TUNE_PROFILE_KNOBS = {"prepare_workers": 2}


def _fleet_harness(cli_out):
    """A runner of phase 10's CLI on the same BAM through the device
    fleet (`--devices 0`), each run's counters, stage seconds, launches
    and peak memory read, its BAM, .pbi and report held against phase
    10's."""
    import os

    from pbccs_tpu_torch import cli
    from pbccs_tpu_torch.io.bam import BamReader, encode_record
    from pbccs_tpu_torch.io.pbi import PbiIndex
    from pbccs_tpu_torch.obs.metrics import default_registry
    from pbccs_tpu_torch.resilience import quarantine

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "cli_smoke")
    in_bam, ref_bam = (os.path.join(d, "subreads.bam"),
                       os.path.join(d, "ccs.bam"))

    def read(bam):
        with BamReader(bam) as r:
            return [encode_record(rec) for rec in r]

    ref = {"records": read(ref_bam),
           "holes": [int(h) for h in PbiIndex(ref_bam + ".pbi").holes],
           "report": open(os.path.join(d, "ccs_report.csv")).read()}
    reg = default_registry()

    def run(name, *extra):
        out = os.path.join(d, f"fleet_{name}.bam")
        report = os.path.join(d, f"fleet_{name}.csv")
        quarantine.reset_event_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        scope = reg.scope()
        t0 = time.monotonic()
        rc = cli.run([out, in_bam, "--chunkSize", str(CLI_CHUNK),
                      "--reportFile", report, "--logLevel", "WARN",
                      "--devices", "0", *extra])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        delta = scope.delta()

        def counter(metric, **labels):
            key = (metric, tuple(sorted((k, str(v))
                                        for k, v in labels.items())))
            return float(delta.get(key, 0.0))

        stages = {stage: delta.get(("ccs_sched_stage_latency_seconds",
                                    (("stage", stage),)), ((), 0.0, 0))[1]
                  for stage in ("prepare", "dispatch", "polish")}
        got = {"name": name, "exit_code": rc, "wall_s": wall,
               "launches": _launch_counts(),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "stage_s": stages,
               "sched_batches": counter("ccs_sched_batches_total"),
               "tasks_cuda0": counter("ccs_sched_tasks_total",
                                      device="cuda:0"),
               "requeues": counter("ccs_sched_requeues_total"),
               "oom_splits": counter("ccs_resource_oom_splits_total"),
               "presplit_batches": counter(
                   "ccs_resource_presplit_batches_total"),
               "budget_throttles": counter("ccs_resource_throttles_total",
                                           site="sched.prepare"),
               "quarantine_events": _quarantine_events()}
        if rc == 0:
            got.update({
                "same_records": read(out) == ref["records"],
                "same_pbi_holes": [int(h) for h in PbiIndex(
                    out + ".pbi").holes] == ref["holes"],
                "same_report": open(report).read() == ref["report"]})
        return got

    def require(r, what_launches=True):
        ok = (r["exit_code"] == 0 and r.get("same_records")
              and r.get("same_pbi_holes") and r.get("same_report")
              and r["sched_batches"] == 2 and r["tasks_cuda0"] == 2)
        if not ok:
            raise AssertionError(f"fleet {r['name']}: exit code, records, "
                                 f".pbi, report or scheduler counts: {r}")
        _check_no_quarantine(f"fleet {r['name']}", r["quarantine_events"])
        if what_launches and any(
                r["launches"][k] != cli_out["launches"][k]
                for k in ("arrow_fill", "dense_score")):
            raise AssertionError(f"fleet {r['name']}: launches "
                                 f"{r['launches']} against phase 10's "
                                 f"{cli_out['launches']}")

    return run, require, in_bam


def _fresh_ccs(tag, in_bam) -> dict:
    """Phase 10's CLI run in a fresh process with --trace-out: its wall,
    its first batch's latency (the end of the first polish span, from
    the tracer's origin at the run's start) and that batch's setup span;
    its BAM must be byte-equal to phase 10's."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, "build", "cli_smoke")
    out, trace = (os.path.join(d, f"fresh_{tag}.bam"),
                  os.path.join(d, f"fresh_{tag}.trace.json"))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pbccs_tpu_torch.cli", out, in_bam,
         "--chunkSize", str(CLI_CHUNK), "--logLevel", "WARN",
         "--trace-out", trace],
        cwd=root, capture_output=True, text=True, timeout=300)
    wall = time.monotonic() - t0
    if proc.returncode != 0 or open(out, "rb").read() != open(
            os.path.join(d, "ccs.bam"), "rb").read():
        raise AssertionError(f"fresh ccs {tag}: exit code "
                             f"{proc.returncode} or a BAM unlike phase "
                             f"10's: {proc.stderr[-2000:]}")
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    first = min((e for e in events if e["name"] == "polish"),
                key=lambda e: e["ts"] + e["dur"])
    setup = [e for e in events if e["name"] == "polish.setup"
             and first["ts"] <= e["ts"] <= first["ts"] + first["dur"]]
    return {"run": tag, "wall_s": wall,
            "first_batch_s": (first["ts"] + first["dur"]) / 1e6,
            "first_polish_s": first["dur"] / 1e6,
            "first_setup_s": setup[0]["dur"] / 1e6 if setup else None}


def phase_fleet(cli_out) -> dict:
    """Phase 10's CLI through the device fleet on the card at
    --prepareWorkers 1, 2 and 4, under an injected OOM at the scheduler's
    dispatch and under a --memBudget of one batch, `ccs warmup` in a
    fresh process, and one --perfLedger record."""
    import os

    from pbccs_tpu_torch import cli
    from pbccs_tpu_torch import pipeline as tp
    from pbccs_tpu_torch.obs.ledger import read_ledger
    from pbccs_tpu_torch.parallel.batch import premarshal_nbytes
    from pbccs_tpu_torch.resilience import resources
    from pbccs_tpu_torch.runtime.logging import Logger
    from pbccs_tpu_torch.runtime.whitelist import Whitelist

    run, require, in_bam = _fleet_harness(cli_out)
    out = {"phase": "fleet", "card": card_line(),
           "phase10_wall_s": cli_out["wall_s"],
           "phase10_one_worker_wall_s": cli_out["one_worker_wall_s"],
           "phase10_max_memory_allocated": cli_out["max_memory_allocated"],
           "phase10_launches": cli_out["launches"], "runs": []}
    for n in FLEET_PREPARE:
        r = run(f"prepare{n}", "--prepareWorkers", str(n))
        out["runs"].append(r)
        require(r)
    # one OOM at the scheduler's dispatch: a capacity requeue to cuda:0,
    # whose polish pre-splits at the learned ceiling
    oom = run("oom", "--prepareWorkers", "2", "--faults",
              "sched.dispatch:oom@1*1")
    resources.default_governor().reset_device("cuda:0")
    out["oom"] = oom
    require(oom, what_launches=False)
    if oom["requeues"] != 1 or oom["oom_splits"] != 1:
        raise AssertionError(f"fleet oom: requeues {oom['requeues']}, "
                             f"OOM splits {oom['oom_splits']}")
    # a host budget of one batch's marshalled bytes
    args = cli.build_parser().parse_args(["x.bam", in_bam, "--chunkSize",
                                          str(CLI_CHUNK)])
    first = next(cli.gated_chunks([in_bam], Whitelist("all"), args,
                                  Logger.default(), tp.ResultTally()))
    preps = tp.prepare_batch(first)[1]
    nbytes = premarshal_nbytes((*tp._pinned_batch_shapes(preps, None),
                                len(preps)))
    del preps
    budget = run("budget", "--prepareWorkers", "2", "--memBudget",
                 str(nbytes))
    budget["mem_budget"] = nbytes
    out["budget"] = budget
    require(budget)
    if budget["budget_throttles"] < 1:
        raise AssertionError("fleet budget: the prepare threads never "
                             "throttled")
    # `ccs warmup` in a fresh process, between fresh `ccs` processes:
    # what of the warmup survives into a later process's first batch
    fresh = [_fresh_ccs(f"cold{i}", in_bam) for i in (1, 2)]
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pbccs_tpu_torch.cli", "warmup", "--bucket",
         WARMUP_BUCKET, "--logLevel", "WARN"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    report = None
    if proc.returncode == 0:
        report = json.loads(proc.stdout.strip().splitlines()[-1])
    out["warmup"] = {"exit_code": proc.returncode,
                     "wall_s": time.monotonic() - t0, "report": report,
                     "stderr_tail": proc.stderr[-2000:]}
    entries = (report or {}).get("warmed", [])
    if proc.returncode != 0 or len(entries) != 1 \
            or entries[0]["device"] != "cuda:0" \
            or entries[0]["bucket"] != WARMUP_BUCKET \
            or not entries[0].get("shapes") \
            or not entries[0].get("cost_card"):
        raise AssertionError(f"ccs warmup: {out['warmup']}")
    fresh += [_fresh_ccs(f"warm{i}", in_bam) for i in (1, 2)]
    out["fresh_ccs"] = fresh
    # one perf-ledger record of the fleet
    ledger = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "cli_smoke", "fleet_ledger.ndjson")
    if os.path.exists(ledger):
        os.remove(ledger)
    led = run("ledger", "--perfLedger", ledger)
    records, skipped = read_ledger(ledger)
    rec = records[0] if len(records) == 1 and not skipped else {}
    led["record"] = {k: rec.get(k) for k in (
        "platform", "sched_batches", "workload", "tuned_profile",
        "wall_s", "zmws_per_sec")}
    out["ledger"] = led
    emit(out)
    require(led)
    if rec.get("sched_batches") != 2 or rec.get("platform") != "gpu":
        raise AssertionError(f"fleet ledger record: {led['record']}")
    return out


def phase_tune(cli_out) -> dict:
    """`ccs tune`'s batch and serve legs on the card in a fresh process,
    then a profile for this card applied to phase 10's CLI through the
    fleet."""
    import os

    from pbccs_tpu_torch.obs.ledger import read_ledger
    from pbccs_tpu_torch.tune.profile import (HostProfile, host_fingerprint,
                                              save_profile)

    root = os.path.dirname(os.path.abspath(__file__))
    wd = os.path.join(root, "build", "tune_smoke")
    os.makedirs(wd, exist_ok=True)
    tuned = os.path.join(wd, "tuned.json")
    for stale in ("journal.ndjson", "tuned.json"):
        if os.path.exists(os.path.join(wd, stale)):
            os.remove(os.path.join(wd, stale))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pbccs_tpu_torch.cli", "tune", *TUNE_ARGS,
         "--workdir", wd, "--out", tuned, "--logLevel", "INFO"],
        cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.monotonic() - t0
    summary = None
    if proc.returncode == 0:
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
    journal, _ = read_ledger(os.path.join(wd, "journal.ndjson"))
    measured = [(j["assignment"], j["ok"], (j.get("measurement") or {}).get(
        "zmws_per_sec")) for j in journal]
    host = host_fingerprint()
    shipped = None
    if summary and summary.get("shipped"):
        with open(tuned) as fh:
            shipped = json.load(fh)
    out = {"phase": "tune", "card": card_line(), "exit_code": proc.returncode,
           "wall_s": wall, "summary": summary, "journal": measured,
           "shipped_fingerprint": shipped and shipped["fingerprint"],
           "stderr_tail": proc.stderr[-2000:]}
    want = [{}] + [{"prepare_workers": n} for n in (1, 2, 4)]
    ok = (proc.returncode == 0 and summary is not None
          and [a for a, _, _ in measured] == want
          and all(good for _, good, _ in measured))
    if ok and shipped is not None:
        ok = (shipped["fingerprint"]["device_kind"] == host["device_kind"]
              and shipped["fingerprint"]["torch_version"]
              == host["torch_version"])
    elif ok:
        ok = "nothing to ship" in summary.get("note", "")
    # the serve leg: a `ccs serve` process for the defaults and for each
    # serve candidate, none failed
    leg = (summary or {}).get("serve_leg") or {}
    ok = ok and "error" not in leg and "baseline" in leg and not [
        r for r in leg.get("rejected", [])
        if r["reason"] != "served output differs from defaults"]
    # a profile for this card, applied to the fleet run of phase 10's CLI
    profile = HostProfile(fingerprint=host, knobs=dict(TUNE_PROFILE_KNOBS))
    path = os.path.join(wd, "card.json")
    save_profile(profile, path)
    ledger = os.path.join(wd, "applied.ndjson")
    if os.path.exists(ledger):
        os.remove(ledger)
    run, require, _ = _fleet_harness(cli_out)
    applied = run("tuned", "--tuneProfile", path, "--perfLedger", ledger)
    records, skipped = read_ledger(ledger)
    rec = records[0] if len(records) == 1 and not skipped else {}
    applied["tuned_profile"] = rec.get("tuned_profile")
    out.update(profile_id=profile.profile_id, applied=applied)
    emit(out)
    if not ok:
        raise AssertionError("ccs tune: exit code, journal or profile")
    require(applied)
    if rec.get("tuned_profile") != profile.profile_id:
        raise AssertionError(f"the applied profile's id is not in the "
                             f"ledger record: {rec.get('tuned_profile')}")
    return out


#: phase 15's flush threshold (ZMWs per bucket) and wait: longer than
#: one prep thread takes to draft phase 10's 64 ZMWs (~1.9 s), so every
#: length bucket flushes whole -- on fill at 32, else at its deadline
SERVE_BATCH = 32
SERVE_WAIT_MS = 4_000.0
#: ZMWs the `ccs serve` subprocess polishes (one length bucket, so they
#: flush on fill), and the bound of its start
SERVE_CHILD_ZMWS = 4
SERVE_READY_S = 300.0


def _wire_record(reply) -> tuple:
    """What phase 15 holds byte-equal: the reply's consensus fields."""
    return tuple(reply.get(k) for k in ("status", "zmw", "sequence", "qual",
                                        "num_passes", "predicted_accuracy",
                                        "avg_zscore", "draft_only"))


def _serve_pass(client, chunks, trace: bool) -> dict:
    """Every chunk submitted at once through the port's client (its ZMW
    id as the request's trace id), every reply awaited (bounded): the
    replies by ZMW id, the pass's wall, its first reply's latency (the
    first flush's completion), client-side latency percentiles and the
    engine's ccs_serve_request_latency_seconds p50/p99 over the pass."""
    from pbccs_tpu_torch.obs.metrics import (default_registry,
                                             histogram_quantile)
    from pbccs_tpu_torch.serve.engine import _m_latency

    scope = default_registry().scope()
    t0 = time.monotonic()
    handles = [(c.id, client.submit_chunk(
        c, trace={"trace_id": c.id, "span_id": None} if trace else None))
        for c in chunks]
    arrival: dict[str, float] = {}
    deadline = t0 + 600.0
    while len(arrival) < len(handles):
        if time.monotonic() > deadline:
            raise AssertionError(f"serve: {len(handles) - len(arrival)} "
                                 "replies missing after 600 s")
        for zid, h in handles:
            if zid not in arrival and h.done():
                arrival[zid] = time.monotonic() - t0
        time.sleep(0.001)
    replies = {zid: h.reply(0.0, check=False) for zid, h in handles}
    counts, _sum, n = scope.delta()[(_m_latency.name, ())]
    lat = np.array(sorted(arrival.values())) * 1e3
    return {"replies": replies, "wall_s": max(arrival.values()),
            "first_reply_s": min(arrival.values()),
            "client_latency_ms_p50": float(np.percentile(lat, 50)),
            "client_latency_ms_p99": float(np.percentile(lat, 99)),
            "engine_requests": n,
            "engine_latency_s_p50_le": histogram_quantile(
                counts, _m_latency.bounds, 0.50),
            "engine_latency_s_p99_le": histogram_quantile(
                counts, _m_latency.bounds, 0.99)}


def _serve_child(argv, env=None):
    """`python -m pbccs_tpu_torch.cli serve ARGV` started from the
    checkout with its stdout on a pipe."""
    import os

    return subprocess.Popen(
        [sys.executable, "-m", "pbccs_tpu_torch.cli", "serve", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)


def _http_get(host: str, port: int, path: str) -> tuple[int, bytes]:
    """(status, body) of one GET on the metrics endpoint, straight to the
    socket (no proxy from the environment)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=30.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_serve(cli_out, fleet_out) -> dict:
    """`ccs serve` on the card: an in-process CcsEngine + CcsServer fed
    phase 10's gated ZMWs twice, then a `ccs serve` process (see the
    module docstring)."""
    import os

    from pbccs_tpu_torch import pipeline as tp
    from pbccs_tpu_torch.obs.ledger import read_ledger
    from pbccs_tpu_torch.runtime.logging import Logger, LogLevel
    from pbccs_tpu_torch.serve import protocol
    from pbccs_tpu_torch.serve.client import CcsClient, wait_for_ready
    from pbccs_tpu_torch.serve.engine import (CcsEngine, ServeConfig,
                                              flush_buckets)
    from pbccs_tpu_torch.serve.server import CcsServer

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "serve_smoke")
    os.makedirs(d, exist_ok=True)
    chunks = [c for b in cli_out["batches"] for c in b]
    order = {c.id: i for i, c in enumerate(chunks)}
    prep_by_id = {p.chunk.id: p for batch in cli_out["batches"]
                  for p in tp.prepare_batch(batch)[1]}
    want = {r.id: r for r in cli_out["results"]}
    log = Logger(level=LogLevel.from_string("WARN"))
    ledger = os.path.join(d, "engine_ledger.ndjson")
    if os.path.exists(ledger):
        os.remove(ledger)
    cfg = ServeConfig(max_batch=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                      prep_workers=1, perf_ledger_path=ledger,
                      perf_ledger_interval_s=3600.0)
    out = {"phase": "serve", "card": card_line(), "zmws": len(chunks),
           "max_batch": SERVE_BATCH, "max_wait_ms": SERVE_WAIT_MS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t_up = time.monotonic()
    with CcsEngine(config=cfg, logger=log) as engine:
        server = CcsServer(engine, port=0, logger=log).start()
        try:
            with CcsClient(server.host, server.port, timeout=600.0) as cli:
                out["engine_up_s"] = time.monotonic() - t_up
                assert cli.trace("start")["state"] == "started"
                first = _serve_pass(cli, chunks, trace=True)
                spans = cli.trace("stop")["trace"]["traceEvents"]
                launches = _launch_counts()
                _zero_launch_counts()
                second = _serve_pass(cli, chunks, trace=False)
                launches2 = _launch_counts()
                status = cli.status()
        finally:
            server.shutdown()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    records, skipped = read_ledger(ledger)
    snap = records[-1] if records and not skipped else {}
    # every flush of the first pass, from its serve.polish span: members
    # (their trace ids; one prep thread keeps input order), reason and the
    # (Imax, Jmax, R, Z) it polished at; each flush's members polished
    # again by polish_prepared_batch at those shapes, the batch path's
    # records the serve flush must give byte for byte
    flushes, batch_path = [], {}
    for ev in sorted((e for e in spans if e["name"] == "serve.polish"),
                     key=lambda e: e["ts"]):
        ids = sorted(ev["args"]["trace_ids"], key=order.get)
        preps = [prep_by_id[i] for i in ids]
        shapes = flush_buckets(preps)
        flushes.append({"zmws": ev["args"]["zmws"],
                        "reason": ev["args"]["reason"],
                        "shapes": list(shapes),
                        "polish_ms": ev["dur"] / 1e3})
        for i, (failure, result) in zip(ids, tp.polish_prepared_batch(
                preps, buckets=shapes)):
            batch_path[i] = _wire_record(protocol.result_to_wire(
                None, i, failure, result, 0.0))
    same_as_batch_path = sum(_wire_record(first["replies"][i]) == rec
                             for i, rec in batch_path.items())
    # served records against phase 10's: the batcher groups by length
    # bucket, so a flush holds other ZMWs than phase 10's input-order
    # batches and runs at other shapes; the parity standard, with the
    # count that differ in bytes
    byte_equal = parity = differ_bytes = 0
    bad = []
    for zid, reply in first["replies"].items():
        ref = want.get(zid)
        if ref is None:
            if reply.get("status") == "Success":
                bad.append(f"{zid}: served Success, phase 10 no record")
            continue
        expect = protocol.result_to_wire(None, zid, tp.Failure.SUCCESS, ref,
                                         0.0)
        if _wire_record(reply) == _wire_record(expect):
            byte_equal += 1
            continue
        differ_bytes += 1
        qv = np.frombuffer(reply.get("qual", "").encode(), np.uint8)
        qr = np.frombuffer(expect["qual"].encode(), np.uint8)
        if reply.get("sequence") == ref.sequence and len(qv) == len(qr) \
                and np.abs(qv.astype(int) - qr.astype(int)).max() <= 1:
            parity += 1
        else:
            bad.append(f"{zid}: not the same sequence with QVs within 1")
    repeat_same = sum(_wire_record(second["replies"][z])
                      == _wire_record(first["replies"][z])
                      for z in first["replies"])
    out.update(
        flushes=flushes, flushed_zmws=len(batch_path),
        same_as_batch_path_at_flush_shapes=same_as_batch_path,
        byte_equal=byte_equal, parity_only=parity,
        differ_in_bytes=differ_bytes, failures=bad,
        served_success=sum(r.get("status") == "Success"
                           for r in first["replies"].values()),
        phase10_records=len(want), second_pass_byte_equal=repeat_same,
        launches=launches, second_pass_launches=launches2,
        max_memory_allocated=peak,
        status={k: status.get(k) for k in ("completed", "errors", "pending",
                                           "stage_seconds")},
        ledger_record={k: snap.get(k) for k in (
            "kind", "platform", "completed", "errors", "polish_dispatches",
            "refine_rounds_device", "device_fetches", "uptime_s")},
        passes=[{k: v for k, v in p.items() if k != "replies"}
                for p in (first, second)],
        phase13_fresh_first_batch_s=[f["first_batch_s"]
                                     for f in fleet_out["fresh_ccs"]],
        phase10_wall_s=cli_out["wall_s"])

    # 4 ZMWs of one length bucket through a max_batch 4 in-process server
    # and a `ccs serve` process: byte-equal at the same shapes; then its
    # metrics endpoint, SIGTERM drain with a request in flight, exit 0
    from pbccs_tpu_torch.parallel.batch import length_bucket

    def bucket(c):
        p = prep_by_id[c.id]
        return length_bucket(len(p.css), max(len(m.seq) for m in p.mapped))

    keys = [bucket(c) for c in chunks if c.id in prep_by_id]
    home = max(set(keys), key=keys.count)
    sub = [c for c in chunks if c.id in prep_by_id
           and bucket(c) == home][:SERVE_CHILD_ZMWS]
    small = ServeConfig(max_batch=SERVE_CHILD_ZMWS, max_wait_ms=SERVE_WAIT_MS,
                        prep_workers=1)
    with CcsEngine(config=small, logger=log) as engine:
        server = CcsServer(engine, port=0, logger=log).start()
        try:
            with CcsClient(server.host, server.port, timeout=600.0) as cli:
                local = _serve_pass(cli, sub, trace=False)["replies"]
        finally:
            server.shutdown()
    child_ledger = os.path.join(d, "child_ledger.ndjson")
    if os.path.exists(child_ledger):
        os.remove(child_ledger)
    t0 = time.monotonic()
    proc = _serve_child(["--port", "0", "--metricsPort", "-1",
                         "--perfLedger", child_ledger, "--maxBatch",
                         str(SERVE_CHILD_ZMWS), "--maxWaitMs",
                         str(SERVE_WAIT_MS), "--prepWorkers", "1",
                         "--logLevel", "WARN"])
    lines: list[str] = []
    child = {}
    try:
        ready = wait_for_ready(proc, SERVE_READY_S, lines)
        if ready is None:
            raise AssertionError(f"ccs serve never became ready: {lines}")
        child["ready_s"] = time.monotonic() - t0
        host, port = ready["CCS-SERVE-READY"]
        mhost, mport = ready["CCS-METRICS-READY"]
        with CcsClient(host, port, timeout=600.0) as cli:
            got = _serve_pass(cli, sub, trace=False)
            child["first_reply_s"] = got["first_reply_s"]
            child["byte_equal"] = sum(
                _wire_record(got["replies"][c.id])
                == _wire_record(local[c.id]) for c in sub)
            _, metrics = _http_get(mhost, mport, "/metrics")
            child["metrics_completed"] = next(
                (line.split()[-1] for line in metrics.decode().splitlines()
                 if line.startswith("ccs_serve_completed_total")), None)
            code, health = _http_get(mhost, mport, "/healthz")
            child["healthz"] = [code, health.decode().strip()]
            in_flight = cli.submit_chunk(
                next(c for c in chunks if c not in sub))
            # SIGTERM once the engine admitted it: a submit that arrives
            # after the drain began is answered `closed` instead
            admitted = status_now = None
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                status_now = cli.status()
                admitted = status_now["admitted"]
                if admitted > SERVE_CHILD_ZMWS:
                    break
                time.sleep(0.01)
            child["admitted_before_sigterm"] = admitted
            proc.send_signal(15)
            last = in_flight.reply(timeout=600.0, check=False)
            child["in_flight_reply"] = [last.get("type"), last.get("status")]
        child["exit_code"] = proc.wait(timeout=120.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
    child["draining_line"] = any(x.startswith("CCS-SERVE-DRAINING signal="
                                              "SIGTERM") for x in lines)
    crecs, _ = read_ledger(child_ledger)
    child["ledger_last"] = crecs[-1].get("kind") if crecs else None
    # a band width the kernels cannot polish at: refused at start
    env = dict(os.environ, PBCCS_BAND_W="80")
    refused = _serve_child(["--port", "0", "--logLevel", "WARN"], env=env)
    try:
        _, err = refused.communicate(timeout=300)
    finally:
        if refused.poll() is None:
            refused.kill()
            refused.wait(timeout=30.0)
    child["band_w_80"] = {"exit_code": refused.returncode,
                          "names_widths": "32, 64, 96, 128" in err}
    out["child"] = child
    emit(out)
    if bad or byte_equal + parity != len(want) \
            or out["served_success"] != len(want):
        raise AssertionError(f"serve: records unlike phase 10's: {bad}")
    if same_as_batch_path != len(batch_path) \
            or len(batch_path) != len(prep_by_id):
        raise AssertionError("serve: flushes unlike polish_prepared_batch "
                             "at their shapes")
    if repeat_same != len(first["replies"]):
        raise AssertionError("serve: the warm pass differs from the first")
    if launches["arrow_fill"] <= 0 or launches["dense_score"] <= 0:
        raise AssertionError(f"serve: K1/K3 not launched: {launches}")
    if status.get("errors") or snap.get("kind") != "serve_snapshot" \
            or snap.get("platform") != "gpu":
        raise AssertionError(f"serve: status or ledger record: "
                             f"{out['status']} {out['ledger_record']}")
    if child.get("byte_equal") != SERVE_CHILD_ZMWS \
            or child.get("exit_code") != 0 or not child["draining_line"] \
            or child.get("in_flight_reply", [None])[0] != "result" \
            or child["healthz"] != [200, "ok"] \
            or child["ledger_last"] != "serve_snapshot" \
            or child["band_w_80"] != {"exit_code": 2, "names_widths": True}:
        raise AssertionError(f"serve: the `ccs serve` process: {child}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import pbccs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        seconds[name] = round(time.monotonic() - t0, 3)
        return out

    timed("build", phase_build)
    rng = np.random.default_rng(SEED)
    chunks, truths = simulate_chunks(rng, N_ZMWS, TPL_LEN, PASSES)
    fx = kernel_fixture(list(zip(chunks[:BATCH], truths[:BATCH])), "cuda")
    fill, kept = timed("arrow_fill", phase_fill, fx)
    dense = timed("dense_score", phase_dense, fx, kept)
    W = fx["W"]
    del fx, kept    # phase 4's peak memory is the main path's alone
    main_path, main_tally = timed("main_path", phase_main, chunks, truths)
    timed("cross_device", phase_cross, chunks[:N_CROSS])
    k2 = timed("quiver_fill", phase_quiver_fill,
               quiver_fixture(chunks[0], truths[0], "cuda"))
    small, _ = simulate_chunks(rng, 1, QUIVER_SMALL[0],
                               (QUIVER_SMALL[1],) * 2)
    quiver = timed("quiver_path", phase_quiver, chunks[:N_QUIVER],
                   truths[:N_QUIVER], small)
    timed("refine_fallbacks", phase_fallbacks, rng)
    timed("serial", phase_serial, chunks[:N_SERIAL], truths[:N_SERIAL],
          main_tally)
    cli_out = timed("cli", phase_cli, chunks, truths, main_path)
    timed("resilience", phase_resilience, cli_out)
    timed("ledger", phase_ledger, chunks, truths, cli_out)
    fleet_out = timed("fleet", phase_fleet, cli_out)
    timed("tune", phase_tune, cli_out)
    timed("serve", phase_serve, cli_out, fleet_out)
    emit({"phase_seconds": seconds})

    # K1's launch on the main path: alpha and beta together at the
    # schedule's W
    k1 = next(r for r in fill["rows"] if r["mode"] == "fused" and r["W"] == W)
    mf, mb = k2["rows"][2:]
    # K3 at the schedule's W with every block live (the first round's and
    # the QV sweep's launch)
    k3 = next(r for r in dense["rows"]
              if r["mode"] == "all_live" and r["W"] == W)
    kernels = [
        {"name": "arrow_fill", "route": "cuda",
         "source": "pbccs_tpu_torch/csrc/arrow_fill.cu",
         "replaces": "pbccs_tpu/ops/fwdbwd_pallas.py:320",
         "launches": main_path["launches"]["arrow_fill"],
         "max_abs_err": max(r["ll_max_abs_err"] for r in fill["rows"]),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None},
        {"name": "quiver_fill", "route": "cuda",
         "source": "pbccs_tpu_torch/csrc/quiver_fill.cu",
         "replaces": "pbccs_tpu/ops/fwdbwd_pallas.py:320",
         "launches": quiver["launches"]["quiver_fill"],
         "max_abs_err": max(r["ll_max_abs_err"] for r in k2["rows"]),
         # the launch the Quiver path makes: log-likelihood-only mode at
         # the scorer's batch; the plain version on its checked rows
         "ms": (mf["ll_mode_ms"] + mb["ll_mode_ms"]) / 2,
         "plain_ms": (mf["plain_ms"] + mb["plain_ms"]) / 2,
         "bound_ms": (mf["ll_mode_bound_ms"] + mb["ll_mode_bound_ms"]) / 2,
         "bound_by": mf["ll_mode_bound_by"], "library_ms": None},
        {"name": "dense_score", "route": "cuda",
         "source": "pbccs_tpu_torch/csrc/dense_score.cu",
         "replaces": "pbccs_tpu/ops/dense_score_pallas.py:238",
         "launches": main_path["launches"]["dense_score"],
         "max_abs_err": max(r["max_abs_err"] for r in dense["rows"]),
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None},
    ]
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
