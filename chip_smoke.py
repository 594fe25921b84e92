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
     the bound counted by operation type (k1_bound);
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
     BAM bytes), which the work queue's overlap is measured against.
Then the card's name and power limit, the kernel table as one JSON
line, and as the last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX."""

from __future__ import annotations

import inspect
import json
import math
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
# published peak of one H100 SXM (NVIDIA data sheet): HBM bytes/s
PEAK_BYTES = 3.35e12
# issue rates of its 132 SMs at the data sheet's 1.98 GHz boost clock, by
# operation type (CUDA C++ Programming Guide, throughput of native
# arithmetic instructions, compute capability 9.0, results per clock per
# SM): 128 float32 adds or multiplies (the data sheet's 67 TFLOP/s counts
# a fused multiply-add as two; the kernels build with -fmad=false, so
# each add or multiply is one instruction), 64 32-bit integer adds,
# compares, min/max and logic operations (selects counted with them)
SM_CLOCKS = 132 * 1.98e9
RATE_F32_OP = 128 * SM_CLOCKS
RATE_INT_OP = 64 * SM_CLOCKS


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


def bound_ms(n_bytes: float, n_f32: float) -> tuple[float, str]:
    """(bound ms, bound_by) of bytes at PEAK_BYTES against float32 adds
    and multiplies at RATE_F32_OP."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_f32 / RATE_F32_OP
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


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


#: per lane and column of csrc/arrow_fill.cu, its integer, compare,
#: select and logic operations, counted in the kernel body per held slot
#: (forward, backward): the valid row 3, the emission and insertion
#: selects 4, the match factor 2 / 5, the match gate (source row and
#: band test) 6, the deletion gate 5, the insertion gate and scan cut 5,
#: the dead / pinned-column selects 3, the seed-lane test 2 and the
#: output select 1.  The layout's shuffles, roll selects and read-base
#: reload tests are not counted.
K1_INT_OPS = {False: 31, True: 34}


def k1_bound(reads, tpls, W: int, dirs):
    """(bound ms, bound_by, bytes, ops) of one K1 launch over the
    directions `dirs` (False forward, True backward): each input read once
    (reads, template windows, transitions, lengths, band offsets), each
    output written once (band values and log-scales per direction); per
    lane of every column K1_INT_OPS at RATE_INT_OP and 6 + 3 ceil(log2 W)
    float32 operations at RATE_F32_OP (the emission product, the match
    and deletion products and their sum, 3 per scan step, the column max,
    the scaling divide).  The two pipes issue side by side, so the
    operations take the longer of their two times; `ops` is (integer,
    float32)."""
    R, Imax = reads.shape
    Jmax = tpls.shape[1]
    nc = Jmax + 1
    n_bytes = (R * Imax + R * Jmax + 16 * R * Jmax + 4 * (2 * R + R * nc)
               + 4 * len(dirs) * (R * nc * W + R * nc))
    cells = R * nc * W
    n_int = cells * sum(K1_INT_OPS[d] for d in dirs)
    n_f32 = cells * len(dirs) * (6 + 3 * math.ceil(math.log2(W)))
    t_b = n_bytes / PEAK_BYTES
    t_o = max(n_int / RATE_INT_OP, n_f32 / RATE_F32_OP)
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            n_bytes, (n_int, n_f32))


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


#: per lane and position of csrc/dense_score.cu, the integer, compare,
#: select and logic operations the function needs, counted in the kernel
#: body per held slot: the band rows of columns p-1, p, p+1 (3 x 4); the
#: read codes of the one new column (its band row 4, range tests and
#: selects 6); the first columns (the shared one's operand band tests and
#: selects 8, emission 2, ext_b's gates 8, insertion mask 5, per base its
#: test and selects 3 x 4; the deletion's 26); the second columns' b
#: terms (shared band tests 6, per base operand selects, emission and
#: gates 12 x 4; the deletion's 26) and insertion coefficients (mask 5,
#: 8 x 3); the three link operand pairs (3 x 12).  What only this
#: kernel's layout needs is not counted: the shuffles and roll selects,
#: the packing of three columns' read codes into one register, its slide
#: and the codes' extraction (15 more), and the output lane select.
K3_INT_OPS = 12 + 10 + 61 + 80 + 29 + 36


def k3_bound(R: int, nc: int, Imax: int, Jm: int, W: int,
             positions: int | None = None, blocks: int | None = None):
    """(bound ms, bound_by, bytes, ops) of K3 over `positions` scored
    (read, position) cells in `blocks` live (read, 64-position) blocks
    (default all R x Jm in all blocks): each input read once -- the alpha
    and beta columns of the scored positions (a block's positions and two
    columns more of each), band offsets,
    scale prefix and suffix, reads, window templates and transitions,
    tables, lengths and live flags -- and the (R, Jm, 9) scores written
    once; per lane of every scored position K3_INT_OPS at RATE_INT_OP and
    71 + 42 ceil(log2 W) float32 operations at RATE_F32_OP (ext_b's 4 per
    first and second column, 8 + 20; 3 per scan step of the 14 scans less
    the unread last c product; the three link operand products; the nine
    links' 4 products, sum and band-sum add; stick / 3 is divided once
    per table row and window row, not per lane).  The two pipes issue
    side by side, so the operations take the longer of their two times;
    `ops` is (integer, float32)."""
    NB = -(-Jm // 64)
    n = R * Jm if positions is None else positions
    blocks = R * NB if blocks is None else blocks
    n_bytes = (4 * (2 * W * min(n + 2 * blocks, R * nc) + R * nc
                    + 2 * R * (nc + 1) + 2 * R + R * NB + 9 * R * Jm)
               + R * Imax + R * Jm + 16 * R * Jm + 128 * R)
    S = math.ceil(math.log2(W))
    n_int = n * W * K3_INT_OPS
    n_f32 = n * W * (71 + 42 * S)
    t_b = n_bytes / PEAK_BYTES
    t_o = max(n_int / RATE_INT_OP, n_f32 / RATE_F32_OP)
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            n_bytes, (n_int, n_f32))


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
#: per lane and column of csrc/quiver_fill.cu, its integer, compare,
#: select and logic operations, counted in the kernel body per held slot:
#: the operand build (valid row 3, source row 1, step and scan-cut tests
#: 2, Incorporate 2, tagged Delete 4, Extra 3, Merge 6, the four
#: band-gated operand selects 7 + 6 + 7 + 4), the seed-lane and
#: final-cell tests and the output select (3).  The layout's shuffles,
#: roll selects and table-row reload tests are not counted.
K2_INT_OPS = 45 + 3


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
    """(bound ms, bound_by, bytes, ops) of one K2 launch: each input read
    once (the tables of the reads the rows name, read lengths, windows,
    window lengths, row indices, band offsets), each output written once
    (band values in the band-value mode, log-scales, final cells); per
    lane of every column run (all nc in the band-value mode, J + 1 per
    row in the log-likelihood-only mode) K2_INT_OPS at RATE_INT_OP and
    float32 operations at RATE_F32_OP (the Incorporate/Delete products
    and sum 3, the Merge quotient, product and sum 3, 3 per scan step,
    the column max and the scaling divide 2).  The two pipes issue side
    by side, so the operations take the longer of their two times; `ops`
    is (integer, float32)."""
    from pbccs_tpu_torch.ops.quiver_fill_cuda import N_COLS

    W = qx["W"]
    R = rows["row_read"].shape[0]
    M, Jmax = rows["wins"].shape
    nc = Jmax + 1
    P = qx["tables"].shape[1]
    n_tab = int(torch.unique(rows["row_read"]).numel())
    n_bytes = (4 * (R * nc * W * vals + 2 * R * nc + R + 2 * R
                    + n_tab * P * N_COLS + n_tab + M) + M * Jmax)
    J = rows["wlens"][rows["row_win"].long()]
    cols = R * nc if vals else int((J + 1).sum())
    S = math.ceil(math.log2(W))
    n_int, n_f32 = cols * W * K2_INT_OPS, cols * W * (3 + 3 + 3 * S + 2)
    t_b = n_bytes / PEAK_BYTES
    t_o = max(n_int / RATE_INT_OP, n_f32 / RATE_F32_OP)
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            n_bytes, (n_int, n_f32))


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
    for batch in cli.gated_chunks([in_bam], Whitelist("all"), args,
                                  Logger.default(), gate_tally):
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

    phase_build()
    rng = np.random.default_rng(SEED)
    chunks, truths = simulate_chunks(rng, N_ZMWS, TPL_LEN, PASSES)
    fx = kernel_fixture(list(zip(chunks[:BATCH], truths[:BATCH])), "cuda")
    fill, kept = phase_fill(fx)
    dense = phase_dense(fx, kept)
    W = fx["W"]
    del fx, kept    # phase 4's peak memory is the main path's alone
    main_path, main_tally = phase_main(chunks, truths)
    phase_cross(chunks[:N_CROSS])
    k2 = phase_quiver_fill(quiver_fixture(chunks[0], truths[0], "cuda"))
    small, _ = simulate_chunks(rng, 1, QUIVER_SMALL[0],
                               (QUIVER_SMALL[1],) * 2)
    quiver = phase_quiver(chunks[:N_QUIVER], truths[:N_QUIVER], small)
    phase_fallbacks(rng)
    phase_serial(chunks[:N_SERIAL], truths[:N_SERIAL], main_tally)
    phase_cli(chunks, truths, main_path)

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
