#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pbccs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the
script exits non-zero):
  1. build: card name and power limit, torch/CUDA versions, the nvcc
     build of every kernel (all sources compiled in parallel) with the
     ptxas register / shared-memory report, and the host draft stage's
     native library (make, when the checkout has none yet);
  2. fill_scan (K1): simulated 2 kb, 3-10-pass reads at the main path's
     shapes; the kernel against its plain torch version on the card for
     forward and backward fills, at the schedule's W (96) and the 2x
     retry's W (192): log-likelihoods within 1e-4 absolute, band values
     within 1e-5 relative; CUDA-event times of both;
  3. dense_score (K3): on the W=96 fills of phase 2, the kernel against
     its plain version on interior slots (rtol 2e-5, atol 2e-3); times;
  4. main_path: process_chunks over 64 simulated ZMWs (2 kb, 3-10 passes,
     two batches of 32) on the card, with the launch counters zeroed
     just before and read just after; tally, yield, identity to the
     true template, wall time, ZMW/s, peak device memory;
  5. cross_device: 4 ZMWs of the draw through process_chunks on the card
     and on the CPU: same consensus sequences, QVs within 1.
Then the card's name and power limit, the kernel table as one JSON
line, and as the last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX."""

from __future__ import annotations

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
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
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
                         or "smem" in ln]
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


def phase_fill(fx) -> dict:
    from pbccs_tpu_torch.ops import fwdbwd_cuda as fc
    from pbccs_tpu_torch.ops.fwdbwd import BandedMatrix, band_offsets

    reads, rlens = fx["reads"].to(torch.int32), fx["rlens"].to(torch.int32)
    tpls, trans = fx["win_tpl"].to(torch.int32), fx["win_trans"]
    J = fx["wlens"].to(torch.int32)
    R, Jmax = tpls.shape
    nc = Jmax + 1
    eps = fc.MISMATCH_PROBABILITY
    rows, kept = [], {}
    launches0 = fc.fill_scan.launches
    for W in (fx["W"], 2 * fx["W"]):
        offsets = band_offsets(rlens, J, nc, W)
        for backward in (False, True):
            coeffs = fc._backward_coeffs if backward else fc._forward_coeffs
            args = coeffs(reads, rlens, tpls, trans, J, offsets, W, eps)
            args = [a.contiguous() for a in args]
            vk, lk = fc.fill_scan(*args, backward)
            vp, lp = fc.fill_scan_plain(*args, backward)
            torch.cuda.synchronize()
            if backward:
                ll = lambda v, s: fc.backward_loglik_batch(  # noqa: E731
                    BandedMatrix(v, offsets, s), J)
            else:
                ll = lambda v, s: fc.forward_loglik_batch(  # noqa: E731
                    BandedMatrix(v, offsets, s), rlens, J)
            ll_err = float((ll(vk, lk) - ll(vp, lp)).abs().max())
            rel = float(((vk - vp).abs()
                         / vp.abs().clamp(min=1e-30)).max())
            ms = cuda_ms(lambda: fc.fill_scan(*args, backward), 5)
            plain_ms = cuda_ms(lambda: fc.fill_scan_plain(*args, backward), 1)
            S = math.ceil(math.log2(W))
            n_bytes = 4 * (4 * R * nc * W + 2 * R * nc + R * W + R)
            n_ops = R * nc * W * (3 + 3 * S + 2)
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            row = {"W": W, "backward": backward, "ll_max_abs_err": ll_err,
                   "vals_max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
            rows.append(row)
            if ll_err > 1e-4 or rel > 1e-5:
                raise AssertionError(f"fill_scan disagrees with its plain "
                                     f"version: {row}")
            if W == fx["W"]:
                kept["bwd" if backward else "fwd"] = (
                    BandedMatrix(vk, offsets, lk), row)
    out = {"phase": "fill_scan", "reads": R, "nc": nc, "rows": rows,
           "launches": fc.fill_scan.launches - launches0}
    emit(out)
    return out, kept


def phase_dense(fx, kept) -> dict:
    from pbccs_tpu_torch.ops import dense_score_cuda as ds
    from pbccs_tpu_torch.ops.mutation_score import scale_prefix, scale_suffix

    W = fx["W"]
    alpha, _ = kept["fwd"]
    beta, _ = kept["bwd"]
    R, Jm = fx["win_tpl"].shape
    nc = Jm + 1
    rbase, rnext = ds.band_read_windows(fx["reads"], alpha.offsets, W)
    ptrans = ds.dense_patch_grids(fx["win_tpl"], fx["win_trans"],
                                  fx["tables"], fx["wlens"])
    NB = -(-Jm // ds.PB)
    i32 = torch.int32
    args = (alpha.vals, beta.vals, rbase.contiguous(), rnext.contiguous(),
            alpha.offsets.to(i32).contiguous(),
            scale_prefix(alpha.log_scales).contiguous(),
            scale_suffix(beta.log_scales).contiguous(),
            fx["win_tpl"].to(i32).contiguous(), fx["win_trans"].contiguous(),
            ptrans.contiguous(), fx["rlens"].to(i32).contiguous(),
            torch.ones(R, NB, dtype=i32, device=alpha.vals.device))
    launches0 = ds.dense_score.launches
    got = ds.dense_score(*args)
    want = ds.dense_score_plain(*args)
    torch.cuda.synchronize()
    p = torch.arange(Jm, device=got.device)[None, :, None]
    endoff = torch.as_tensor([1, 1, 1, 1, 0, 0, 0, 0, 1], device=got.device)
    J = fx["wlens"].to(torch.int64)[:, None, None]
    interior = (p >= 3) & (p + endoff <= J - 2)
    err = (got - want).abs()
    tol = 2e-3 + 2e-5 * want.abs()
    bad = int((interior & (err > tol)).sum())
    max_abs = float(torch.where(interior, err, 0.0).max())
    ms = cuda_ms(lambda: ds.dense_score(*args), 3)
    plain_ms = cuda_ms(lambda: ds.dense_score_plain(*args), 1)
    S = math.ceil(math.log2(W))
    n_bytes = 4 * (4 * R * nc * W + R * nc + 2 * R * (nc + 1)
                   + R * Jm * (1 + 4 + 72 + 9) + R + R * NB)
    n_ops = R * Jm * W * (14 * 3 * S + 120)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    out = {"phase": "dense_score", "reads": R, "Jm": Jm, "W": W,
           "interior_slots": int(interior.sum()), "mismatches": bad,
           "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
           "launches": ds.dense_score.launches - launches0}
    emit(out)
    if bad:
        raise AssertionError(f"dense_score disagrees with its plain version "
                             f"on {bad} interior slots")
    return out


def phase_main(chunks, truths) -> dict:
    from pbccs_tpu_torch.ops.dense_score_cuda import dense_score
    from pbccs_tpu_torch.ops.fwdbwd_cuda import fill_scan
    from pbccs_tpu_torch.pipeline import Failure, ResultTally, process_chunks

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fill_scan.launches = 0
    dense_score.launches = 0
    t0 = time.monotonic()
    tally = ResultTally()
    for lo in range(0, len(chunks), BATCH):
        tally.merge(process_chunks(chunks[lo: lo + BATCH], device="cuda"))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"fill_scan": fill_scan.launches,
                "dense_score": dense_score.launches}
    truth = {c.id: t for c, t in zip(chunks, truths)}
    idents = [identity(r.sequence, truth[r.id]) for r in tally.results]
    out = {"phase": "main_path", "zmws": len(chunks), "batch": BATCH,
           "tally": {f.value: c for f, c in tally.counts.items() if c},
           "bailouts": tally.bailouts,
           "yield": len(tally.results) / len(chunks),
           "identity_mean": float(np.mean(idents)) if idents else None,
           "identity_min": float(np.min(idents)) if idents else None,
           "exact": int(sum(i == 1.0 for i in idents)),
           "wall_s": wall, "zmw_per_s": len(chunks) / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches}
    emit(out)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    if tally.bailouts or tally.counts[Failure.OTHER]:
        raise AssertionError("main path lost ZMWs to bail-outs or Other")
    if tally.total != len(chunks):
        raise AssertionError(f"tally counts {tally.total} of {len(chunks)}")
    return out


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
    main_path = phase_main(chunks, truths)
    phase_cross(chunks[:N_CROSS])

    fwd, bwd = kept["fwd"][1], kept["bwd"][1]
    kernels = [
        {"name": "fill_scan", "route": "cuda",
         "source": "pbccs_tpu_torch/csrc/fill_scan.cu",
         "replaces": "pbccs_tpu/ops/fwdbwd_pallas.py:320",
         "launches": main_path["launches"]["fill_scan"],
         "max_abs_err": max(fwd["ll_max_abs_err"], bwd["ll_max_abs_err"]),
         "ms": (fwd["ms"] + bwd["ms"]) / 2,
         "plain_ms": (fwd["plain_ms"] + bwd["plain_ms"]) / 2,
         "bound_ms": (fwd["bound_ms"] + bwd["bound_ms"]) / 2,
         "bound_by": fwd["bound_by"], "library_ms": None},
        {"name": "dense_score", "route": "cuda",
         "source": "pbccs_tpu_torch/csrc/dense_score.cu",
         "replaces": "pbccs_tpu/ops/dense_score_pallas.py:238",
         "launches": main_path["launches"]["dense_score"],
         "max_abs_err": dense["max_abs_err"], "ms": dense["ms"],
         "plain_ms": dense["plain_ms"], "bound_ms": dense["bound_ms"],
         "bound_by": dense["bound_by"], "library_ms": None},
    ]
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
