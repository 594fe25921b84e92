#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA card.

    python3 pbccs_tpu_torch/tools/profile_main_path.py           # Arrow
    python3 pbccs_tpu_torch/tools/profile_main_path.py quiver    # Quiver

Runs chip_smoke.py's workload (2 kb simulated ZMWs, 3-10 passes, the same
numpy seed) through the two halves of process_chunks -- the host draft
stage (pipeline.prepare_batch) and the device polish -- once to warm up,
then once under torch.profiler with CPU and CUDA activities.  Arrow
polishes the 64 ZMWs in batches of 32 (pipeline._polish_batch_arrow);
Quiver polishes ZMW by ZMW (pipeline.polish_prepared), warming up on
the draw's second ZMW and profiling its first.  Prints one JSON line:
host-draft and polish wall seconds, device busy time (the union of CUDA
kernel intervals) and the device's idle share of the polish wall time,
the number of kernel launches (and of each of the port's kernels), CUDA
time grouped by kernel (arrow_fill, quiver_fill, dense_score, and
PyTorch's own kernels by operator), the CUDA time of the port's kernels
and of everything else (the torch glue and copies), and the CUDA time
and launches of the torch glue in each stage of
device_refine.score_slot_grid (its trace spans, device_refine.STAGES,
which enter the profiler as ranges while a tracer is installed: the
profiled run installs one).  Needs a CUDA device; exits non-zero
without one."""

from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import chip_smoke  # noqa: E402
from pbccs_tpu_torch import pipeline  # noqa: E402
from pbccs_tpu_torch.obs import trace as obs_trace  # noqa: E402
from pbccs_tpu_torch.parallel.device_refine import STAGES  # noqa: E402


def _union_ms(intervals) -> float:
    """Total length of the union of (start_us, end_us) intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


#: name prefixes of the port's hand-written kernels (csrc/*.cu)
OUR_KERNELS = ("arrow_fill_kernel", "quiver_fill_kernel", "dense_score_kernel")


def stage_totals(events, names) -> dict:
    """CUDA ms and kernel launches under each torch.profiler range named in
    `names` (the kernels attached to the range's CPU events and to all
    their descendants), summed over the range's occurrences.  The port's
    own kernels, launched through ctypes and not from a PyTorch operator,
    are not attached to any range: this counts the torch glue of each
    stage, and cuda_ms_by_kernel holds the port's kernels."""
    def kernels(e):
        out = list(e.kernels)
        for ch in e.cpu_children:
            out += kernels(ch)
        return out

    totals = {n: {"cuda_ms": 0.0, "launches": 0} for n in names}
    for e in events:
        if e.name in totals and e.device_type == torch.autograd.DeviceType.CPU:
            ks = kernels(e)
            totals[e.name]["cuda_ms"] += sum(k.duration for k in ks) / 1e3
            totals[e.name]["launches"] += len(ks)
    return totals


def kernel_group(name: str) -> str:
    """A short group name for a CUDA kernel: our kernels by name,
    PyTorch's by the functor or operator its template names."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith(OUR_KERNELS):
        return name.split("(")[0]
    for pat in (r"where_kernel", r"\w*Functor\w*<\w+>", r"\w+_kernel\w*"):
        m = re.search(pat, name)
        if m:
            return m.group(0)
    return name[:60]


def run(chunks, settings, batch: int):
    """Host draft and device polish of every batch; returns seconds."""
    dev = torch.device("cuda")
    t_draft = t_polish = 0.0
    for lo in range(0, len(chunks), batch):
        t0 = time.monotonic()
        _, preps = pipeline.prepare_batch(chunks[lo: lo + batch], settings)
        t1 = time.monotonic()
        if settings.model == "quiver":
            for p in preps:
                pipeline.polish_prepared(p, settings, device=dev)
        elif preps:
            pipeline._polish_batch_arrow(preps, settings, dev)
        torch.cuda.synchronize()
        t_draft += t1 - t0
        t_polish += time.monotonic() - t1
    return t_draft, t_polish


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    model = sys.argv[1] if len(sys.argv) > 1 else "arrow"
    rng = np.random.default_rng(chip_smoke.SEED)
    chunks, _ = chip_smoke.simulate_chunks(rng, chip_smoke.N_ZMWS,
                                           chip_smoke.TPL_LEN,
                                           chip_smoke.PASSES)
    settings = pipeline.ConsensusSettings(model=model)
    if model == "quiver":
        warm, chunks, batch = chunks[1:2], chunks[:1], 1
    else:
        warm, batch = chunks, chip_smoke.BATCH
    run(warm, settings, batch)                               # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prev = obs_trace.set_tracer(obs_trace.Tracer())
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t_draft, t_polish = run(chunks, settings, batch)
    finally:
        obs_trace.set_tracer(prev)
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name: dict[str, float] = {}
    counts: dict[str, int] = {}
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e3
        g = kernel_group(e.name)
        by_name[g] = by_name.get(g, 0.0) + dur
        if g.startswith(OUR_KERNELS):
            counts[g] = counts.get(g, 0) + 1
    busy_ms = _union_ms((e.time_range.start, e.time_range.end)
                        for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    ours = sum(v for k, v in by_name.items() if k.startswith(OUR_KERNELS))
    print(json.dumps({
        "card": chip_smoke.card_line(), "model": model, "zmws": len(chunks),
        "draft_s": t_draft, "polish_s": t_polish,
        "device_busy_ms": busy_ms,
        "device_idle_share_of_polish": 1.0 - busy_ms / (t_polish * 1e3),
        "kernel_launches": len(kernels),
        "cuda_ms_total": sum(by_name.values()),
        "cuda_ms_port_kernels": ours,
        "cuda_ms_glue": sum(by_name.values()) - ours,
        "port_kernel_launches": counts,
        "cuda_ms_by_kernel": dict(top[:20]),
        "slot_grid_stages": stage_totals(events, STAGES)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
