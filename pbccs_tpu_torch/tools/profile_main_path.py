#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA card.

    python3 pbccs_tpu_torch/tools/profile_main_path.py

Runs chip_smoke.py's workload (2 kb simulated ZMWs, 3-10 passes, the same
numpy seed, batches of 32) through the two halves of process_chunks --
the host draft stage (pipeline.prepare_batch) and the device polish
(pipeline._polish_batch_arrow) -- once to warm up, then once under
torch.profiler with CPU and CUDA activities.  Prints one JSON line:
host-draft and polish wall seconds, device busy time (the union of CUDA
kernel intervals) and the device's idle share of the polish wall time,
the number of kernel launches, and CUDA time grouped by kernel
(fill_scan, dense_score, and PyTorch's own kernels by operator).  Needs
a CUDA device; exits non-zero without one."""

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


def kernel_group(name: str) -> str:
    """A short group name for a CUDA kernel: our kernels by name,
    PyTorch's by the functor or operator its template names."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith(("fill_scan_kernel", "dense_score_kernel")):
        return name.split("(")[0]
    for pat in (r"where_kernel", r"\w*Functor\w*<\w+>", r"\w+_kernel\w*"):
        m = re.search(pat, name)
        if m:
            return m.group(0)
    return name[:60]


def run(chunks, settings, batch: int):
    """Host draft and device polish of every batch; returns seconds."""
    t_draft = t_polish = 0.0
    for lo in range(0, len(chunks), batch):
        t0 = time.monotonic()
        _, preps = pipeline.prepare_batch(chunks[lo: lo + batch], settings)
        t1 = time.monotonic()
        if preps:
            pipeline._polish_batch_arrow(preps, settings,
                                         torch.device("cuda"))
        torch.cuda.synchronize()
        t_draft += t1 - t0
        t_polish += time.monotonic() - t1
    return t_draft, t_polish


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(chip_smoke.SEED)
    chunks, _ = chip_smoke.simulate_chunks(rng, chip_smoke.N_ZMWS,
                                           chip_smoke.TPL_LEN,
                                           chip_smoke.PASSES)
    settings = pipeline.ConsensusSettings()
    run(chunks, settings, chip_smoke.BATCH)                  # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t_draft, t_polish = run(chunks, settings, chip_smoke.BATCH)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e3
        g = kernel_group(e.name)
        by_name[g] = by_name.get(g, 0.0) + dur
    busy_ms = _union_ms((e.time_range.start, e.time_range.end)
                        for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    print(json.dumps({
        "card": chip_smoke.card_line(), "zmws": chip_smoke.N_ZMWS,
        "draft_s": t_draft, "polish_s": t_polish,
        "device_busy_ms": busy_ms,
        "device_idle_share_of_polish": 1.0 - busy_ms / (t_polish * 1e3),
        "kernel_launches": len(kernels),
        "cuda_ms_total": sum(by_name.values()),
        "cuda_ms_by_kernel": dict(top[:20])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
