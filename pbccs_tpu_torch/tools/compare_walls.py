#!/usr/bin/env python3
"""Phases 4 and 10 of chip_smoke.py from two checkouts, in turns, on one card.

    python3 pbccs_tpu_torch/tools/compare_walls.py OTHER_CHECKOUT

Runs chip_smoke.py's main path (phase 4: process_chunks over the 64
simulated 2 kb ZMWs in two batches of 32) and its CLI phase (phase 10:
the same ZMWs as a P6-C4 subread BAM through the batch CLI, and the same
run on one worker thread) from OTHER_CHECKOUT and from this checkout, in
the order other, this, this, other.  Each run is a fresh process in its
checkout's root: it builds that checkout's kernels, simulates the draw
from chip_smoke.SEED and warms up on 4 ZMWs before phase 4.  Prints one
JSON line per run (the card's name and power limit, phase 4's wall,
launches and peak memory, phase 10's walls, launches and peak memory)
and exits non-zero if a run fails.  Needs a CUDA device."""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: what each run executes in its checkout's root
RUN = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as c
from pbccs_tpu_torch.ops import cuda_lib
from pbccs_tpu_torch.pipeline import process_chunks
cuda_lib.build()
rng = np.random.default_rng(c.SEED)
chunks, truths = c.simulate_chunks(rng, c.N_ZMWS, c.TPL_LEN, c.PASSES)
process_chunks(chunks[:4], device="cuda")
torch.cuda.synchronize()
main, _ = c.phase_main(chunks, truths)
cli = c.phase_cli(chunks, truths, main)
print("COMPARE " + json.dumps({
    "card": c.card_line(),
    "phase4_wall_s": main["wall_s"], "phase4_launches": main["launches"],
    "phase4_max_memory_allocated": main["max_memory_allocated"],
    "phase10_wall_s": cli["wall_s"],
    "phase10_one_worker_wall_s": cli["one_worker_wall_s"],
    "phase10_launches": cli["launches"],
    "phase10_max_memory_allocated": cli["max_memory_allocated"]}))
"""


def run_in(tree: str, label: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                          capture_output=True, text=True, timeout=1200)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("COMPARE ")), None)
    if proc.returncode != 0 or line is None:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"compare_walls: the run in {tree} failed "
                         f"(exit {proc.returncode})")
    return {"tree": label, **json.loads(line[len("COMPARE "):])}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    for tree, label in ((other, "other"), (HERE, "this"), (HERE, "this"),
                        (other, "other")):
        print(json.dumps(run_in(tree, label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
