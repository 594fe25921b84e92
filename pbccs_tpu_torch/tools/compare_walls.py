#!/usr/bin/env python3
"""Phases 4, 10 and 19 (c) of chip_smoke.py from two checkouts, in turns,
on one card.

    python3 pbccs_tpu_torch/tools/compare_walls.py OTHER_CHECKOUT

Runs chip_smoke.py's main path (phase 4: process_chunks over the 64
simulated 2 kb ZMWs in two batches of 32), its CLI phase (phase 10: the
same ZMWs as a P6-C4 subread BAM through the batch CLI, and the same run
on one worker thread) and config 2 (phase 19 (c): those 64 ZMWs and 960
more, drawn as phase 19 draws them, in one process_chunks batch of
1,024) from OTHER_CHECKOUT and from this checkout, in the order other,
this, this, other.  Each run is a fresh process in its checkout's root:
it builds that checkout's kernels, simulates the draw from
chip_smoke.SEED and warms up on 4 ZMWs before phase 4.  Prints one JSON
line per run (the card's name and power limit; phase 4's wall, refine
rounds, launches and peak memory; phase 10's walls, launches and peak
memory; config 2's wall, rounds, launches, dispatches and peak memory;
and, where the checkout has them, the straggler continuations of phase
4 and config 2) and exits non-zero if a run fails.  Needs a CUDA
device."""

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
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.ops import cuda_lib
from pbccs_tpu_torch.pipeline import process_chunks
cuda_lib.build()
rng = np.random.default_rng(c.SEED)
chunks, truths = c.simulate_chunks(rng, c.N_ZMWS, c.TPL_LEN, c.PASSES)
process_chunks(chunks[:4], device="cuda")
torch.cuda.synchronize()
scope = default_registry().scope()
main, main_tally = c.phase_main(chunks, truths)[:2]
rounds = scope.counter_value("ccs_refine_rounds_total", source="device")
cli = c.phase_cli(chunks, truths, main)
# config 2's draw follows cfg3's and cfg4's on phase 19's generator
rng = np.random.default_rng(c.CONFIGS_SEED)
for n, length, passes, name in (c.CFG3[:3] + ("cfg3",),
                                c.CFG4[:3] + ("cfg4",)):
    c.simulate_chunks(rng, n, length, passes, name, bulk=True)
cfg2, failed = c._leg_cfg2(rng, chunks, main_tally)
if failed:
    raise SystemExit(f"config 2: {failed}")
print("COMPARE " + json.dumps({
    "card": c.card_line(),
    "phase4_wall_s": main["wall_s"], "phase4_rounds": rounds,
    "phase4_launches": main["launches"],
    "phase4_max_memory_allocated": main["max_memory_allocated"],
    "phase4_continuations": main.get("continuations"),
    "phase10_wall_s": cli["wall_s"],
    "phase10_one_worker_wall_s": cli["one_worker_wall_s"],
    "phase10_launches": cli["launches"],
    "phase10_max_memory_allocated": cli["max_memory_allocated"],
    "cfg2_wall_s": cfg2["wall_s"], "cfg2_rounds": cfg2["rounds"],
    "cfg2_launches": cfg2["launches"], "cfg2_dispatches": cfg2["dispatches"],
    "cfg2_max_memory_allocated": cfg2["max_memory_allocated"],
    "cfg2_continuations": cfg2.get("continuations")}))
"""


def run_in(tree: str, label: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                          capture_output=True, text=True, timeout=1800)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("COMPARE ")), None)
    if proc.returncode != 0 or line is None:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"compare_walls: the run in {tree} failed "
                         f"(exit {proc.returncode})")
    return {"tree": label, **json.loads(line[len("COMPARE "):])}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.strip().splitlines()[3], file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    for tree, label in ((other, "other"), (HERE, "this"), (HERE, "this"),
                        (other, "other")):
        print(json.dumps(run_in(tree, label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
