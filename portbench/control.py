#!/usr/bin/env python3
"""The readings the correctness limits of a cell are set from.

    python3 portbench/control.py --workload NAME --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults unchanged,half_batch,...] \
        [--out FILE]

In one process on the card, for each seed: the cell's set-up (pool,
draft, one warm batch), one batch of the timed polish and the check
batch (run.check_batch), judged as a run judges them (run.judged): the
lower readings.  For each control seed the same samples are judged again
with the reference computed with every value rounded to bfloat16
standing in the program's place (the configuration states float32), and
with --faults one more window batch and check batch are polished and
judged under each fault of faults.py: the upper readings.  Prints one
JSON line per seed and appends it to --out.  The benchmark's own runs
never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as harness

import arrow_ref
import faults


def readings(cell, seed: int, device, control: bool,
             fault_names=()) -> dict:
    import torch

    prog, settings, pool, batches = harness.setup(cell, seed, device)
    out, secs = harness.window(prog, settings, batches, device, 0.0, 1)
    prepared, cpool = harness.check_prepared(prog, settings, cell, seed)
    z = int(cell.traffic["batch"])

    def check(polish=None):
        res, _ = harness.window(prog, settings,
                                harness.batches_of(prepared, z), device,
                                0.0, 1, polish)
        return res

    sets = [(out, pool), (check(), cpool)]
    torch.cuda.empty_cache()
    row = {"workload": cell.name, "seed": seed, "batch_s": secs}
    t = time.perf_counter()
    row["program"] = harness.judged(cell, seed, device, sets)
    row["reference_s"] = time.perf_counter() - t
    if control:
        row["control"] = harness.judged(
            cell, seed, device, sets, arith=arrow_ref.Arith("bfloat16"),
            control=True)
    for name in fault_names:
        broken = faults.FAULTS[name](prog.pipeline.polish_prepared_batch)
        out, _ = harness.window(prog, settings, batches, device, 0.0, 1,
                                broken)
        row[name] = harness.judged(cell, seed, device,
                                   [(out, pool), (check(broken), cpool)])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="faults.FAULTS to plant on the control seeds")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.prepare_env()
    cell = harness.Cell(args.workload)
    device = harness.open_device(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(ctl - set(seeds)):
        row = readings(cell, seed, device, seed in ctl,
                       [f for f in args.faults.split(",") if f]
                       if seed in ctl else ())
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
