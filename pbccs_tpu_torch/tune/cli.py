"""`ccs tune` subcommand of the port: run the autotuner's batch leg,
emit a host profile (port of pbccs_tpu.tune.cli, same flags).

    ccs tune --out p.json --knobs band_w,prepare_workers --tuneBudget 600
    ccs tune --out p.json --candidates band_w=64,128 --minGain -1

Prints ONE machine-readable JSON summary line (shipped?, winner, gain,
rejected candidates, referee verdict), like `ccs warmup`'s JSON report.
`--serveLeg` then sweeps the serve flush knobs (serve_max_batch,
serve_max_wait_ms) through a `ccs serve` subprocess per candidate
(driver.run_serve_leg) and merges the winner into the shipped profile.
On the card, a band_w candidate the kernels cannot polish at exits 2
before any candidate runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from pbccs_tpu_torch.runtime.logging import Logger, LogLevel
from pbccs_tpu_torch.tune import driver, space


def _parse_value(knob_name: str, text: str):
    """Candidate/--set values typed like their knob grid: int where the
    grid is ints, float where floats (mem sizes accept 512M syntax)."""
    if knob_name == "mem_budget_bytes":
        from pbccs_tpu_torch.resilience.resources import parse_size

        return parse_size(text)
    try:
        return int(text)
    except ValueError:
        return float(text)


def build_tune_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ccs tune",
        description="Sweep the performance-knob space against the perf "
                    "ledger and emit a committed per-host tuning "
                    "profile (consumed via --tuneProfile).")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="Where to write the host profile (default: "
                        "profiles/<platform>-<device_kind>.json under "
                        "the repo checkout).")
    p.add_argument("--workdir", default=None, metavar="DIR",
                   help="Scratch + journal directory (default: a fresh "
                        "temp dir; give a stable DIR with --resume to "
                        "continue a killed search).")
    p.add_argument("--resume", action="store_true",
                   help="Re-use finished candidates from the workdir's "
                        "journal instead of re-measuring them.")
    p.add_argument("--zmws", type=int, default=64,
                   help="Calibration workload ZMWs. Default = %(default)s")
    p.add_argument("--passes", type=int, default=6,
                   help="Subread passes per ZMW. Default = %(default)s")
    p.add_argument("--tplLen", type=int, default=300,
                   help="Calibration template length. "
                        "Default = %(default)s")
    p.add_argument("--chunkSize", type=int, default=64,
                   help="ZMWs per work item in the calibration run. "
                        "Default = %(default)s")
    p.add_argument("--repeat", type=int, default=3,
                   help="Calibration runs per candidate (median "
                        "decides, perf_gate's statistic). "
                        "Default = %(default)s")
    p.add_argument("--devices", type=int, default=0,
                   help="--devices forwarded to the calibration runs "
                        "(0 = all). Default = %(default)s")
    p.add_argument("--tuneBudget", type=float, default=0.0,
                   metavar="SECONDS",
                   help="Wall-clock cap on the whole search; the best "
                        "candidate measured so far ships when it "
                        "expires (0 = unbounded). Default = %(default)s")
    p.add_argument("--minGain", type=float, default=0.0,
                   help="Ship only when the winner's relative ZMW/s "
                        "gain exceeds this (negative forces a ship of "
                        "any byte-identical, referee-clean winner -- "
                        "the smoke-test mode). Default = %(default)s")
    p.add_argument("--knobs", default=None, metavar="NAME[,NAME...]",
                   help="Restrict the sweep to these knobs (default: "
                        f"{','.join(k.name for k in space.BATCH_KNOBS)}).")
    p.add_argument("--candidates", action="append", default=[],
                   metavar="KNOB=V1[,V2...]",
                   help="Replace one knob's candidate grid (repeatable), "
                        "e.g. --candidates band_w=64,128.")
    p.add_argument("--set", action="append", default=[], dest="forced",
                   metavar="KNOB=VALUE",
                   help="Force a knob into the shipped profile without "
                        "sweeping it (repeatable; e.g. "
                        "--set router_spill_depth=4 for knobs the batch "
                        "leg cannot measure).")
    p.add_argument("--serveLeg", action="store_true",
                   help="Also sweep the serve flush knobs through a "
                        "`ccs serve` subprocess per candidate.")
    p.add_argument("--seed", type=int, default=20260807,
                   help="Calibration workload seed. Default = %(default)s")
    p.add_argument("--logLevel", default="INFO")
    return p


def _default_out(device=None) -> str:
    from pbccs_tpu_torch.tune.profile import host_fingerprint

    fp = host_fingerprint(device)
    name = f"{fp['platform']}-{fp['device_kind']}.json".replace(" ", "_")
    return os.path.join(driver._REPO_ROOT, "profiles", name)


def run_tune(argv: list[str] | None = None, *, device=None) -> int:
    """`ccs tune`; `device` names the device whose fingerprint a shipped
    profile carries (None: the card the calibration runs polish on)."""
    args = build_tune_parser().parse_args(argv)
    log = Logger.default(Logger(level=LogLevel.from_string(args.logLevel)))
    knob_names = args.knobs.split(",") if args.knobs else None
    if knob_names:
        for name in knob_names:
            if space.knob_by_name(name) is None:
                print(f"ccs tune: --knobs: unknown knob {name!r}",
                      file=sys.stderr)
                return 2
    overrides: dict[str, tuple] = {}
    for spec in args.candidates:
        name, _, values = spec.partition("=")
        if space.knob_by_name(name) is None or not values:
            print(f"ccs tune: --candidates: want KNOB=V1[,V2...], "
                  f"got {spec!r}", file=sys.stderr)
            return 2
        try:
            overrides[name] = tuple(_parse_value(name, v)
                                    for v in values.split(","))
        except ValueError as e:
            print(f"ccs tune: --candidates {spec!r}: {e}",
                  file=sys.stderr)
            return 2
    forced: dict = {}
    for spec in args.forced:
        name, _, value = spec.partition("=")
        if name not in space.KNOB_TARGETS or not value:
            print(f"ccs tune: --set: want KNOB=VALUE with a declared "
                  f"knob, got {spec!r}", file=sys.stderr)
            return 2
        try:
            forced[name] = _parse_value(name, value)
        except ValueError as e:
            print(f"ccs tune: --set {spec!r}: {e}", file=sys.stderr)
            return 2

    # every band_w a candidate would run at must be one the card can
    # polish at: refused here, not as a candidate failing mid-search
    from pbccs_tpu_torch.cli import band_width_refused

    knobs = space.batch_space(knob_names, overrides)
    widths = [w for k in knobs if k.name == "band_w" for w in k.candidates]
    if "band_w" in forced:
        widths.append(forced["band_w"])
    if band_width_refused(device, widths):
        return 2

    workdir = args.workdir or tempfile.mkdtemp(prefix="ccs_tune_")
    out_path = args.out or _default_out(device)
    cfg = driver.TuneConfig(
        workdir=workdir, out_path=out_path,
        zmws=args.zmws, passes=args.passes, tpl_len=args.tplLen,
        chunk_size=args.chunkSize, seed=args.seed, repeat=args.repeat,
        budget_s=args.tuneBudget, min_gain=args.minGain,
        devices=args.devices,
        knobs=knobs,
        forced=forced, resume=args.resume, device=device, log=log)
    log.info(f"tune: workdir {workdir}; sweeping "
             f"{[k.name for k in cfg.knobs]} over a "
             f"{args.zmws}x{args.passes}x{args.tplLen} calibration "
             f"workload, repeat={args.repeat}")
    summary = driver.run_search(cfg)
    if args.serveLeg and "error" not in summary:
        serve_knobs: dict = {}
        summary["serve_leg"] = driver.run_serve_leg(cfg, serve_knobs)
        if serve_knobs and summary.get("shipped"):
            # re-ship with the serve winners merged in
            import dataclasses

            from pbccs_tpu_torch.tune.profile import (load_profile,
                                                      save_profile)

            prof, _ = load_profile(out_path)
            if prof is not None:
                prof = dataclasses.replace(
                    prof, knobs={**prof.knobs, **serve_knobs})
                save_profile(prof, out_path)
                summary["profile_id"] = prof.profile_id
    print(json.dumps(summary, sort_keys=True))
    log.flush()
    if "error" in summary:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(run_tune())
