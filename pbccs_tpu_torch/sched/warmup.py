"""`ccs warmup` of the port: build the kernels and count a declared
bucket menu's cost cards before traffic (port of
pbccs_tpu.sched.warmup).

What a warmup leaves for a later `ccs` process is what survives the
process: the kernel libraries in the build cache, the port's persistent
compile cache (`--compileCache DIR`, else build/kernels/ of the
checkout; runtime/cache.py and ops/cuda_lib.py, counted under
``ccs_compiles_total`` and ``ccs_compile_cache_events_total{kind}``),
which a serve fleet pointed at the same DIR loads instead of building;
and each bucket's roofline cost card in the card cache
(obs/roofline.cards_path).  The allocator, the CUDA context, the loaded
libraries and the memory governor's ceilings end with the process, and
the kernels are built as sm_90a machine code (no driver JIT cache), so
the port drives no synthetic batch: pbccs_tpu's drive fills an XLA
compile cache that has no counterpart here.  Each `--bucket
ZxPASSESxLEN` names a bucket by workload geometry: Z ZMWs per batch,
PASSES subreads per ZMW, LEN-base templates.

By default each bucket is reported for ONE device; `--allDevices`
reports every selected device.

    python -m pbccs_tpu_torch.cli warmup --bucket 32x10x2000

Prints one JSON report: the build cache's directory (`compile_cache`),
on the card the kernel libraries loaded and the compiles and cache hits
and misses that took (`kernels`), and `warmed` entries with `bucket`,
`device`, `seconds`, `shapes` (what a matching batch polishes at) and
the bucket's roofline `cost_card`; a bucket whose refine loop can exit
early for stragglers (parallel.batch.straggler_exit_at) also gets a `straggler` entry with
the shapes and the cost card of its straggler sub-batch (pbccs_tpu's
warm_straggler_shapes warms those shapes; the port has nothing to warm
for them but the kernels).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from pbccs_tpu_torch.runtime.logging import Logger, LogLevel


def parse_bucket(spec: str) -> tuple[int, int, int]:
    """'ZxPASSESxLEN' -> (n_zmws, n_passes, tpl_len)."""
    parts = spec.lower().split("x")
    if len(parts) != 3:
        raise SystemExit(
            f"--bucket {spec!r}: want ZxPASSESxLEN, e.g. 64x8x300")
    try:
        z, p, length = (int(x) for x in parts)
    except ValueError:
        raise SystemExit(
            f"--bucket {spec!r}: want ZxPASSESxLEN, e.g. 64x8x300") from None
    if min(z, p, length) < 1:
        raise SystemExit(
            f"--bucket {spec!r}: want three positive ints ZxPASSESxLEN")
    return z, p, length


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ccs warmup",
        description="Build the kernels and count each declared workload "
                    "bucket's shapes and cost card (the kernel build of "
                    "a fresh checkout, paid before traffic).")
    p.add_argument("--bucket", action="append", default=None,
                   metavar="ZxPASSESxLEN",
                   help="One bucket by workload geometry: Z ZMWs per "
                        "batch, PASSES subreads per ZMW, LEN-base "
                        "templates.  Repeatable.  May be omitted when "
                        "--tuneProfile supplies a warmup_buckets menu.")
    p.add_argument("--tuneProfile", default=None, metavar="PATH|auto",
                   help="ccs-tune host profile to apply (band width) so "
                        "the warmed shapes match what a tuned run will "
                        "request; its warmup_buckets menu is the default "
                        "--bucket list.  'auto' scans the profiles/ "
                        "directory for a fingerprint match.  Default: "
                        "PBCCS_TUNE_PROFILE, else no profile.")
    p.add_argument("--devices", type=int, default=0,
                   help="Devices visible to the warmed fleet (0 = all; "
                        "bounds what --allDevices warms). "
                        "Default = %(default)s")
    p.add_argument("--allDevices", action="store_true",
                   help="Report every bucket on every device (default: "
                        "one device).")
    p.add_argument("--compileCache", default=None, metavar="DIR",
                   help="Kernel build-cache directory to populate -- "
                        "point the serve fleet's --compileCache at the "
                        "same DIR so replica (re)starts load the warmed "
                        "kernel libraries instead of building them "
                        "(default: build/kernels/ of the checkout, else "
                        "~/.cache/pbccs_tpu_torch/kernels).")
    p.add_argument("--logLevel", default="INFO")
    return p


def _bucket_shapes(n_zmws: int, n_passes: int, tpl_len: int) -> dict:
    """The shapes a batch of this geometry polishes at, from the reads
    of one simulated ZMW of the bucket (BatchPolisher's derivation; the
    read-length bucket is coarse enough that one ZMW settles it)."""
    from pbccs_tpu_torch.models.arrow.params import (BandingOptions,
                                                     effective_band_width)
    from pbccs_tpu_torch.parallel.batch import effective_shapes
    from pbccs_tpu_torch.simulate import simulate_zmw

    rng = np.random.default_rng(20260729)
    max_read = max(len(r) for r in simulate_zmw(rng, tpl_len, n_passes)[1])
    imax, jmax, r, z = effective_shapes(n_zmws, n_passes, max_read, tpl_len)
    return {"Z": z, "R": r, "Jmax": jmax, "Imax": imax,
            "W": effective_band_width(BandingOptions(), jmax)}


def _straggler_shapes(shapes: dict, n_zmws: int) -> dict | None:
    """The shapes of a bucket's straggler sub-batch (the bucket's Imax,
    Jmax, R and W at parallel.batch.straggler_sub_z of its Z), or None
    when a batch of n_zmws ZMWs at those shapes has no early exit
    (parallel.batch.straggler_exit_at)."""
    from pbccs_tpu_torch.parallel.batch import (straggler_exit_at,
                                                straggler_sub_z)

    if not straggler_exit_at(shapes["Z"], n_zmws):
        return None
    return dict(shapes, Z=straggler_sub_z(shapes["Z"]))


def _card_doc(card) -> dict:
    return {"label": card.label, "flops": card.flops,
            "bytes_accessed": card.bytes_accessed,
            "peak_hbm_bytes": card.peak_hbm_bytes,
            "intensity": card.intensity, "card_z": card.z}


def _load_kernels(log) -> dict:
    """Build (or find built) and load every kernel library; returns the
    libraries, the seconds that took, and its compile and cache counts."""
    from pbccs_tpu_torch.obs.metrics import default_registry
    from pbccs_tpu_torch.ops import cuda_lib

    scope = default_registry().scope()
    t0 = time.monotonic()
    cuda_lib.load_all(cuda_lib.KERNELS)
    out = {"libraries": [cuda_lib.lib_path(n) for n in cuda_lib.KERNELS],
           "seconds": time.monotonic() - t0,
           "compiles": int(scope.counter_value("ccs_compiles_total")),
           "cache_hits": int(scope.counter_value(
               "ccs_compile_cache_events_total", kind="hit")),
           "cache_misses": int(scope.counter_value(
               "ccs_compile_cache_events_total", kind="miss"))}
    log.info(f"warmup: kernels {out}")
    return out


def run_warmup(argv: list[str] | None = None, *, device=None) -> int:
    """`ccs warmup`; `device` as the CLI's run() takes it (None: the
    cards; "cpu": CPU workers running the kernels' plain versions)."""
    args = build_parser().parse_args(argv)
    log = Logger.default(Logger(level=LogLevel.from_string(args.logLevel)))

    from pbccs_tpu_torch.runtime import tuning

    tuning.configure(args.tuneProfile, logger=log, device=device)
    from pbccs_tpu_torch.cli import band_width_refused

    if band_width_refused(device):
        return 2
    if not args.bucket:
        args.bucket = tuning.knob_str_list("warmup_buckets")
    if not args.bucket:
        raise SystemExit(
            "ccs warmup: --bucket is required (no applied tune profile "
            "supplies a warmup_buckets menu)")
    entries = [parse_bucket(b) for b in args.bucket]

    from pbccs_tpu_torch.runtime.cache import enable_compilation_cache

    out: dict = {"compile_cache": enable_compilation_cache(args.compileCache)}

    from pbccs_tpu_torch.sched.pool import device_name, select_devices

    try:
        devices = select_devices(args.devices, device)
    except ValueError as e:
        raise SystemExit(f"--devices: {e}") from None
    targets = devices if args.allDevices else devices[:1]
    if any(d.type == "cuda" for d in targets):
        out["kernels"] = _load_kernels(log)

    from pbccs_tpu_torch.models.arrow.scorer import guided_fill_passes
    from pbccs_tpu_torch.obs import roofline

    report = []
    for (z, passes, length) in entries:
        t0 = time.monotonic()
        shapes = _bucket_shapes(z, passes, length)
        for dev in targets:
            name = device_name(dev)
            # the bucket's cost card, counted from its shapes and kept in
            # the card cache (roofline.cards_path) for later processes
            card = roofline.note_bucket(
                imax=shapes["Imax"], jmax=shapes["Jmax"], r=shapes["R"],
                z=shapes["Z"], width=shapes["W"],
                guided_passes=guided_fill_passes(shapes["Jmax"]),
                device=dev)
            entry = {"bucket": f"{z}x{passes}x{length}", "device": name,
                     "seconds": round(time.monotonic() - t0, 2),
                     "shapes": shapes}
            if card is not None:
                entry["cost_card"] = _card_doc(card)
            sub = _straggler_shapes(shapes, z)
            if sub is not None:
                # its own card at its Z: the sub-batch polishes under the
                # bucket's label, so the card cache keeps the bucket's
                entry["straggler"] = {"shapes": sub}
                if card is not None:
                    entry["straggler"]["cost_card"] = _card_doc(
                        roofline.card_from_shapes(
                            imax=sub["Imax"], jmax=sub["Jmax"], r=sub["R"],
                            z=sub["Z"], width=sub["W"],
                            guided_passes=guided_fill_passes(sub["Jmax"]),
                            platform=roofline.device_platform(dev)))
            report.append(entry)
            log.info(f"warmup: {entry['bucket']} on {name}: shapes "
                     f"{shapes}")
    out["warmed"] = report
    cards_file = roofline.cards_path()
    if cards_file:
        out["roofline_cards"] = cards_file
    print(json.dumps(out))
    log.flush()
    return 0


if __name__ == "__main__":
    sys.exit(run_warmup())
