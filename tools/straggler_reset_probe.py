#!/usr/bin/env python
"""pbccs_tpu's straggler continuation against its own host loop, on the CPU.

    python tools/straggler_reset_probe.py

Polishes the SMALL batch of tests/test_torch_straggler.py (ZMWs 0-3 of
its draw, numpy seed SEED there) with pbccs_tpu's host loop
(PBCCS_DEVICE_REFINE=0) and with its device loop, the loop's first call
cut after round k (k = 1, 2) so that BatchPolisher.refine continues the
live ZMWs in a straggler sub-batch (the trick of
tests/test_device_refine.py's plumbing test: the real early exit needs
Z >= 33, too slow to compile on the CPU).  Prints one JSON line per run:
its label and, per ZMW, the RefineResult and whether the template equals
the host loop's.  pbccs_tpu's sub-batch starts its nearby filter and
template-hash ring empty (pbccs_tpu/parallel/batch.py:1213-1214), so a
straggler's first round there tests every position.  The port's
continuation carries both over (pbccs_tpu_torch/parallel/batch.py)."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _small_batch() -> list[tuple]:
    spec = importlib.util.spec_from_file_location(
        "straggler_draw", os.path.join(REPO, "tests",
                                       "test_torch_straggler.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.DRAW[: mod.SMALL]


def _polish(args, device_loop: bool, stop_after: int | None = None):
    from pbccs_tpu.models.arrow.refine import RefineOptions
    from pbccs_tpu.parallel import device_refine as dr
    from pbccs_tpu.parallel.batch import BatchPolisher, ZmwTask

    os.environ["PBCCS_DEVICE_REFINE"] = "1" if device_loop else "0"
    real, calls = dr.run_refine_loop, []

    def cut(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            kw = dict(kw, max_iterations=stop_after)
        return real(*a, **kw)

    if stop_after is not None:
        dr.run_refine_loop = cut
    try:
        pol = BatchPolisher([ZmwTask(*a) for a in args])
        res = pol.refine(RefineOptions())
    finally:
        dr.run_refine_loop = real
    return pol, res, sorted(pol._cont.sub_polishers)


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    args = _small_batch()
    host, host_res, _ = _polish(args, device_loop=False)
    runs = [("host loop", host, host_res, [])]
    for k in (1, 2):
        runs.append((f"device loop cut after round {k}",
                     *_polish(args, device_loop=True, stop_after=k)))
    for label, pol, res, continued in runs:
        print(json.dumps({
            "run": label, "continued": continued,
            "zmws": [dict(vars(r), template_equals_host_loop=bool(
                len(t) == len(h) and (t == h).all()))
                for r, t, h in zip(res, pol.tpls, host.tpls)]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
