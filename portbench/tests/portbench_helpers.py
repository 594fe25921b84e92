"""Shared helpers of the benchmark's CPU tests: imports of the harness
and a scratch copy of the benchmark with a small cell of its own."""

from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the small cell the CPU tests run: config 2's file with shorter
#: inserts, in batches of 4 (or `pool`)
SMALL = "small.z4"


def scratch_copy(tmp, insert_length: int = 80, passes=(3, 5),
                 base_config: str = "p6c4_2kb_3-10p", pool: int = 4) -> str:
    """A root holding BENCHMARK.json and portbench/ as committed, plus the
    cell SMALL (a new configuration, traffic mix, limits file and
    workload entry) polishing batches of the whole pool of `pool` ZMWs
    and judging half of them; returns the root."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(BENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    base = os.path.join(root, "portbench")
    with open(os.path.join(base, "configs", f"{base_config}.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="small", insert_length=insert_length,
               passes=list(passes))
    _dump(os.path.join(base, "configs", "small.json"), cfg)
    _dump(os.path.join(base, "traffic", "z4.json"),
          {"name": "z4", "batch": pool, "pool": pool, "trace_batches": 1,
           "check_zmws": max(2, pool // 2), "content_seed": 5})
    shutil.copy(os.path.join(base, "limits", f"{base_config}.json"),
                os.path.join(base, "limits", "small.json"))
    bench["workloads"].append({"name": SMALL, "config": "small",
                               "traffic": "z4", "chips": 1,
                               "why": "a CPU-sized cell of the tests"})
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + [SMALL]
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def _dump(path, doc) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
