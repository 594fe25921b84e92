"""The benchmark as data: its cells load by name, a cell, a traffic mix,
a configuration and a per-layer metric come in as new files and entries
alone, the yardstick's copies equal the program's arithmetic, and no
module of the benchmark loads JAX or the JAX package."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench_helpers import BENCH, ROOT, SMALL, scratch_copy

import bench_roofline
import edit_qv
import run

FORBIDDEN = {"jax", "jaxlib", "flax", "pbccs_tpu", "bench"}
#: the reference side, which may not import the program either
REFERENCE = ("arrow_ref.py", "judge.py", "edit_qv.py", "bench_sim.py",
             "bench_roofline.py")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_workloads_load_as_data():
    bench = _bench()
    names = {m["name"] for m in bench["per_layer"]}
    for w in bench["workloads"]:
        cell = run.Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert int(cell.traffic["batch"]) >= 1
        assert set(cell.limits) == set(run.judge.NUMBERS)
        assert {m["name"] for m in cell.per_layer} <= names
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_cell_config_mix_and_metric_run_as_added_files(tmp_path):
    root = scratch_copy(tmp_path)
    with open(os.path.join(root, "portbench", "metrics",
                           "spans_per_zmw.py"), "w") as fh:
        fh.write('"""Program spans per ZMW of the window."""\n\n\n'
                 "def read(r):\n"
                 "    return len(r.spans) / r.zmws if r.zmws else None\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["per_layer"].append({
        "name": "spans_per_zmw", "unit": "1/ZMW", "better": "lower",
        "source": "program_span", "layer": "polish", "moves": "zmws_per_s",
        "workloads": [SMALL]})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    before = _digests(root)
    cell = run.Cell(SMALL, root=root)
    res, lines = run.run(cell, 2**31 + 17, 0.0, True, allow_cpu=True)
    assert res["correct"], lines
    assert res["metrics"]["spans_per_zmw"]["value"] > 0
    assert list(res)[-1] == "checks"
    res, lines = run.run(cell, 2**31 + 17, 0.0, False, allow_cpu=True)
    assert res["correct"], lines
    assert set(res["metrics"]) == {"zmws_per_s", "yield_pct",
                                   "consensus_qv", "setup_s"}
    assert res["attempted"] == 4
    assert _digests(root) == before


def test_roofline_copy_matches_the_port():
    from pbccs_tpu_torch.obs import roofline as port

    for R, Imax, Jmax, W in ((384, 2304, 2112, 96), (32, 640, 576, 64),
                             (4, 16384, 16768, 96)):
        for dirs in ((False, True), (False,), (True,)):
            assert bench_roofline.k1_work(R, Imax, Jmax, W, dirs) == \
                port.k1_work(R, Imax, Jmax, W, dirs)
        for pos, blocks in ((None, None), (1000, 40)):
            assert bench_roofline.k3_work(R, Jmax + 1, Imax, Jmax, W, pos,
                                          blocks) == \
                port.k3_work(R, Jmax + 1, Imax, Jmax, W, pos, blocks)
    for work in ((1e9, 1e12, 1e10), (1e12, 1e9, 1e9)):
        assert bench_roofline.bound_seconds(*work) == \
            port.bound_seconds(*work)
    # per-read arrays give the sum of the per-read counts
    I, J = np.array([100, 200]), np.array([90, 210])
    arr = bench_roofline.k1_work(1, I, J, 64)
    one = [bench_roofline.k1_work(1, i, j, 64) for i, j in zip(I, J)]
    assert [int(a.sum()) for a in arr] == [sum(o[k] for o in one)
                                           for k in range(3)]


@pytest.mark.parametrize("a,b,d", [
    ("ACGT", "ACGT", 0), ("ACGT", "AGT", 1), ("", "ACG", 3),
    ("ACGTACGT", "ACGAACGT", 1), ("AAAA", "TTTT", 4),
    ("GATTACA", "GCATGCT", 4), ("ACGTTGCA" * 40, "ACGTGCA" * 40, 40)])
def test_edit_distance(a, b, d):
    assert edit_qv.edit_distance(a, b) == d
    assert edit_qv.edit_distance(b, a) == d


def test_window_finds_the_stretch_a_read_aligns_to():
    assert edit_qv.window("ACGTAC", "TTTTACGTACGGG") == (4, 10)
    assert edit_qv.window("ACGAAC", "TTTTACGTACGGG") == (4, 10)
    assert edit_qv.best_end("GGG", "AAAGGGAAA") == 6


def test_errors_against_truth_follows_the_strand():
    rng = np.random.default_rng(3)
    truth = edit_qv.decode(rng.integers(0, 4, 400))
    seq = edit_qv.revcomp(truth[:150] + "A" + truth[150:300] + truth[301:])
    assert edit_qv.errors_against_truth(seq, truth) == 2
    assert edit_qv.errors_against_truth(truth, truth) == 0
    assert edit_qv.phred(0, 999) == pytest.approx(30.0)
    assert edit_qv.phred(9, 999) == pytest.approx(20.0)


def _top_imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_module_loads_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(BENCH)
             for f in fs if f.endswith(".py")]
    assert files
    for path in files:
        found = _top_imports(path) & FORBIDDEN
        assert not found, (path, found)
    for f in REFERENCE:
        assert "pbccs_tpu_torch" not in _top_imports(
            os.path.join(BENCH, f)), f
    assert run.forbidden_modules() == []
    assert "pbccs_tpu_torch" not in run.FORBIDDEN
    sys.modules["pbccs_tpu.fake"] = sys
    try:
        assert run.forbidden_modules() == ["pbccs_tpu"]
    finally:
        del sys.modules["pbccs_tpu.fake"]


def test_refuses_to_measure_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    w = _bench()["workloads"][0]["name"]
    cmd = [sys.executable, "portbench/run.py", "--workload", w, "--seed",
           str(2**31 + 5), "--seconds", "1", "--trace", "0"]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr
    # a directory with only BENCHMARK.json and the benchmark's files
    alone = scratch_copy(tmp_path)
    proc = subprocess.run(cmd, cwd=alone, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
