"""The readers of the program's polish spans (metrics/*.py) on readings
made by hand: the setup's device time per ZMW from the kernels under
the `polish.setup` and `polish.gates` profiler ranges, a round's idle
time from the `polish.round` profiler ranges against the
kernels, and the straggler continuation's share of the refine loop;
each reads nothing where its spans or kernels are absent."""

from __future__ import annotations

import importlib.util
import os

import pytest

from portbench_helpers import BENCH

import devtrace


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", os.path.join(BENCH, "metrics",
                                                 f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reading(kernels=(), host=(), spans=()):
    return devtrace.Reading(list(kernels), list(host), 0.0, 1000.0,
                            list(spans), {}, [], 8, 0)


def test_setup_device_ms_per_zmw():
    read = _reader("setup_device_ms_per_zmw")
    host = [("polish.setup", 0.0, 100.0), ("polish.gates", 100.0, 150.0),
            ("polish.refine", 150.0, 400.0),
            ("polish.setup", 500.0, 600.0), ("polish.gates", 610.0, 700.0)]
    kernels = [("k", 20.0, 60.0), ("k", 40.0, 120.0), ("k", 300.0, 350.0),
               ("k", 550.0, 680.0), ("k", 690.0, 760.0)]
    spans = [("polish.setup", 0.1, {"zmws": 4}),
             ("polish.setup", 0.1, {"zmws": 6}),
             ("polish.refine", 0.25, {"zmws": 4})]
    # setup 1: busy 20-120 (100 us); setup 2: busy 550-680 and 690-700
    # (140 us); the refine's kernel and the tail past the gates are not
    # the setup's
    assert read(_reading(kernels, host, spans)) == pytest.approx(0.024)
    # host-timed spans only (the CPU), or spans outside the profiler
    assert read(_reading([], host, spans)) is None
    assert read(_reading(kernels, [], spans)) is None
    # a setup whose gates range the window lacks reads nothing
    assert read(_reading(kernels, host[:4], spans)) is None
    assert read(_reading()) is None


def test_round_idle_ms():
    read = _reader("round_idle_ms")
    host = [("polish.round", 0.0, 100.0), ("polish.round", 200.0, 300.0),
            ("polish.refine", 0.0, 400.0)]
    kernels = [("k", 10.0, 20.0), ("k", 15.0, 40.0), ("k", 90.0, 210.0),
               ("k", 250.0, 260.0), ("k", 500.0, 900.0)]
    # round 1: covered 10-40 and 90-100, idle 60 us; round 2: covered
    # 200-210 and 250-260, idle 80 us
    assert read(_reading(kernels, host)) == pytest.approx(0.070)
    assert read(_reading([], host)) is None
    assert read(_reading(kernels, host[2:])) is None


def test_straggler_wall_pct():
    read = _reader("straggler_wall_pct")
    host = [("polish.refine", 0.0, 100.0), ("polish.round", 0.0, 10.0),
            ("polish.straggler", 50.0, 75.0),
            # a continuation outside the refine loop (the band retry's)
            ("polish.straggler", 200.0, 210.0)]
    assert read(_reading(host=host)) == pytest.approx(25.0)
    assert read(_reading(host=host[:2])) == 0.0
    # a program that records no rounds reads nothing
    assert read(_reading(host=host[:1] + host[2:])) is None
