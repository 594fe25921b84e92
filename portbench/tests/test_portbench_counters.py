"""The readers of the program's counters (metrics/*.py) on readings made
by hand: the share of refined reads the refine shed, and the share of
guided refills kept; each reads nothing where its denominator is 0 (a
program that lacks the counters, or a cell that runs no guided pass)."""

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


def _reading(**counters):
    return devtrace.Reading([], [], 0.0, 1000.0, [],
                            {(k, ()): float(v) for k, v in counters.items()},
                            [], 64, 0)


def test_shed_read_pct():
    read = _reader("shed_read_pct")
    assert read(_reading(ccs_refine_reads_total=192,
                         ccs_refine_reads_shed_total=12)) == \
        pytest.approx(6.25)
    assert read(_reading(ccs_refine_reads_total=192)) == 0.0
    assert read(_reading(ccs_refine_reads_shed_total=3)) is None
    assert read(_reading()) is None


def test_guided_keep_pct():
    read = _reader("guided_keep_pct")
    assert read(_reading(ccs_fill_guided_reads_total=576,
                         ccs_fill_guided_kept_total=144)) == \
        pytest.approx(25.0)
    assert read(_reading(ccs_fill_guided_reads_total=576)) == 0.0
    assert read(_reading(ccs_fill_guided_kept_total=5)) is None
    assert read(_reading()) is None
