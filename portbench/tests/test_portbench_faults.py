"""A run with the timed polish broken underneath comes out not correct:
the harness's look for a card skipped, everything else of a run driven
on the CPU at a small size, once for each fault a cell can have
(faults.py), and once sound."""

from __future__ import annotations

import pytest

from portbench_helpers import SMALL, scratch_copy

import faults
import run


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    # passes 3-10 over 8 ZMWs: low-pass drafts keep errors for the
    # unchanged refine to show, high-pass reads outvote an altered base
    root = scratch_copy(tmp_path_factory.mktemp("faults"),
                        insert_length=300, passes=(3, 10), pool=8)
    return run.Cell(SMALL, root=root)


def _polish():
    from pbccs_tpu_torch import pipeline

    return pipeline.polish_prepared_batch


def test_a_sound_run_is_correct(cell):
    res, lines = run.run(cell, 2**31 + 101, 0.0, False, allow_cpu=True)
    assert res["correct"], lines


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_a_broken_polish_is_not_correct(cell, name):
    res, lines = run.run(cell, 2**31 + 101, 0.0, False, allow_cpu=True,
                         polish=faults.FAULTS[name](_polish()))
    assert not res["correct"], lines
