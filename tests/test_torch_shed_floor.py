"""The floor on reads the refine sheds: no Success from a ZMW whose full
passes still active when its refine ends are fewer than min_passes.

A read whose fills stop mating after a round of mutations is shed for
good (the serial scorer's rebuild, the batch loop's _update_active).
Here the shedding is forced at those two points, after the first build,
in ZMWs whose drafts carry a cluster of substitutions (so the refine
applies mutations and rebuilds over several rounds).  Each case runs
twice: with the floor, and with pipeline._passes_left standing in a
count that never trips it -- which is what the polish returned before
the floor existed.  A ZMW that keeps min_passes full passes gives the
same record both times, byte for byte (the polish time aside); one left
with fewer is TooFewPasses where the floorless run gave Success.  The
same holds on the serial path, in the batch polisher, for a ZMW that a
straggler sub-batch finishes (the mask comes from the sub-polisher) and
for one the 2x band retry adopts (from the wide polisher).  Each case
also checks the counters ccs_refine_reads_total,
ccs_refine_reads_shed_total and ccs_zmws_shed_below_min_passes_total."""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from pbccs_tpu_torch import pipeline as tp
from pbccs_tpu_torch.models.arrow.scorer import ArrowMultiReadScorer
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.parallel import batch as tbatch
from pbccs_tpu_torch.parallel import device_refine as tdr
from pbccs_tpu_torch.simulate import simulate_zmw

torch.set_num_threads(1)

SETTINGS = tp.ConsensusSettings()
PASSES = 4
#: draft substitutions two bases apart, closer than the refine's
#: mutation separation: the refine needs several rounds
CLUSTER = 6
COUNTERS = ("ccs_refine_reads_total", "ccs_refine_reads_shed_total",
            "ccs_zmws_shed_below_min_passes_total")


def _with_cluster(prep: tp.PreparedZmw) -> tp.PreparedZmw:
    css = prep.css.copy()
    for p in range(20, 20 + 2 * CLUSTER, 2):
        css[p] = (css[p] + 1 + p % 3) % 4
    return dataclasses.replace(prep, css=css)


def _prepared(seed: int, n: int, length: int, passes: int = PASSES,
              drift=None) -> list[tp.PreparedZmw]:
    chunks = []
    for z in range(n):
        rng = np.random.default_rng(seed + 100 * z)
        _, reads, _, snr = simulate_zmw(rng, length, passes)
        reads = list(reads)
        if drift is not None and z == 0:
            reads[0] = drift(rng, reads[0])
        chunks.append(tp.Chunk(f"f/{z}", [tp.Subread(f"f/{z}/{i}", r)
                                          for i, r in enumerate(reads)],
                               snr))
    _, preps = tp.prepare_batch(chunks, SETTINGS)
    assert len(preps) == n
    return [_with_cluster(p) for p in preps]


def _drifted(rng, read):
    """40 random 2-base insertions in the read's first half: its path
    drifts off the band's diagonal, so it mates at the 2x band only."""
    r = list(read)
    for p in sorted(rng.choice(np.arange(20, len(r) // 2), 40,
                               replace=False))[::-1]:
        r[p:p] = list(rng.integers(0, 4, 2))
    return np.array(r, np.int8)


def _record(outcome) -> tuple:
    failure, res = outcome
    if res is None:
        return failure.value, None
    d = dataclasses.asdict(res)
    d.pop("elapsed_ms")
    return failure.value, json.dumps(d, sort_keys=True,
                                     default=lambda x: x.tolist())


def _shed_batch(monkeypatch, drop: dict, when=lambda: True):
    """Every rebuild of the batch loop (device_refine.rebuild) sheds the
    reads drop[row] of its ZMW rows, while `when()` holds."""
    real = tbatch._update_active

    def shed(active, *args):
        out = real(active, *args)
        if when():
            out = out.clone()
            for z, reads in drop.items():
                if z < out.shape[0]:
                    out[z, reads] = False
        return out

    monkeypatch.setattr(tbatch, "_update_active", shed)


def _shed_serial(monkeypatch, drop: list):
    """Every rebuild after the serial scorer's first build sheds the reads
    in `drop` (read indices, set per ZMW by the caller)."""
    real = ArrowMultiReadScorer._rebuild

    def rebuild(self, first=False):
        real(self, first)
        if not first:
            self.active[drop] = False

    monkeypatch.setattr(ArrowMultiReadScorer, "_rebuild", rebuild)


def _floorless(monkeypatch):
    monkeypatch.setattr(tp, "_passes_left",
                        lambda preps, end: np.full(len(preps), 1 << 20))


def _counted(fn):
    scope = default_registry().scope()
    out = fn()
    delta = scope.delta()
    return out, [delta.get((name, ()), 0.0) for name in COUNTERS]


def _run_both(monkeypatch, fn):
    """(records with the floor, their counter deltas, floorless records)."""
    out, counts = _counted(fn)
    with monkeypatch.context() as m:
        _floorless(m)
        base = fn()
    return [_record(o) for o in out], counts, [_record(o) for o in base]


#: per ZMW the reads shed after the first build: all of ZMW 0's, one of
#: ZMW 1's (3 = min_passes full passes stay), none of ZMW 2's
DROP = {0: list(range(PASSES)), 1: [2]}


@pytest.mark.parametrize("path", ["serial", "batch"])
def test_zmw_shed_below_min_passes_is_too_few_passes(path, monkeypatch):
    preps = _prepared(11, 3, 100)
    if path == "batch":
        _shed_batch(monkeypatch, DROP)

        def fn():
            return tp.polish_prepared_batch(preps, SETTINGS, device="cpu")
    else:
        drop: list = []
        _shed_serial(monkeypatch, drop)

        def fn():
            out = []
            for z, p in enumerate(preps):
                drop[:] = DROP.get(z, [])
                out.append(tp.polish_prepared(p, SETTINGS, device="cpu"))
            return out

    got, counts, base = _run_both(monkeypatch, fn)
    assert [b[0] for b in base] == ["Success"] * 3
    assert got[0] == ("TooFewPasses", None)
    assert got[1:] == base[1:]
    assert counts == [3 * PASSES, PASSES + 1, 1]


def test_straggler_finished_zmw_obeys_the_floor(monkeypatch):
    """The parent loop stops after its first round (a forced early exit);
    the sub-batch that finishes the stragglers sheds ZMW 0's reads, so
    only the sub-polisher's final mask shows it."""
    preps = _prepared(12, 3, 100)
    real = tdr.run_refine_loop
    calls = []

    def shim(grid, *, max_iterations, **kw):
        calls.append(grid)
        if len(calls) % 2 == 1:      # the parent's loop of each polish
            max_iterations = grid[0][0].st.it + 1
        return real(grid, max_iterations=max_iterations, **kw)

    monkeypatch.setattr(tdr, "run_refine_loop", shim)
    _shed_batch(monkeypatch, {0: list(range(PASSES))},
                when=lambda: len(calls) % 2 == 0)
    got, counts, base = _run_both(
        monkeypatch,
        lambda: tp.polish_prepared_batch(preps, SETTINGS, device="cpu"))
    assert len(calls) == 4           # each polish continued its stragglers
    assert [b[0] for b in base] == ["Success"] * 3
    assert got[0] == ("TooFewPasses", None)
    assert got[1:] == base[1:]
    assert counts == [3 * PASSES, PASSES, 1]


def test_band_retry_adopted_zmw_obeys_the_floor(monkeypatch, caplog):
    """ZMW 0's drifted read mates only at the 2x band, so the wide
    polisher (one ZMW, Z = 1) refines it; its rebuilds shed ZMW 0's
    reads, and only the wide polisher's final mask shows it."""
    n = 5
    preps = _prepared(1, 2, 300, passes=n, drift=_drifted)
    _shed_batch(monkeypatch, {0: list(range(n))})

    def fn():
        return tp.polish_prepared_batch(preps, SETTINGS, device="cpu")

    with caplog.at_level(logging.DEBUG, logger="pbccs_tpu_torch.pipeline"):
        got, counts, base = _run_both(monkeypatch, fn)
    assert "1 adopted the 2x band" in caplog.text
    assert [b[0] for b in base] == ["Success"] * 2
    assert got[0] == ("TooFewPasses", None)
    assert got[1] == base[1]
    # reads the AddRead gate kept (the wide polisher's, for ZMW 0)
    kept = [json.loads(b[1])["status_counts"][0] for b in base]
    assert counts == [sum(kept), kept[0], 1]
