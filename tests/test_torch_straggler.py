"""The port's straggler continuation (parallel.batch.BatchPolisher.refine
with device_refine.run_refine_loop's early exit at Z // 32 live ZMWs)
against the port's own uninterrupted loop and pbccs_tpu's host loop.

The draw (SEED): 33 simulated ZMWs of 60-70 bp with 4 passes.  ZMW 0's
draft carries a cluster of CLUSTER substitutions two bases apart, closer
than RefineOptions' mutation_separation (10), so it needs many more
rounds than the others, whose drafts are the truth or carry one
substitution.  SMALL (ZMWs 0-3) is the small batch that the forced
exits, the plumbing test and pbccs_tpu's host loop polish.

Tolerances: the port against itself, templates and RefineResults equal
(n_tested included) and, where the continuation runs at the parent's Z,
QVs equal; across batch sizes QVs within 1.  Against pbccs_tpu's host
loop (PBCCS_DEVICE_REFINE=0, tests/conftest.py) the standard of
tests/test_torch_device_refine.py::_assert_same_refine: RefineResults
and templates equal, QVs within 1."""

import types

import numpy as np
import pytest
import torch

from pbccs_tpu_torch.models.arrow.refine import RefineOptions
from pbccs_tpu_torch.obs import flight as obs_flight
from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.parallel import device_refine as tdr
from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask
from pbccs_tpu_torch.parallel.mesh import make_zmw_mesh
from pbccs_tpu_torch.simulate import simulate_zmw

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SEED = 20261018
N_ZMWS = 33          # Z // 32 = 1: the loop exits at one live ZMW
CLUSTER = 12         # ZMW 0's substitutions, at 15, 17, ..., 37
SMALL = 4


def _draw() -> list[tuple]:
    """ZmwTask arguments of the 33 ZMWs (numpy inputs, both packages)."""
    rng = np.random.default_rng(SEED)
    out = []
    for z in range(N_ZMWS):
        tpl, reads, strands, snr = simulate_zmw(
            rng, int(rng.integers(60, 71)), 4)
        draft = tpl.copy()
        if z == 0:
            for p in range(15, 15 + 2 * CLUSTER, 2):
                draft[p] = (draft[p] + 1 + p % 3) % 4
        elif z % 2:
            p = int(rng.integers(10, len(tpl) - 10))
            draft[p] = (draft[p] + 1) % 4
        out.append((f"s/{z}", draft, snr, list(reads), list(strands),
                    [0] * len(reads), [len(draft)] * len(reads)))
    return out


DRAW = _draw()


def _polish(args, opts=None, *, stop_after=None, monkeypatch=None, **kw):
    """(polisher, results, QVs) of the port over ZmwTask args on the CPU.
    `stop_after` = k shims run_refine_loop so that its first call (the
    parent's loop) stops after its k-th round, a forced early exit at
    any Z (tests/test_device_refine.py's trick for pbccs_tpu)."""
    if stop_after is not None:
        real = tdr.run_refine_loop
        calls = []

        def shim(grid, *, max_iterations, **loop_kw):
            calls.append(grid)
            if len(calls) == 1:
                max_iterations = grid[0][0].st.it + stop_after
            return real(grid, max_iterations=max_iterations, **loop_kw)

        monkeypatch.setattr(tdr, "run_refine_loop", shim)
    pol = BatchPolisher([ZmwTask(*a) for a in args], device="cpu", **kw)
    res = pol.refine(opts or RefineOptions())
    qvs = pol.consensus_qvs()
    if stop_after is not None:
        monkeypatch.setattr(tdr, "run_refine_loop", real)
    return pol, res, qvs


def _same(a_res, a_tpls, b_res, b_tpls):
    assert [vars(r) for r in a_res] == [vars(r) for r in b_res]
    for a, b in zip(a_tpls, b_tpls):
        np.testing.assert_array_equal(a, b)


def _qvs_within(a, b, tol):
    for x, y in zip(a, b):
        assert len(x) == len(y)
        if len(x):
            assert np.abs(x.astype(int) - y.astype(int)).max() <= tol


@pytest.fixture(scope="module")
def full():
    """The port's run of all 33 ZMWs (Z = 33: the loop exits at one live
    ZMW), with the flight recorder's rounds that run recorded."""
    flight = obs_flight.default_recorder()
    seq0 = max((r["seq"] for r in flight.snapshot()), default=0)
    pol, res, qvs = _polish(DRAW)
    recs = [r for r in flight.snapshot() if r["seq"] > seq0]
    return pol, res, qvs, recs


@pytest.fixture(scope="module")
def small():
    """The port's uninterrupted run of SMALL (Z = 4: no early exit)."""
    pol, res, qvs = _polish(DRAW[:SMALL])
    assert not pol._cont.sub_polishers
    return pol, res, qvs


@pytest.fixture(scope="module")
def jax_small():
    """pbccs_tpu's host loop over SMALL: (results, templates, QVs)."""
    from pbccs_tpu.models.arrow.refine import RefineOptions as JOptions
    from pbccs_tpu.parallel.batch import BatchPolisher as JPolisher
    from pbccs_tpu.parallel.batch import ZmwTask as JTask

    pol = JPolisher([JTask(*a) for a in DRAW[:SMALL]])
    res = pol.refine(JOptions())
    return res, pol.tpls, pol.consensus_qvs()


def test_early_exit_continues_as_the_uninterrupted_loop(full, small,
                                                        jax_small):
    """(a) A real early exit: at Z = 33 the loop stops at one live ZMW
    and ZMW 0 finishes in a Z = 4 sub-batch.  Every ZMW's template and
    RefineResult equal the port's run in batches of at most 31 (no early
    exit), QVs within 1; ZMW 0 holds against pbccs_tpu's host loop."""
    tag = f"straggler/{DRAW[0][0]}+1"
    pol, res, qvs, recs = full
    assert pol._Z == N_ZMWS and pol.straggler_shape_min_z() == 4
    assert set(pol._cont.sub_polishers) == {0}
    sub, row = pol._cont.sub_polishers[0]
    assert row == 0
    assert sub._Z == 4 and sub._flight_tag == tag
    assert (sub._Imax, sub._Jmax, sub._R, sub._W) == (
        pol._Imax, pol._Jmax, pol._R, pol._W)
    # the parent's rounds, then the sub's at their true round numbers
    parent = sorted(r["round"] for r in recs
                    if r["batch"] == pol._flight_tag)
    subs = sorted(r["round"] for r in recs if r["batch"] == tag)
    assert parent == list(range(len(parent))) and subs
    assert subs == list(range(len(parent), res[0].iterations))
    assert max(r.iterations for r in res[1:]) <= len(parent)

    shapes = (pol._Imax, pol._Jmax, pol._R)
    ref_pol, ref_res, ref_qvs = _polish(DRAW[SMALL:], buckets=shapes)
    assert not ref_pol._cont.sub_polishers
    s_pol, s_res, s_qvs = small
    assert (s_pol._Imax, s_pol._Jmax, s_pol._R) == shapes
    _same(res, pol.tpls, s_res + ref_res, s_pol.tpls + ref_pol.tpls)
    _qvs_within(qvs, s_qvs + ref_qvs, 1)

    j_res, j_tpls, j_qvs = jax_small
    _same(res[:1], pol.tpls[:1], j_res[:1], j_tpls[:1])
    _qvs_within(qvs[:1], j_qvs[:1], 1)


@pytest.mark.parametrize("k", [1, 2])
def test_forced_exit_gives_the_uninterrupted_results(k, small, jax_small,
                                                     monkeypatch):
    """(b) At Z = 4 the parent's loop is cut after round k: the sub-batch,
    at the parent's Z, carries the loop state over and gives the
    uninterrupted run's templates, RefineResults (n_tested included) and
    QVs bit for bit, on pbccs_tpu's host-loop standard too."""
    pol, res, qvs = _polish(DRAW[:SMALL], stop_after=k,
                            monkeypatch=monkeypatch)
    s_pol, s_res, s_qvs = small
    live = [z for z, r in enumerate(s_res) if r.iterations > k]
    assert sorted(pol._cont.sub_polishers) == live and 0 in live
    _same(res, pol.tpls, s_res, s_pol.tpls)
    for a, b in zip(qvs, s_qvs):
        np.testing.assert_array_equal(a, b)
    j_res, j_tpls, j_qvs = jax_small
    _same(res, pol.tpls, j_res, j_tpls)
    _qvs_within(qvs, j_qvs, 1)


def test_continuation_is_traced(small, monkeypatch):
    """The continuation is the trace span polish.straggler (args zmws,
    sub_z) around the sub-batch's build and loop: one polish.round per
    pass of either loop, the sub-batch's under polish.straggler at the
    round numbers the parent left, and the results unchanged."""
    tracer = obs_trace.Tracer()
    monkeypatch.setattr(obs_trace, "_tracer", tracer)
    pol, res, _ = _polish(DRAW[:SMALL], stop_after=1,
                          monkeypatch=monkeypatch)
    s_pol, s_res, _ = small
    _same(res, pol.tpls, s_res, s_pol.tpls)
    spans = tracer.finished_spans()
    strag, = [s for s in spans if s.name == "polish.straggler"]
    assert strag.args == {"zmws": len(pol._cont.sub_polishers),
                          "sub_z": pol.straggler_shape_min_z()}
    rounds = [s for s in spans if s.name == "polish.round"]
    assert len(rounds) == max(r.iterations for r in s_res)
    assert [s.parent for s in rounds[:1]] == [None]
    assert all(s.parent is strag for s in rounds[1:])
    assert [s.args["round"] for s in rounds] == list(range(len(rounds)))
    assert rounds[1].args["live"] == len(pol._cont.sub_polishers)


def test_continuation_plumbing(monkeypatch):
    """(c) tests/test_device_refine.py's plumbing test for the port: the
    budget holds across parent and sub, the straggler's QVs come from
    the sub-polisher, a skipped straggler gets empty QVs with no sub
    sweep, and a second refine() after the continuation is safe: it
    rebuilds the parent's fills from the current templates and runs at
    the parent's Z on pbccs_tpu's standard (the ZMWs that did not
    continue are held bit for bit against a polisher that never
    continued, every QV within 1 of it)."""
    opts = RefineOptions(max_iterations=4)
    pol, res, qvs = _polish(DRAW[:SMALL], opts, stop_after=2,
                            monkeypatch=monkeypatch)
    ref, ref_res, ref_qvs = _polish(DRAW[:SMALL], opts)
    assert 0 in pol._cont.sub_polishers
    assert not res[0].converged and res[0].iterations == 4
    assert all(r.iterations <= 4 for r in res)
    _same(res, pol.tpls, ref_res, ref.tpls)
    for a, b in zip(qvs, ref_qvs):
        np.testing.assert_array_equal(a, b)

    late = set(pol._cont.sub_polishers)     # one sub-polisher for all
    sub, _ = pol._cont.sub_polishers[0]
    sub_q = sub.consensus_qvs()
    for z, (s, i) in pol._cont.sub_polishers.items():
        assert s is sub
        np.testing.assert_array_equal(sub_q[i], qvs[z])
    assert late <= pol._cont.qv_cache[0]    # the parent's sweep skipped them
    monkeypatch.setattr(sub, "consensus_qvs", None)   # no sub sweep now
    q = pol.consensus_qvs(skip=late)
    for z in range(SMALL):
        if z in late:
            assert len(q[z]) == 0
        else:
            np.testing.assert_array_equal(q[z], qvs[z])
    monkeypatch.undo()

    again = RefineOptions(max_iterations=3)
    res2, ref_res2 = pol.refine(again), ref.refine(again)
    assert not pol._cont.sub_polishers and not pol._cont.stale_fills
    assert all(r.iterations <= 3 for r in res2)
    kept = [z for z in range(SMALL) if z not in late]
    _same([res2[z] for z in kept], [pol.tpls[z] for z in kept],
          [ref_res2[z] for z in kept], [ref.tpls[z] for z in kept])
    _qvs_within(pol.consensus_qvs(), ref.consensus_qvs(), 1)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_no_continuation_under_a_mesh(grid, full):
    """(d) Under a mesh of CPU devices, 1 x 1 included, the 33 ZMWs'
    loop runs to its end with no continuation (pbccs_tpu's sharded loop
    has no early exit) and gives the unsharded run's templates and
    RefineResults, QVs within 1."""
    pol, res, qvs, _ = full
    mesh_pol, mesh_res, mesh_qvs = _polish(
        DRAW, mesh=make_zmw_mesh(*grid, ["cpu"] * (grid[0] * grid[1])))
    assert mesh_pol._Z >= N_ZMWS and not mesh_pol._cont.sub_polishers
    assert mesh_res[0].iterations > max(r.iterations for r in mesh_res[1:])
    _same(res, pol.tpls, mesh_res, mesh_pol.tpls)
    _qvs_within(qvs, mesh_qvs, 1)


def test_lone_straggler_polishes_at_its_own_z(full):
    """A batch of no more ZMWs than Z // 32 -- the straggler alone,
    pinned to the 33-ZMW batch's shapes, as a quarantine bisection's
    padded part is -- has no early exit: it polishes at Z = 33 with no
    continuation and gives its record in the whole batch (where it
    finished in a Z = 4 sub-batch): template and RefineResult equal, QVs
    within 1."""
    pol, res, qvs, _ = full
    pin = (pol._Imax, pol._Jmax, pol._R, pol._Z)
    one, one_res, one_qvs = _polish(DRAW[:1], buckets=pin)
    assert one._Z == N_ZMWS and not one._cont.sub_polishers
    assert one_res[0].iterations == res[0].iterations > 1
    _same(one_res, one.tpls, res[:1], pol.tpls[:1])
    _qvs_within(one_qvs, qvs[:1], 1)


@pytest.mark.parametrize("z", [4, 31, 32, 33, 64, 512, 1024])
def test_straggler_shape_min_z_matches_pbccs_tpu(z):
    """(e) The sub-batch's Z, next_pow2(max(Z // 32, 1), 4), from each
    package's own method."""
    from pbccs_tpu.parallel.batch import BatchPolisher as JPolisher

    me = types.SimpleNamespace(_Z=z)
    want = JPolisher.straggler_shape_min_z(me)
    assert BatchPolisher.straggler_shape_min_z(me) == want
    assert want == max(4, 1 << max(z // 32 - 1, 0).bit_length())
