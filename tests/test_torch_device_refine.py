"""The device-resident refinement primitives of the PyTorch port against
the JAX package: candidate enumeration, greedy selection, splice, the
template hash, the nearby filter, slot-grid scoring on a carried-over
loop state, and the QV reduction.

Tolerances: the discrete primitives are exactly equal; slot-grid totals
(sums over reads of mutated-minus-baseline LLs of ~1e2 nats) within
1e-2 absolute; QVs from the same totals exactly equal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pbccs_tpu.parallel import device_refine as jdr

from pbccs_tpu_torch import convert
from pbccs_tpu_torch.parallel import device_refine as tdr

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _templates(seed, Z=4, Jmax=64):
    rng = np.random.default_rng(seed)
    tpl = np.full((Z, Jmax), 4, np.int8)
    lens = rng.integers(Jmax // 2, Jmax - 4, Z).astype(np.int32)
    for z, L in enumerate(lens):
        t = rng.integers(0, 4, L).astype(np.int8)
        t[5:9] = t[5]                                   # a homopolymer run
        tpl[z, :L] = t
    return tpl, lens


def test_slot_candidates_match():
    tpl, lens = _templates(1)
    Z, Jmax = tpl.shape
    allowed = np.random.default_rng(2).random((Z, Jmax)) < 0.5
    for al in (None, allowed):
        got = tdr.slot_candidates(torch.as_tensor(tpl), torch.as_tensor(lens),
                                  None if al is None else torch.as_tensor(al))
        for z in range(Z):
            want = jdr.slot_candidates(
                jnp.asarray(tpl[z]), jnp.int32(lens[z]),
                None if al is None else jnp.asarray(al[z]))
            np.testing.assert_array_equal(got[z].numpy(), np.asarray(want[4]))
    start, end, mtype, base = tdr.slot_grid(Jmax, "cpu")
    want = jdr.slot_candidates(jnp.asarray(tpl[0]), jnp.int32(lens[0]))
    for g, w in zip((start, end, mtype, base), want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sep", [1, 3, 10])
def test_greedy_selection_matches(sep):
    rng = np.random.default_rng(sep)
    Z, Jmax = 3, 50
    M = Jmax * 9
    scores = rng.normal(size=(Z, M)).astype(np.float32)
    scores[0, 40:60] = 2.0                               # exact ties
    fav = rng.random((Z, M)) < 0.3
    got = tdr.greedy_well_separated_posmajor(torch.as_tensor(scores),
                                             torch.as_tensor(fav), sep, Jmax)
    want = jax.vmap(lambda s, f: jdr.greedy_well_separated_posmajor(
        s, f, sep, Jmax))(jnp.asarray(scores), jnp.asarray(fav))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_splice_and_hash_match():
    tpl, lens = _templates(3)
    Z, Jmax = tpl.shape
    start, end, mtype, base = tdr.slot_grid(Jmax, "cpu")
    rng = np.random.default_rng(4)
    valid = tdr.slot_candidates(torch.as_tensor(tpl), torch.as_tensor(lens))
    scores = torch.as_tensor(rng.normal(size=valid.shape).astype(np.float32))
    taken = tdr.greedy_well_separated_posmajor(scores, valid & (scores > 1.0),
                                               10, Jmax)
    taken[0, :] = False
    taken[0, (lens[0] - 1) * 9 + 4] = True               # insertion near the end
    nt, nl, mtp = tdr.splice_templates(torch.as_tensor(tpl),
                                       torch.as_tensor(lens), start, mtype,
                                       base, taken)
    h = tdr.template_hash(nt, nl)
    for z in range(Z):
        wt, wl, wm = jdr.splice_templates(
            jnp.asarray(tpl[z]), jnp.int32(lens[z]), jnp.asarray(start),
            jnp.asarray(mtype), jnp.asarray(base), jnp.asarray(taken[z]))
        np.testing.assert_array_equal(nt[z].numpy(), np.asarray(wt))
        assert int(nl[z]) == int(wl)
        np.testing.assert_array_equal(mtp[z].numpy(), np.asarray(wm))
        assert int(h[z]) == int(jdr.template_hash(wt, wl))


def test_nearby_allowed_matches():
    rng = np.random.default_rng(5)
    Z, Jmax = 3, 80
    start, end, _, _ = tdr.slot_grid(Jmax, "cpu")
    fav = rng.random((Z, Jmax * 9)) < 0.01
    got = tdr.nearby_allowed(start[None], end[None], torch.as_tensor(fav), 20,
                             Jmax)
    for z in range(Z):
        want = jdr.nearby_allowed(jnp.asarray(start), jnp.asarray(end),
                                  jnp.asarray(fav[z]), 20, Jmax)
        np.testing.assert_array_equal(got[z].numpy(), np.asarray(want))


def _jax_polisher(seed):
    from pbccs_tpu.parallel.batch import BatchPolisher, ZmwTask
    from pbccs_tpu.simulate import simulate_zmw

    rng = np.random.default_rng(seed)
    tasks = []
    for z in range(3):
        tpl, reads, strands, snr = simulate_zmw(rng, 90, 5)
        draft = tpl.copy()
        draft[45] = (draft[45] + 1) % 4
        if z == 1:
            draft = np.delete(draft, 2)
        tasks.append(ZmwTask(f"g/{z}", draft, snr, reads, strands,
                             [0] * 5, [len(draft)] * 5))
    return BatchPolisher(tasks)


def test_score_slot_grid_and_qvs_match():
    """Slot-grid totals on the JAX polisher's own loop state (carried
    over), against the JAX dense path in interpret mode."""
    pol = _jax_polisher(6)
    st = pol._loop_state()
    jmax = pol._Jmax
    start, end, mtype, base, _ = jdr.slot_candidates(st.tpl[0], st.tlens[0])
    valid = jax.vmap(lambda t, L: jdr.slot_candidates(t, L)[4])(st.tpl,
                                                                 st.tlens)
    valid &= ~st.done[:, None]
    reads, rlens = pol._reads_dev, pol._rlens_dev
    strands = pol._strands_dev
    table = jnp.asarray(pol._host_tables)
    real = jnp.asarray(pol._real_rows)
    want, wfb = jdr.score_slot_grid(st, reads, rlens, strands, table, real,
                                    start, end, mtype, base, valid, chunk=512,
                                    min_fast_edge=8, dense=True)

    tst = convert.state_from_numpy(st)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    got = tdr.score_slot_grid(
        tst, t(reads), t(rlens), t(strands), t(table), t(real),
        *tdr.slot_grid(jmax, "cpu"), t(valid), min_fast_edge=8)
    assert bool(wfb) is False
    v = np.asarray(valid)
    np.testing.assert_allclose(got.numpy()[v], np.asarray(want)[v], atol=1e-2)

    qv = tdr.qv_from_slot_grid(t(want), t(valid))
    np.testing.assert_array_equal(
        qv.numpy(), np.asarray(jdr.qv_from_slot_grid(want, valid)))


def test_tiny_window_bails():
    """A read window shorter than the edge program's minimum, where the
    JAX device loop bails to its host loop, no longer bails here: its
    edge slots are scored by full refills and the loop runs to the end."""
    from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask
    from pbccs_tpu_torch.simulate import simulate_zmw

    rng = np.random.default_rng(7)
    tpl, reads, strands, snr = simulate_zmw(rng, 60, 4)
    reads = list(reads) + [tpl[20:25].copy()]
    task = ZmwTask("tiny", tpl, snr, reads, list(strands) + [0],
                   [0] * 4 + [20], [60] * 4 + [25])
    pol = BatchPolisher([task], device="cpu")
    res = pol.refine()
    assert res[0].iterations >= 1 and res[0].converged
    assert len(pol.consensus_qvs()[0]) == len(pol.tpls[0])


def _fallback_pair(make_task):
    """The same ZmwTask (numpy inputs) as a JAX and a port BatchPolisher."""
    from pbccs_tpu.parallel.batch import BatchPolisher as JPolisher
    from pbccs_tpu.parallel.batch import ZmwTask as JTask

    from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask

    args = make_task()
    return JPolisher([JTask(*args)]), \
        BatchPolisher([ZmwTask(*args)], device="cpu")


def _tiny_window_task():
    """tests/test_batch.py's tiny-window case: one read clipped to a
    6-column window at the template start."""
    from pbccs_tpu_torch.simulate import simulate_zmw

    rng = np.random.default_rng(20260729)
    tpl, reads, strands, snr = simulate_zmw(rng, 60, 5)
    reads = list(reads)
    reads[1] = reads[1][:6]
    tends = [len(tpl)] * 5
    tends[1] = 6
    return ("tiny/0", tpl, snr, reads, list(strands), [0] * 5, tends)


def _growth_task():
    """A draft that is the truth with every fifth base deleted: refinement
    puts back ~1/5 of the template and outgrows the draft's bucket."""
    from pbccs_tpu_torch.simulate import simulate_zmw

    rng = np.random.default_rng(31)
    tpl, reads, strands, snr = simulate_zmw(rng, 140, 5)
    draft = np.delete(tpl, np.arange(4, len(tpl), 5))
    return ("grow/0", draft, snr, list(reads), list(strands), [0] * 5,
            [len(draft)] * 5)


def _assert_same_refine(ref, mine, opts):
    from pbccs_tpu.models.arrow.refine import RefineOptions as JOptions

    from pbccs_tpu_torch.models.arrow.refine import RefineOptions

    rr = ref.refine(JOptions(**opts))
    rm = mine.refine(RefineOptions(**opts))
    assert [vars(r) for r in rr] == [vars(r) for r in rm]
    np.testing.assert_array_equal(mine.tpls[0], ref.tpls[0])
    qr, qm = ref.consensus_qvs()[0], mine.consensus_qvs()[0]
    assert len(qr) == len(qm)
    assert np.abs(qr.astype(int) - qm.astype(int)).max() <= 1


def test_tiny_window_matches_jax_host_loop():
    """Edge slots of the tiny window (the JAX host loop's full-refill
    fallback pairs) fold into the slot grid: every slot's total within
    2e-3 of the JAX host loop's score_mutation_arrays; the refinement and
    the QVs match it."""
    from pbccs_tpu.models.arrow import mutations as jmut

    ref, mine = _fallback_pair(_tiny_window_task)
    blk = mine._grid[0][0]
    st = blk.st
    jmax = st.tpl.shape[1]
    valid = tdr.slot_candidates(st.tpl, st.tlens)
    grid = tdr.slot_grid(jmax, "cpu")
    rows = (st.tstarts < 6) & (st.tends == 6) & blk.real_rows
    assert bool(rows.any()) and bool(st.active[rows].all())
    got = tdr.score_slot_grid(st, blk.reads, blk.rlens, blk.strands,
                              blk.table, blk.real_rows, *grid, valid,
                              min_fast_edge=8)
    want = ref.score_mutations([jmut.enumerate_unique(ref.tpls[0])])[0]
    np.testing.assert_allclose(got[0][valid[0]].numpy(), want, atol=2e-3)
    _assert_same_refine(ref, mine, {"max_iterations": 10})


def test_bucket_growth_matches_jax_host_loop():
    """A template that outgrows its bucket re-buckets and refinement goes
    on, as in the JAX host loop: same templates, results and QVs."""
    ref, mine = _fallback_pair(_growth_task)
    j0 = mine._Jmax
    assert j0 == ref._Jmax
    _assert_same_refine(ref, mine, {})
    assert mine._Jmax == ref._Jmax > j0
    assert len(mine.tpls[0]) + 2 > j0
