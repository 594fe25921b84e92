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
    got, fb = tdr.score_slot_grid(
        tst, t(reads), t(rlens), t(strands), t(table), t(real),
        *tdr.slot_grid(jmax, "cpu"), t(valid), min_fast_edge=8)
    assert fb == bool(wfb) is False
    v = np.asarray(valid)
    np.testing.assert_allclose(got.numpy()[v], np.asarray(want)[v], atol=1e-2)

    qv = tdr.qv_from_slot_grid(t(want), t(valid))
    np.testing.assert_array_equal(
        qv.numpy(), np.asarray(jdr.qv_from_slot_grid(want, valid)))


def test_tiny_window_bails():
    """A read window shorter than the edge program's minimum raises
    RefineBailout where the JAX device loop would bail to its host loop."""
    from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask
    from pbccs_tpu_torch.simulate import simulate_zmw

    rng = np.random.default_rng(7)
    tpl, reads, strands, snr = simulate_zmw(rng, 60, 4)
    reads = list(reads) + [tpl[20:25].copy()]
    task = ZmwTask("tiny", tpl, snr, reads, list(strands) + [0],
                   [0] * 4 + [20], [60] * 4 + [25])
    pol = BatchPolisher([task], device="cpu")
    with pytest.raises(tdr.RefineBailout):
        pol.refine()
