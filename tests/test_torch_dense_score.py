"""Dense interior and window-frame edge slot scores of the PyTorch port
(plain versions on the CPU) against the JAX package, on the SAME fill
state: the JAX fills are carried into the port with convert.fill_from_numpy.

Tolerances: interior scores rtol 2e-5 / atol 2e-3 on interior slots (the
dense kernel's own contract, tests/test_dense_score.py); edge scores the
same on their valid slots; patch grids, read windows and the splice /
orientation mapping exactly equal (pure selects)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pbccs_tpu.models.arrow import scorer as jscorer
from pbccs_tpu.ops import dense_score_pallas as jds

from pbccs_tpu_torch import convert
from pbccs_tpu_torch.ops import dense_score_cuda as tds

from test_torch_fwdbwd import make_case

W = 64
RTOL, ATOL = 2e-5, 2e-3
_ENDOFF = np.array([1, 1, 1, 1, 0, 0, 0, 0, 1])


def _filled(seed, clip):
    """A case plus its JAX fill state, in both packages' types."""
    c = make_case(seed, L=140, n_reads=4, clip=clip)
    j = {k: jnp.asarray(c[k]) for k in ("reads", "rlens", "win_tpl",
                                         "win_trans", "wlens")}
    fill = jscorer.fill_alpha_beta_batch(
        j["reads"], j["rlens"], j["win_tpl"], j["win_trans"], j["wlens"], W,
        use_pallas=False)
    R = c["reads"].shape[0]
    tables = np.broadcast_to(c["table"], (R, 8, 4)).copy()
    return c, j, fill, convert.fill_from_numpy(fill), tables


def _port_inputs(c):
    return [torch.as_tensor(c[k]) for k in ("reads", "rlens", "win_tpl",
                                            "win_trans", "wlens")]


@pytest.mark.parametrize("seed,clip", [(11, False), (12, True)])
def test_patch_grids_and_read_windows_equal(seed, clip):
    c, j, fill, st, tables = _filled(seed, clip)
    reads, rlens, wt, wtr, wl = _port_inputs(c)
    got = tds.dense_patch_grids(wt, wtr, torch.as_tensor(tables), wl)
    want = np.stack([np.asarray(jds.dense_patch_grids(
        j["win_tpl"][r].astype(jnp.int32), j["win_trans"][r],
        jnp.asarray(tables[r]), j["wlens"][r])) for r in range(len(tables))])
    np.testing.assert_array_equal(got.numpy(), want)
    rb, rn = tds.band_read_windows(reads, st.alpha.offsets, W)
    jrb, jrn = jds.band_read_windows(j["reads"], fill[0].offsets, W)
    np.testing.assert_array_equal(rb.numpy(), np.asarray(jrb))
    np.testing.assert_array_equal(rn.numpy(), np.asarray(jrn))


@pytest.mark.parametrize("seed,clip", [(13, False), (14, True)])
def test_dense_interior_matches_pallas(seed, clip):
    c, j, fill, st, tables = _filled(seed, clip)
    reads, rlens, wt, wtr, wl = _port_inputs(c)
    got = tds.dense_interior_scores_batch(
        reads, rlens, wt, wtr, wl, torch.as_tensor(tables), st.alpha,
        st.beta, st.apre, st.bsuf, W).numpy()
    want = np.asarray(jds.dense_interior_scores_batch(
        j["reads"], j["rlens"], j["win_tpl"], j["win_trans"], j["wlens"],
        jnp.asarray(tables), fill[0], fill[1], fill[4], fill[5], W))
    Jm = c["Jmax"]
    p = np.arange(Jm)[None, :, None]
    interior = (p >= 3) & (p + _ENDOFF <= c["wlens"][:, None, None] - 2)
    assert interior.sum() > 1000
    np.testing.assert_allclose(got[interior], want[interior], rtol=RTOL,
                               atol=ATOL)


def test_dense_live_mask_zeroes_dead_blocks():
    c, j, fill, st, tables = _filled(15, False)
    reads, rlens, wt, wtr, wl = _port_inputs(c)
    R = reads.shape[0]
    NB = -(-c["Jmax"] // tds.PB)
    live = torch.zeros(R, NB, dtype=torch.bool)
    live[0, 1] = True
    got = tds.dense_interior_scores_batch(
        reads, rlens, wt, wtr, wl, torch.as_tensor(tables), st.alpha,
        st.beta, st.apre, st.bsuf, W, live=live)
    full = tds.dense_interior_scores_batch(
        reads, rlens, wt, wtr, wl, torch.as_tensor(tables), st.alpha,
        st.beta, st.apre, st.bsuf, W)
    blk = slice(tds.PB, 2 * tds.PB)
    np.testing.assert_array_equal(got[0, blk].numpy(), full[0, blk].numpy())
    assert not got[1:].any() and not got[0, :tds.PB].any()


@pytest.mark.parametrize("seed,clip", [(16, False), (17, True)])
def test_edge_scores_match(seed, clip):
    c, j, fill, st, tables = _filled(seed, clip)
    reads, rlens, wt, wtr, wl = _port_inputs(c)
    ptrans = tds.dense_patch_grids(wt, wtr, torch.as_tensor(tables), wl)
    got = tds.edge_window_scores_batch(
        reads, rlens, wt, wtr, wl, st.alpha, st.beta, st.apre, st.bsuf,
        ptrans, W).numpy()
    want = np.asarray(jds.edge_window_scores_batch(
        j["reads"], j["rlens"], j["win_tpl"], j["win_trans"], j["wlens"],
        fill[0], fill[1], fill[4], fill[5], jnp.asarray(ptrans.numpy()), W))
    # valid edge slots: rows 0..2 = positions 0..2; rows 3..5 = J-2..J
    # (ins at J-2 is interior; at J only insertions exist)
    mask = np.ones((6, 9), bool)
    mask[3] = jds._NE_MASK9[0]
    mask[5, [0, 1, 2, 3, 8]] = False
    m = np.broadcast_to(mask, got.shape)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL)


def test_splice_and_template_mapping_equal():
    rng = np.random.default_rng(18)
    R, Jm, Jmax = 5, 40, 48
    grid = rng.normal(size=(R, Jm, 9)).astype(np.float32)
    e6 = rng.normal(size=(R, 6, 9)).astype(np.float32)
    J = np.array([40, 33, 20, 8, 12], np.int32)
    strand = np.array([0, 1, 0, 1, 1], np.int32)
    ts = np.array([0, 3, 10, 30, 2], np.int32)
    te = ts + J
    got = tds.splice_edge_rows(torch.as_tensor(grid), torch.as_tensor(e6),
                               torch.as_tensor(J))
    mapped = tds.window_grid_to_template(got, torch.as_tensor(strand),
                                         torch.as_tensor(ts),
                                         torch.as_tensor(te), Jmax)
    for r in range(R):
        want = jds.splice_edge_rows(jnp.asarray(grid[r]), jnp.asarray(e6[r]),
                                    jnp.int32(J[r]))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
        wm = jds.window_grid_to_template(want, jnp.int32(strand[r]),
                                         jnp.int32(ts[r]), jnp.int32(te[r]),
                                         Jmax)
        np.testing.assert_array_equal(mapped[r].numpy(), np.asarray(wm))
