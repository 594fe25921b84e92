"""Banded fills of the PyTorch port (pbccs_tpu_torch, plain versions on the
CPU) against the JAX package on identical inputs.

Inputs are simulated from a numpy seed and handed to both packages as
numpy arrays.  Tolerances: log-likelihoods within 1e-4 absolute (the
Pallas-vs-pure-JAX contract, fwdbwd_pallas.py:45-47: the Hillis-Steele
and associative-scan forms round float32 differently); band offsets and
read windows exactly equal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pbccs_tpu.models.arrow import scorer as jscorer
from pbccs_tpu.ops import fwdbwd as jfb
from pbccs_tpu.ops import fwdbwd_pallas as jfp

from pbccs_tpu_torch.models.arrow import params as tparams
from pbccs_tpu_torch.models.arrow import scorer as tscorer
from pbccs_tpu_torch.ops import fwdbwd as tfb
from pbccs_tpu_torch.ops import fwdbwd_cuda as tfc
from pbccs_tpu_torch.simulate import simulate_zmw

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

LL_ATOL = 1e-4


def make_case(seed: int, L: int = 120, n_reads: int = 5, clip: bool = False):
    """One simulated ZMW as a flat read batch of oriented windows (numpy):
    reads (R, Imax) int8, rlens, win_tpl (R, Jmax) int8, win_trans
    (R, Jmax, 4) f32, wlens, plus the (Z=1, R) window geometry and the
    f32 transition table.  Windows are built by the port's
    oriented_window; both packages consume the same arrays."""
    rng = np.random.default_rng(seed)
    tpl, reads, strands, snr = simulate_zmw(rng, L, n_reads)
    Jmax = ((L + 16 + 63) // 64) * 64
    Imax = Jmax + 64
    table = tparams.snr_to_transition_table_host(snr).astype(np.float32)
    R = n_reads
    ts = np.zeros(R, np.int32)
    te = np.full(R, L, np.int32)
    if clip:
        ts[1::2] = 3 + np.arange(R)[1::2]
        te[::2] = L - 4 - np.arange(R)[::2]
    reads_p = np.full((R, Imax), 4, np.int8)
    rlens = np.zeros(R, np.int32)
    for i, r in enumerate(reads):
        r = np.asarray(r)
        if clip:
            r = r[: max(te[i] - ts[i] + 8, 16)]
        reads_p[i, : len(r)] = r
        rlens[i] = len(r)
    tpl_p = np.full((1, Jmax), 4, np.int8)
    tpl_p[0, :L] = tpl
    t = torch.as_tensor
    tlen = t(np.array([L], np.int32))
    tpl_r = tparams.revcomp_padded(t(tpl_p), tlen)
    win_tpl, win_trans, wlens = tscorer.oriented_window(
        t(np.asarray(strands, np.int32))[None], t(ts)[None], t(te)[None],
        t(tpl_p), tpl_r, tlen, t(table)[None])
    return dict(tpl=tpl, tpl_p=tpl_p, L=L, snr=snr, table=table,
                strands=np.asarray(strands, np.int32), ts=ts, te=te,
                reads=reads_p, rlens=rlens, win_tpl=win_tpl[0].numpy(),
                win_trans=win_trans[0].numpy(), wlens=wlens[0].numpy(),
                Jmax=Jmax)


def _port(c, name):
    return torch.as_tensor(c[name])


def _jax(c, name):
    return jnp.asarray(c[name])


def _fill_args(c, pkg):
    get = _port if pkg == "port" else _jax
    return tuple(get(c, k) for k in ("reads", "rlens", "win_tpl",
                                     "win_trans", "wlens"))


def _jax_banded(fn, c, W, offsets=None):
    """banded_forward/banded_backward (lax.scan reference) vmapped."""
    return jax.vmap(
        lambda r, i, t, tr, j, o: fn(r, i, t, tr, j, W, offsets=o),
        in_axes=(0, 0, 0, 0, 0, None if offsets is None else 0),
    )(*_fill_args(c, "jax"), offsets)


@pytest.mark.parametrize("seed,W,clip", [(1, 64, False), (2, 64, True),
                                         (3, 48, True)])
def test_forward_matches_pallas_and_scan(seed, W, clip):
    c = make_case(seed, clip=clip)
    mine = tfc.forward_batch(*_fill_args(c, "port"), W)
    ll = tfc.forward_loglik_batch(mine, _port(c, "rlens"), _port(c, "wlens"))
    pal = jfp.pallas_forward_batch(*_fill_args(c, "jax"), W)
    ll_pal = jfp.forward_loglik_batch(pal, _jax(c, "rlens"), _jax(c, "wlens"))
    ref = _jax_banded(jfb.banded_forward, c, W)
    ll_ref = jax.vmap(jfb.forward_loglik)(ref, _jax(c, "rlens"),
                                          _jax(c, "wlens"))
    np.testing.assert_array_equal(mine.offsets.numpy(), np.asarray(pal.offsets))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_pal), atol=LL_ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), atol=LL_ATOL)
    np.testing.assert_allclose(mine.vals.numpy(), np.asarray(pal.vals),
                               atol=1e-5)


@pytest.mark.parametrize("seed,W,clip", [(4, 64, False), (5, 64, True),
                                         (6, 48, True)])
def test_backward_matches_pallas_and_scan(seed, W, clip):
    c = make_case(seed, clip=clip)
    mine = tfc.backward_batch(*_fill_args(c, "port"), W)
    ll = tfc.backward_loglik_batch(mine, _port(c, "wlens"))
    pal = jfp.pallas_backward_batch(*_fill_args(c, "jax"), W)
    ll_pal = jfp.backward_loglik_batch(pal, _jax(c, "wlens"))
    ref = _jax_banded(jfb.banded_backward, c, W)
    ll_ref = jax.vmap(jfb.backward_loglik)(ref, _jax(c, "wlens"))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_pal), atol=LL_ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), atol=LL_ATOL)
    np.testing.assert_allclose(mine.vals.numpy(), np.asarray(pal.vals),
                               atol=1e-5)


def test_guided_offsets_and_guided_fills():
    """Guided rebanding: identical offsets from the same alpha, and the
    fills on those offsets agree with the JAX package."""
    W = 48
    c = make_case(7, L=100, n_reads=4)
    alpha = jfp.pallas_forward_batch(*_fill_args(c, "jax"), W)
    want = jax.vmap(lambda av, ao, i, jl: jfb.guided_band_offsets(
        av, ao, i, jl, W))(alpha.vals, alpha.offsets, _jax(c, "rlens"),
                           _jax(c, "wlens"))
    got = tfb.guided_band_offsets(torch.as_tensor(np.array(alpha.vals)),
                                  torch.as_tensor(np.array(alpha.offsets)),
                                  _port(c, "rlens"), _port(c, "wlens"), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    off_np = np.array(want)
    for fwd in (True, False):
        pfn = tfc.forward_batch if fwd else tfc.backward_batch
        jfn = jfp.pallas_forward_batch if fwd else jfp.pallas_backward_batch
        mine = pfn(*_fill_args(c, "port"), W, offsets=torch.as_tensor(off_np))
        pal = jfn(*_fill_args(c, "jax"), W, offsets=jnp.asarray(off_np))
        if fwd:
            a = tfc.forward_loglik_batch(mine, _port(c, "rlens"),
                                         _port(c, "wlens"))
            b = jfp.forward_loglik_batch(pal, _jax(c, "rlens"),
                                         _jax(c, "wlens"))
        else:
            a = tfc.backward_loglik_batch(mine, _port(c, "wlens"))
            b = jfp.backward_loglik_batch(pal, _jax(c, "wlens"))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LL_ATOL)


@pytest.mark.parametrize("guided", [0, 1])
def test_fill_alpha_beta_batch_matches(guided):
    """The scorer-level fill (with the keep-better guided refill) against
    the JAX package's Pallas path: LLs 1e-4 absolute, scale prefix and
    suffix 1e-3 absolute (f32 cumulative sums of ~1e2 log-scales)."""
    W = 64
    c = make_case(8, L=100, n_reads=4, clip=True)
    mine = tscorer.fill_alpha_beta_batch(*_fill_args(c, "port"), W,
                                         guided_passes=guided)
    ref = jscorer.fill_alpha_beta_batch(*_fill_args(c, "jax"), W,
                                        use_pallas=True,
                                        guided_passes=guided)
    np.testing.assert_array_equal(mine.alpha.offsets.numpy(),
                                  np.asarray(ref[0].offsets))
    for got, want in ((mine.ll_a, ref[2]), (mine.ll_b, ref[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LL_ATOL)
    for got, want in ((mine.apre, ref[4]), (mine.bsuf, ref[5])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("W", [16, 48, 64])
def test_window_rows_circ_matches(W):
    """The plain gather picks exactly the TPU one-hot matmul's values."""
    rng = np.random.default_rng(W)
    x = rng.integers(0, 5, size=(3, 150)).astype(np.int32)
    starts = np.sort(rng.integers(0, 140, size=(3, 40)), axis=1).astype(
        np.int32)
    got = tfc.window_rows_circ(torch.as_tensor(x), torch.as_tensor(starts), W)
    want = np.stack([np.asarray(jfp.window_rows_circ(
        jnp.asarray(x[i]), jnp.asarray(starts[i]), W)) for i in range(3)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_coefficients_match_jax():
    """The K1 operands (cm, cd, cc, mask, seed, seedcol) match the JAX
    precompute on the columns both packages fill (the TPU pads columns
    to 64 and reads to 32; those pads are dead)."""
    W = 64
    c = make_case(9, L=100, n_reads=4, clip=True)
    reads, rlens, tpls, trans, J = _fill_args(c, "port")
    nc = c["Jmax"] + 1
    I = rlens.to(torch.int32)
    offs = tfb.band_offsets(I, J.to(torch.int32), nc, W)
    got = tfc._forward_coeffs(reads.to(torch.int32), I, tpls.to(torch.int32),
                              trans, J.to(torch.int32), offs, W,
                              tparams.MISMATCH_PROBABILITY)
    offs_j = jnp.asarray(offs.numpy())
    want = jax.vmap(lambda r, i, t, tr, jl, o: jfp._forward_coeffs(
        r.astype(jnp.int32), i, t.astype(jnp.int32), tr, jl, o, W,
        tparams.MISMATCH_PROBABILITY))(*_fill_args(c, "jax"), offs_j)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))


def test_fill_scan_plain_reproduces_a_hand_column():
    """The plain scan's first interior column equals a direct solve of
    v[L] = b[L] + c[L] v[L-1] (the cut lane has c = 0), then the rescale."""
    rng = np.random.default_rng(0)
    R, nc, W = 2, 3, 8
    cm = torch.as_tensor(rng.random((R, nc, W)), dtype=torch.float32)
    cd = torch.as_tensor(rng.random((R, nc, W)), dtype=torch.float32)
    cc = torch.as_tensor(rng.random((R, nc, W)), dtype=torch.float32)
    cc[:, :, 2] = 0.0                       # the circular cut
    cc[:, 0] = 0.0                          # column 0 is the bare seed
    mask = torch.ones(R, nc)
    mask[:, 0] = 0.0
    seed = torch.zeros(R, W)
    seed[:, 2] = 1.0
    seedcol = torch.zeros(R, dtype=torch.int32)
    vals, ls = tfc.fill_scan_plain(cm, cd, cc, mask, seed, seedcol, False)
    prev = vals[:, 0].double()
    np.testing.assert_array_equal(vals[:, 0].numpy(), seed.numpy())
    b = (cm[:, 1].double() * torch.roll(prev, 1, -1)
         + cd[:, 1].double() * prev)
    v = torch.zeros(R, W, dtype=torch.float64)
    for L in range(2, 2 + W):
        Lw = L % W
        v[:, Lw] = b[:, Lw] + cc[:, 1, Lw].double() * v[:, (Lw - 1) % W]
    scale = v.max(-1, keepdim=True).values
    np.testing.assert_allclose(vals[:, 1].numpy(), (v / scale).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(ls[:, 1].numpy(), np.log(scale[:, 0].numpy()),
                               rtol=1e-5)


def test_mated_mask_matches_host_rule():
    """The port's device-side mating test equals the JAX package's host
    mated_mask on the same log-likelihoods and windows (boundary cases
    included: zero, non-finite, ratio at the tolerance, long reads)."""
    rng = np.random.default_rng(12)
    n = 400
    ll_b = -rng.uniform(50, 500, n).astype(np.float32)
    ll_a = (ll_b * (1 + rng.normal(0, 2e-3, n))).astype(np.float32)
    ll_a[:5] = [0.0, np.inf, -np.inf, np.nan, ll_b[4]]
    ll_b[5:8] = [0.0, np.nan, -np.inf]
    ts = rng.integers(0, 50, n).astype(np.int32)
    te = (ts + rng.integers(0, 60, n)).astype(np.int32)
    rl = rng.integers(1, 500, n).astype(np.int32)
    got = tscorer.mated_mask(*(torch.as_tensor(a) for a in
                               (ll_a, ll_b, rl, ts, te)))
    want = jscorer.mated_mask(ll_a, ll_b, rl, ts, te)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ftz_flushes_exactly_the_subnormals():
    """ops.fwdbwd.ftz gives the bits of where(|x| < min normal, +0, x)
    on random float32 bit patterns and on the edge values; NaN stays
    NaN."""
    rng = np.random.default_rng(13)
    tiny = np.finfo(np.float32).tiny
    sub = np.nextafter(tiny, np.float32(0))
    edge = np.array([0.0, -0.0, tiny, -tiny, sub, -sub, 1e-45, -1e-45,
                     np.inf, -np.inf, np.nan, 1.0, -1.0,
                     np.finfo(np.float32).max], np.float32)
    x = np.concatenate([rng.integers(-2**31, 2**31, 200_000, np.int64)
                        .astype(np.int32).view(np.float32), edge])
    got = tfb.ftz(torch.as_tensor(x)).numpy()
    want = np.where(np.abs(x) < tiny, np.float32(0.0), x)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
