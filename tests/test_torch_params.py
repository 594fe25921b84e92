"""Model parameters, host/device tables and the numpy carry-over functions
of the PyTorch port against the JAX package.

Tolerances: float64 host tables bitwise equal, and so the float32 tables
the device runs on (their casts); transition tracks and moments built
from them within 1e-6 relative.  The direct float32 evaluation of the
SNR polynomial (snr_to_transition_table, off the polish path) agrees to
5e-6 relative: it exponentiates an f32 cubic of magnitude ~5, so one ulp
of the exponent (~5e-7) or of the frameworks' exp/pow is already ~1e-6
of the result."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pbccs_tpu.models.arrow import expectations as jexp
from pbccs_tpu.models.arrow import params as jp
from pbccs_tpu.models.arrow import scorer as jscorer
from pbccs_tpu.ops import fwdbwd_pallas as jfp

from pbccs_tpu_torch import convert
from pbccs_tpu_torch.models.arrow import expectations as texp
from pbccs_tpu_torch.models.arrow import mutations as tmut
from pbccs_tpu_torch.models.arrow import params as tp
from pbccs_tpu_torch.models.arrow import scorer as tscorer

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

F32_RTOL = 1e-6
F32_POLY_RTOL = 5e-6


def _snrs(seed, n=6):
    return np.random.default_rng(seed).uniform(4.0, 14.0, size=(n, 4))


def test_constants_bitwise():
    np.testing.assert_array_equal(tp.CONTEXT_COEFF, jp.CONTEXT_COEFF)
    assert tp.CONTEXT_COEFF.dtype == np.float64
    assert tp.MISMATCH_PROBABILITY == jp.MISMATCH_PROBABILITY
    assert (tp.TRANS_MATCH, tp.TRANS_BRANCH, tp.TRANS_STICK, tp.TRANS_DARK) \
        == (jp.TRANS_MATCH, jp.TRANS_BRANCH, jp.TRANS_STICK, jp.TRANS_DARK)


def test_slot_tables_and_qv_constants():
    from pbccs_tpu.models.arrow import mutations as jm

    np.testing.assert_array_equal(tmut._SLOT_BASES, jm._SLOT_BASES)
    np.testing.assert_array_equal(tmut._SLOT_TYPES, jm._SLOT_TYPES)
    np.testing.assert_array_equal(tmut._SLOT_ENDOFF, jm._SLOT_ENDOFF)
    assert tmut._LN10 == jm._LN10
    assert tmut.QV_SATURATED == jm.QV_SATURATED


@pytest.mark.parametrize("seq", ["ACGTTGCA", "acgtN", "", "GGGGCCCCAT"])
def test_encode_decode_revcomp(seq):
    codes = tp.encode_bases(seq)
    np.testing.assert_array_equal(codes, jp.encode_bases(seq))
    assert tp.decode_bases(codes) == jp.decode_bases(codes)
    np.testing.assert_array_equal(tp.revcomp(codes), jp.revcomp(codes))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_tables_bitwise(seed):
    for snr in _snrs(seed):
        np.testing.assert_array_equal(tp.snr_to_transition_table_host(snr),
                                      jp.snr_to_transition_table_host(snr))


@pytest.mark.parametrize("seed", [3, 4])
def test_device_tables_f32(seed):
    """The f32 tables the batch polishers upload (f64 host tables cast)
    are bitwise equal; the direct f32 evaluation agrees to 5e-6."""
    from pbccs_tpu.parallel.batch import ZmwTask as JTask
    from pbccs_tpu.parallel.batch import premarshal as jpremarshal
    from pbccs_tpu_torch.parallel.batch import ZmwTask, premarshal

    snrs = _snrs(seed)
    tpl = np.zeros(30, np.int8)
    read = [np.zeros(30, np.int8)]
    mine = premarshal([ZmwTask(str(i), tpl, s, read, [0], [0], [30])
                       for i, s in enumerate(snrs)])
    ref = jpremarshal([JTask(str(i), tpl, s, read, [0], [0], [30])
                       for i, s in enumerate(snrs)])
    assert mine.host_tables.dtype == np.float32
    np.testing.assert_array_equal(mine.host_tables, ref.host_tables)
    assert mine.shapes == ref.shapes
    for snr in snrs:
        got = tp.snr_to_transition_table(snr).numpy()
        want = np.asarray(jp.snr_to_transition_table(jnp.asarray(snr)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=F32_POLY_RTOL)


def test_band_width_schedule():
    for jmax in (64, 576, 640, 2112, 15488):
        for bw in (None, 40, 192):
            b = tp.BandingOptions(band_width=bw)
            jb = jp.BandingOptions(band_width=bw)
            assert tp.effective_band_width(b, jmax) == \
                jp.effective_band_width(jb, jmax)


def test_template_tracks_and_revcomp_padded():
    rng = np.random.default_rng(5)
    Z, Jmax = 3, 40
    tpl = np.full((Z, Jmax), 4, np.int8)
    lens = np.array([40, 25, 7], np.int32)
    for z, L in enumerate(lens):
        tpl[z, :L] = rng.integers(0, 4, L)
    tables = np.stack([tp.snr_to_transition_table_host(s)
                       for s in _snrs(6, Z)]).astype(np.float32)
    got = tp.template_transition_params(torch.as_tensor(tpl),
                                        torch.as_tensor(tables),
                                        torch.as_tensor(lens))
    got_rc = tp.revcomp_padded(torch.as_tensor(tpl), torch.as_tensor(lens))
    for z in range(Z):
        want = jp.template_transition_params(jnp.asarray(tpl[z]),
                                             jnp.asarray(tables[z]),
                                             jnp.int32(lens[z]))
        np.testing.assert_array_equal(got[z].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got_rc[z].numpy(),
            np.asarray(jp.revcomp_padded(jnp.asarray(tpl[z]),
                                         jnp.int32(lens[z]))))
        lk = tp.transition_lookup(torch.as_tensor(tpl[z]).long(),
                                  torch.roll(torch.as_tensor(tpl[z]), -1).long(),
                                  torch.as_tensor(tables[z]))
        jlk = jp.transition_lookup(jnp.asarray(tpl[z]),
                                   jnp.roll(jnp.asarray(tpl[z]), -1),
                                   jnp.asarray(tables[z]))
        np.testing.assert_array_equal(lk.numpy(), np.asarray(jlk))


def test_per_base_moments():
    rng = np.random.default_rng(7)
    tpl = rng.integers(0, 4, 60).astype(np.int8)
    table = tp.snr_to_transition_table_host(_snrs(8, 1)[0]).astype(np.float32)
    trans = np.asarray(jp.template_transition_params(
        jnp.asarray(tpl), jnp.asarray(table), jnp.int32(60)))
    m, v = texp.per_base_mean_and_variance(torch.as_tensor(trans))
    jm, jv = jexp.per_base_mean_and_variance(jnp.asarray(trans))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=F32_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


def test_arrow_params_from_numpy():
    ap = convert.arrow_params_from_numpy(np.asarray(jp.CONTEXT_COEFF),
                                         np.asarray(jp.MISMATCH_PROBABILITY))
    np.testing.assert_array_equal(ap.context_coeff, tp.CONTEXT_COEFF)
    assert ap.mismatch_probability == tp.MISMATCH_PROBABILITY
    for snr in _snrs(9):
        np.testing.assert_array_equal(ap.transition_table_host(snr),
                                      jp.snr_to_transition_table_host(snr))
    with pytest.raises(ValueError):
        convert.arrow_params_from_numpy(np.zeros((8, 4)), 0.01)


def test_banded_and_fill_from_numpy():
    """A JAX fill state carried into the port keeps its values and takes
    the port's dtypes."""
    rng = np.random.default_rng(10)
    R, Imax, Jmax, W = 3, 80, 64, 16
    tpl = rng.integers(0, 4, (R, Jmax)).astype(np.int8)
    reads = rng.integers(0, 4, (R, Imax)).astype(np.int8)
    rlens = np.array([50, 60, 64], np.int32)
    tlens = np.array([48, 60, 64], np.int32)
    table = jnp.asarray(jp.snr_to_transition_table_host(np.full(4, 9.0)),
                        jnp.float32)
    trans = np.stack([np.asarray(jp.template_transition_params(
        jnp.asarray(tpl[r]), table, jnp.int32(tlens[r]))) for r in range(R)])
    fill = jscorer.fill_alpha_beta_batch(
        jnp.asarray(reads), jnp.asarray(rlens), jnp.asarray(tpl),
        jnp.asarray(trans), jnp.asarray(tlens), W, use_pallas=False)
    st = convert.fill_from_numpy(fill)
    assert isinstance(st, tscorer.FillState)
    assert st.alpha.offsets.dtype == torch.int32
    assert st.alpha.vals.dtype == torch.float32
    np.testing.assert_array_equal(st.alpha.vals.numpy(),
                                  np.asarray(fill[0].vals))
    np.testing.assert_array_equal(st.beta.log_scales.numpy(),
                                  np.asarray(fill[1].log_scales))
    np.testing.assert_array_equal(st.ll_b.numpy(), np.asarray(fill[3]))
    bm = convert.banded_from_numpy(jfp.pallas_forward_batch(
        jnp.asarray(reads), jnp.asarray(rlens), jnp.asarray(tpl),
        jnp.asarray(trans), jnp.asarray(tlens), W))
    assert bm.vals.shape == (R, Jmax + 1, W)
