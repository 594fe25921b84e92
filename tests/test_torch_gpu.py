"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: on a machine without a CUDA device every test here skips
(the decision is made in the `cuda` fixture, at run time, so every
worker collects the same tests).  This file imports nothing of JAX, so
on the card, where JAX is not installed, it runs without the suite's
conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerances: fills bitwise equal to the plain scan (same association,
-fmad=false; log-likelihoods also within the 1e-4 contract); dense
interior scores rtol 2e-5 / atol 2e-3 (the reductions sum lanes in
another order); the card's process_chunks agrees with the CPU's on the
consensus and within 1 QV."""

import numpy as np
import pytest
import torch

from pbccs_tpu_torch.models.arrow import params
from pbccs_tpu_torch.models.arrow.scorer import oriented_window
from pbccs_tpu_torch.ops import dense_score_cuda as ds
from pbccs_tpu_torch.ops import fwdbwd_cuda as fc
from pbccs_tpu_torch.ops.fwdbwd import band_offsets
from pbccs_tpu_torch.ops.mutation_score import scale_prefix, scale_suffix
from pbccs_tpu_torch.simulate import simulate_zmw

pytestmark = pytest.mark.gpu


def make_case(seed: int, L: int, n_reads: int):
    """One simulated ZMW as a flat batch of oriented read windows (every
    other read clipped at both ends; read 0 given 40 two-base insertions
    in its first half, so its path drifts off the diagonal and runs
    through values that flush to zero), numpy arrays."""
    rng = np.random.default_rng(seed)
    tpl, reads, strands, snr = simulate_zmw(rng, L, n_reads)
    r0 = list(reads[0])
    for p in sorted(rng.choice(np.arange(20, len(r0) // 2), 40,
                               replace=False))[::-1]:
        r0[p:p] = list(rng.integers(0, 4, 2))
    reads = [np.array(r0, np.int8)] + list(reads[1:])
    Jmax = ((L + 16 + 63) // 64) * 64
    table = params.snr_to_transition_table_host(snr).astype(np.float32)
    ts = np.zeros(n_reads, np.int32)
    te = np.full(n_reads, L, np.int32)
    ts[1::2], te[1::2] = 3, L - 5
    reads_p = np.full((n_reads, Jmax + 128), 4, np.int8)
    rlens = np.zeros(n_reads, np.int32)
    for i, r in enumerate(reads):
        r = np.asarray(r)[: te[i] - ts[i] + 8]
        reads_p[i, : len(r)] = r
        rlens[i] = len(r)
    tpl_p = np.full((1, Jmax), 4, np.int8)
    tpl_p[0, :L] = tpl
    t = torch.as_tensor
    tlen = t(np.array([L], np.int32))
    win_tpl, win_trans, wlens = oriented_window(
        t(np.asarray(strands, np.int32))[None], t(ts)[None], t(te)[None],
        t(tpl_p), params.revcomp_padded(t(tpl_p), tlen), tlen,
        t(table)[None])
    return dict(reads=reads_p, rlens=rlens, win_tpl=win_tpl[0].numpy(),
                win_trans=win_trans[0].numpy(), wlens=wlens[0].numpy(),
                table=table)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(c, dev):
    return [torch.as_tensor(c[k]).to(dev) for k in
            ("reads", "rlens", "win_tpl", "win_trans", "wlens")]


@pytest.mark.parametrize("W", [64, 96, 128])
@pytest.mark.parametrize("backward", [False, True])
def test_fill_scan_kernel_matches_plain(cuda, W, backward):
    c = make_case(21, L=300, n_reads=6)
    reads, rlens, tpls, trans, J = _on(c, cuda)
    I, J = rlens.int(), J.int()
    offs = band_offsets(I, J, tpls.shape[1] + 1, W)
    coeffs = fc._backward_coeffs if backward else fc._forward_coeffs
    args = [a.contiguous() for a in coeffs(
        reads.int(), I, tpls.int(), trans, J, offs, W,
        fc.MISMATCH_PROBABILITY)]
    before = fc.fill_scan.launches
    vk, lk = fc.fill_scan(*args, backward)
    assert fc.fill_scan.launches == before + 1
    vp, lp = fc.fill_scan_plain(*args, backward)
    torch.cuda.synchronize()
    assert torch.equal(vk, vp)
    np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(), rtol=1e-6)


def test_dense_score_kernel_matches_plain(cuda):
    W = 64
    c = make_case(22, L=250, n_reads=5)
    reads, rlens, wt, wtr, wl = _on(c, cuda)
    alpha = fc.forward_batch(reads, rlens, wt, wtr, wl, W)
    beta = fc.backward_batch(reads, rlens, wt, wtr, wl, W)
    R, Jm = wt.shape
    NB = -(-Jm // ds.PB)
    rb, rn = ds.band_read_windows(reads, alpha.offsets, W)
    tables = torch.as_tensor(np.broadcast_to(c["table"], (R, 8, 4)).copy(),
                             device=cuda)
    live = torch.ones(R, NB, dtype=torch.int32, device=cuda)
    live[0, 1] = 0
    i32 = torch.int32
    args = (alpha.vals, beta.vals, rb.contiguous(), rn.contiguous(),
            alpha.offsets.to(i32).contiguous(),
            scale_prefix(alpha.log_scales).contiguous(),
            scale_suffix(beta.log_scales).contiguous(), wt.to(i32).contiguous(),
            wtr.contiguous(), ds.dense_patch_grids(wt, wtr, tables, wl),
            rlens.to(i32).contiguous(), live)
    got = ds.dense_score(*args).cpu().numpy()
    want = ds.dense_score_plain(*args).cpu().numpy()
    p = np.arange(Jm)[None, :, None]
    endoff = np.array([1, 1, 1, 1, 0, 0, 0, 0, 1])
    interior = (p >= 3) & (p + endoff <= c["wlens"][:, None, None] - 2)
    np.testing.assert_allclose(got[interior], want[interior], rtol=2e-5,
                               atol=2e-3)
    assert not got[0, ds.PB: 2 * ds.PB].any()


def test_wrappers_check_inputs(cuda):
    x = torch.zeros(2, 3, 64, device=cuda, dtype=torch.float64)
    m = torch.zeros(2, 3, device=cuda)
    s = torch.zeros(2, 64, device=cuda)
    col = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        fc.fill_scan(x, x, x, m, s, col, False)
    with pytest.raises(ValueError):
        fc.fill_scan(x.float(), x.float(), x.float(), m, s,
                     col.long(), False)


def test_process_chunks_card_matches_cpu(cuda):
    from pbccs_tpu_torch.pipeline import Chunk, Subread, process_chunks

    rng = np.random.default_rng(23)
    chunks = []
    for z in range(3):
        _, reads, _, snr = simulate_zmw(rng, 300, 5)
        chunks.append(Chunk(f"g/{z}", [Subread(f"g/{z}/{i}", r)
                                       for i, r in enumerate(reads)], snr))
    fills, dense = fc.fill_scan.launches, ds.dense_score.launches
    gpu = process_chunks(chunks)
    assert fc.fill_scan.launches > fills and ds.dense_score.launches > dense
    cpu = process_chunks(chunks, device="cpu")
    a = {r.id: r for r in gpu.results}
    b = {r.id: r for r in cpu.results}
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert a[k].sequence == b[k].sequence
        assert np.abs(a[k].qvs.astype(int) - b[k].qvs.astype(int)).max() <= 1
