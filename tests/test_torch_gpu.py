"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: on a machine without a CUDA device every test here skips
(the decision is made in the `cuda` fixture, at run time, so every
worker collects the same tests).  This file imports nothing of JAX, so
on the card, where JAX is not installed, it runs without the suite's
conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerances: fills (K1 and the Quiver K2) bitwise equal to their plain
versions (same association, -fmad=false -ftz=true; K1's log-scales
within 1e-6 relative, torch's log against the kernel's logf); dense
interior scores (K3) within 1e-6 relative (the same association and
band-sum order, so bitwise is expected; torch's log against logf); the
card's process_chunks agrees with the CPU's on the consensus and within
1 QV; the read scorers' log-likelihoods within 1e-4 absolute."""

import inspect

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


#: the band widths of the schedule (64, 96) and of its 2x retry (128, 192)
K1_WIDTHS = [64, 96, 128, 192]


def _k1_args(cuda, W):
    """make_case's 6 reads (not a multiple of the 4 reads per block) on the
    card with diagonal band offsets, as arrow_fill takes them."""
    c = make_case(21, L=300, n_reads=6)
    reads, rlens, tpls, trans, J = _on(c, cuda)
    offs = band_offsets(rlens, J, tpls.shape[1] + 1, W)
    return (reads, rlens, tpls, trans.contiguous(), J, offs, W,
            fc.MISMATCH_PROBABILITY)


def _assert_same_fill(got, want):
    """Band values bitwise; log-scales within 1e-6 relative (torch's log
    and the kernel's logf)."""
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("W", K1_WIDTHS)
@pytest.mark.parametrize("backward", [False, True])
def test_fill_scan_kernel_matches_plain(cuda, W, backward):
    """K1 in one direction against its plain version (coefficient planes,
    then fill_scan_plain) on the same card."""
    args = _k1_args(cuda, W)
    before = fc.arrow_fill.launches
    got = fc.arrow_fill(*args, alpha=not backward, beta=backward)
    assert fc.arrow_fill.launches == before + 1
    assert got[not backward] is None
    want = fc.arrow_fill_plain(*args, alpha=not backward, beta=backward)
    _assert_same_fill(got[backward], want[backward])


@pytest.mark.parametrize("W", list(fc.K1_WIDTHS))
def test_arrow_fill_fused_matches_plain(cuda, W):
    """Alpha and beta in one launch, each against its plain version, at
    every band width K1 is built for."""
    args = _k1_args(cuda, W)
    before = fc.arrow_fill.launches
    got = fc.arrow_fill(*args)
    assert fc.arrow_fill.launches == before + 1
    want = fc.arrow_fill_plain(*args)
    for g, w in zip(got, want):
        _assert_same_fill(g, w)


def _quiver_rows(seed: int, L: int, n_reads: int, dev):
    """K2's inputs for one simulated ZMW (flat default QV tracks): each
    read against its true template window, then read 0 against an empty
    window (J = 0), a 50-base read against a 50-base window (I < W) and
    read 1 against read 0's window -- R = n_reads + 3 rows, indexed into
    (n_reads + 1) reads and (n_reads + 2) windows."""
    from pbccs_tpu_torch.models.quiver.features import flat_default_features
    from pbccs_tpu_torch.models.quiver.recursor import (feature_arrays,
                                                        stack_features)

    rng = np.random.default_rng(seed)
    tpl, reads, strands, _ = simulate_zmw(rng, L, n_reads)
    reads = list(reads) + [np.asarray(reads[0])[:50]]
    feats = [flat_default_features(r) for r in reads]
    imax = max(len(f) for f in feats)
    wins = np.full((n_reads + 2, L), 4, np.int8)
    for i, s in enumerate(strands):
        wins[i] = params.revcomp(tpl) if s else tpl
    wins[n_reads + 1, :50] = tpl[:50]
    wlens = [L] * n_reads + [0, 50]
    row_read = list(range(n_reads)) + [0, n_reads, 1]
    row_win = list(range(n_reads)) + [n_reads, n_reads + 1, 0]
    t = lambda a, d=torch.int32: torch.as_tensor(  # noqa: E731
        np.asarray(a), device=dev).to(d)
    return (stack_features([feature_arrays(f, imax, dev) for f in feats]),
            t([len(f) for f in feats]), t(wins, torch.int8), t(wlens),
            t(row_read), t(row_win))


def _quiver_fill_args(cuda, moves, W=96):
    from pbccs_tpu_torch.models.quiver import fill as qf
    from pbccs_tpu_torch.models.quiver.params import (ALL_MOVES,
                                                      BASIC_MOVES,
                                                      QuiverConfig)

    cfg = QuiverConfig(moves_available=ALL_MOVES if moves == "all"
                       else BASIC_MOVES)
    feat, rlens, wins, wlens, rr, rw = _quiver_rows(24, 300, 6, cuda)
    offsets = band_offsets(rlens[rr.long()], wlens[rw.long()],
                           wins.shape[1] + 1, W)
    return (qf.emission_tables(feat, cfg), rlens, wins, wlens, rr, rw,
            offsets, W, moves == "all")


#: every band width csrc/quiver_fill.cu is built for (W / 32 = 1..4 slots)
K2_WIDTHS = [32, 64, 96, 128]


@pytest.mark.parametrize("W", K2_WIDTHS)
@pytest.mark.parametrize("moves", ["basic", "all"])
@pytest.mark.parametrize("backward", [False, True])
def test_quiver_fill_kernel_matches_plain(cuda, W, moves, backward):
    """K2 against its plain version at every built band width: band
    values, log-scales and final cells bitwise, on 9 rows (not a multiple
    of the 4 rows per block), one with an empty window and one 50-base
    read (shorter than W from W = 64 on)."""
    from pbccs_tpu_torch.ops import quiver_fill_cuda as qk

    args = _quiver_fill_args(cuda, moves, W)
    before = qk.quiver_fill.launches
    got = qk.quiver_fill(*args, backward)
    assert qk.quiver_fill.launches == before + 1
    want = qk.quiver_fill_plain(*args, backward)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.isfinite(got[2]).all() and (got[2][:6] > 0).all()


@pytest.mark.parametrize("W", K2_WIDTHS)
@pytest.mark.parametrize("backward", [False, True])
def test_quiver_fill_ll_mode_matches_vals_mode(cuda, W, backward):
    """The log-likelihood-only mode gives bitwise the log-scales and final
    cells of the band-value mode, and no band values."""
    from pbccs_tpu_torch.ops import quiver_fill_cuda as qk

    args = _quiver_fill_args(cuda, "all", W)
    vals, ls, fin = qk.quiver_fill(*args, backward)
    none, ls_b, fin_b = qk.quiver_fill(*args, backward, vals=False)
    torch.cuda.synchronize()
    assert none is None
    assert torch.equal(ls, ls_b) and torch.equal(fin, fin_b)


def test_quiver_process_chunks_card_matches_cpu(cuda):
    from pbccs_tpu_torch.pipeline import (Chunk, ConsensusSettings, Subread,
                                          process_chunks)

    rng = np.random.default_rng(25)
    _, reads, _, snr = simulate_zmw(rng, 150, 5)
    chunks = [Chunk("q", [Subread(f"q/{i}", r) for i, r in enumerate(reads)],
                    snr)]
    settings = ConsensusSettings(model="quiver")
    from pbccs_tpu_torch.ops.quiver_fill_cuda import quiver_fill

    before = quiver_fill.launches
    gpu = process_chunks(chunks, settings)
    assert quiver_fill.launches > before
    cpu = process_chunks(chunks, settings, device="cpu")
    assert gpu.counts == cpu.counts and len(gpu.results) == 1
    a, b = gpu.results[0], cpu.results[0]
    assert a.sequence == b.sequence
    assert np.abs(a.qvs.astype(int) - b.qvs.astype(int)).max() <= 1


def _k3_args(cuda, W, guided: bool):
    """K3's arguments on make_case's 5 reads at band width W: the fused
    K1 fills (checked bitwise against K1's plain version on the same
    card) on diagonal band offsets, or on offsets guided by a first alpha
    fill; every other 64-position block of read 0 dead."""
    from pbccs_tpu_torch.ops.fwdbwd import guided_band_offsets

    c = make_case(22, L=250, n_reads=5)
    reads, rlens, wt, wtr, wl = _on(c, cuda)
    R, Jm = wt.shape
    offs = band_offsets(rlens, wl, Jm + 1, W)
    k1 = (reads, rlens, wt, wtr.contiguous(), wl)
    if guided:
        alpha = fc.forward_batch(*k1, W)
        offs = guided_band_offsets(alpha.vals, alpha.offsets, rlens, wl, W)
    args = k1 + (offs, W, fc.MISMATCH_PROBABILITY)
    (av, als), (bv, bls) = fc.arrow_fill(*args)
    for g, w in zip(((av, als), (bv, bls)), fc.arrow_fill_plain(*args)):
        _assert_same_fill(g, w)
    NB = -(-Jm // ds.PB)
    live = torch.ones(R, NB, dtype=torch.int32, device=cuda)
    live[0, 1::2] = 0
    tables = torch.as_tensor(np.broadcast_to(c["table"], (R, 8, 4)).copy(),
                             device=cuda)
    return (av, bv, offs, scale_prefix(als).contiguous(),
            scale_suffix(bls).contiguous(), reads, rlens, wt, wl,
            wtr.contiguous(), tables, live), c["wlens"]


@pytest.mark.parametrize("W", list(ds.K3_WIDTHS))
@pytest.mark.parametrize("guided", [False, True])
def test_dense_score_kernel_matches_plain(cuda, W, guided):
    """K3 against its plain version at every built band width, on K1's
    fills at that width (diagonal and guided band offsets): interior
    slots within 1e-6 relative (the nine link sums are summed in the same
    order, so bitwise is expected), dead blocks zeros."""
    args, wlens = _k3_args(cuda, W, guided)
    before = ds.dense_score.launches
    got = ds.dense_score(*args)
    assert ds.dense_score.launches == before + 1
    want = ds.dense_score_plain(*args)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    Jm = got.shape[1]
    p = np.arange(Jm)[None, :, None]
    endoff = np.array([1, 1, 1, 1, 0, 0, 0, 0, 1])
    interior = (p >= 3) & (p + endoff <= wlens[:, None, None] - 2)
    assert interior.sum() > 1000
    np.testing.assert_allclose(got[interior], want[interior], rtol=1e-6,
                               atol=0)
    for b in range(1, -(-Jm // ds.PB), 2):
        assert not got[0, b * ds.PB: (b + 1) * ds.PB].any()


def test_wrappers_check_inputs(cuda):
    """Every refusal before a launch is a LaunchRefused: a KernelError
    (re-raised by the pipeline, never bisected) that is also a
    ValueError and a TypeError."""
    from pbccs_tpu_torch.ops.cuda_lib import LaunchRefused

    args = list(_k1_args(cuda, 64))
    for W in (48, 224, 288):           # W % 32 != 0, not built, W > 256
        with pytest.raises(LaunchRefused):
            fc.arrow_fill(*args[:6], W)
    for i in (0, 3, 5):                               # one tensor on the CPU
        bad = list(args)
        bad[i] = args[i].cpu()
        with pytest.raises(LaunchRefused):
            fc.arrow_fill(*bad)
    bad = list(args)
    bad[0] = args[0].int()
    with pytest.raises(LaunchRefused):
        fc.arrow_fill(*bad)
    from pbccs_tpu_torch.ops.quiver_fill_cuda import quiver_fill

    args = list(_quiver_fill_args(cuda, "all", W=64))
    with pytest.raises(LaunchRefused):                   # W % 32 != 0
        quiver_fill(*args[:7], 48, True, False)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(LaunchRefused):
        quiver_fill(*bad, False)
    bad = list(args)
    bad[2] = args[2].long()
    with pytest.raises(LaunchRefused):
        quiver_fill(*bad, False)
    for i in (0, 4, 6):                               # one tensor on the CPU
        bad = list(args)
        bad[i] = args[i].cpu()
        with pytest.raises(LaunchRefused):
            quiver_fill(*bad, False)
    args = list(_k3_args(cuda, 64, False)[0])
    for W in (48, 224):                               # W not built
        wide = [torch.zeros(*a.shape[:2], W, device=cuda) for a in args[:2]]
        with pytest.raises(LaunchRefused):
            ds.dense_score(*wide, *args[2:])
    for i, cast in ((5, torch.int32), (7, torch.int32), (10, torch.float64)):
        bad = list(args)
        bad[i] = args[i].to(cast)
        with pytest.raises(LaunchRefused):
            ds.dense_score(*bad)
    for i in (0, 5, 11):                              # one tensor on the CPU
        bad = list(args)
        bad[i] = args[i].cpu()
        with pytest.raises(LaunchRefused):
            ds.dense_score(*bad)


def test_process_chunks_card_matches_cpu(cuda):
    from pbccs_tpu_torch.pipeline import Chunk, Subread, process_chunks

    rng = np.random.default_rng(23)
    chunks = []
    for z in range(3):
        _, reads, _, snr = simulate_zmw(rng, 300, 5)
        chunks.append(Chunk(f"g/{z}", [Subread(f"g/{z}/{i}", r)
                                       for i, r in enumerate(reads)], snr))
    fills, dense = fc.arrow_fill.launches, ds.dense_score.launches
    gpu = process_chunks(chunks)
    assert fc.arrow_fill.launches > fills and ds.dense_score.launches > dense
    cpu = process_chunks(chunks, device="cpu")
    a = {r.id: r for r in gpu.results}
    b = {r.id: r for r in cpu.results}
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert a[k].sequence == b[k].sequence
        assert np.abs(a[k].qvs.astype(int) - b[k].qvs.astype(int)).max() <= 1


def test_process_chunks_long_template_card_matches_cpu(cuda):
    """A 3.1 kb template: its bucket is over 3 kb, so the fills take one
    argmax-guided pass (K1 forward-only launches, then beta on alpha's
    band) and K3 scores on guided offsets; the card's consensus is the
    CPU's, QVs within 1."""
    from pbccs_tpu_torch.pipeline import Chunk, Subread, process_chunks

    rng = np.random.default_rng(27)
    _, reads, _, snr = simulate_zmw(rng, 3100, 3)
    chunks = [Chunk("long", [Subread(f"long/{i}", r)
                             for i, r in enumerate(reads)], snr)]
    fills, dense = fc.arrow_fill.launches, ds.dense_score.launches
    gpu = process_chunks(chunks)
    assert fc.arrow_fill.launches > fills and ds.dense_score.launches > dense
    cpu = process_chunks(chunks, device="cpu")
    assert gpu.counts == cpu.counts and len(gpu.results) == 1
    a, b = gpu.results[0], cpu.results[0]
    assert a.sequence == b.sequence
    assert np.abs(a.qvs.astype(int) - b.qvs.astype(int)).max() <= 1


def test_process_chunks_builds_no_coefficient_plane(cuda, monkeypatch):
    """On the card the Arrow path never runs the plain versions' plane
    builds: with K1's coefficient precompute and the full-size forms of
    K3's read-window and patch-grid functions patched to raise,
    process_chunks still polishes every ZMW, on K1 and K3 (the edge
    programs and refills build the columns and rows they read)."""
    from pbccs_tpu_torch.pipeline import Chunk, Subread, process_chunks

    def no_planes(*args, **kwargs):
        raise AssertionError("a coefficient plane was built on the card")

    def partial_only(fn, subset):
        # a call that leaves its column / position list at None, however
        # its arguments are passed, builds the full plane
        sig = inspect.signature(fn)

        def wrapper(*args, **kwargs):
            if sig.bind(*args, **kwargs).arguments.get(subset) is None:
                raise AssertionError(f"a full {fn.__name__} plane was built "
                                     "on the card")
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(fc, "_forward_coeffs", no_planes)
    monkeypatch.setattr(fc, "_backward_coeffs", no_planes)
    monkeypatch.setattr(ds, "band_read_windows",
                        partial_only(ds.band_read_windows, "cols"))
    monkeypatch.setattr(ds, "dense_patch_grids",
                        partial_only(ds.dense_patch_grids, "pos"))
    rng = np.random.default_rng(26)
    chunks = []
    for z in range(2):
        _, reads, _, snr = simulate_zmw(rng, 300, 5)
        chunks.append(Chunk(f"p/{z}", [Subread(f"p/{z}/{i}", r)
                                       for i, r in enumerate(reads)], snr))
    before = fc.arrow_fill.launches, ds.dense_score.launches
    out = process_chunks(chunks)
    assert fc.arrow_fill.launches > before[0]
    assert ds.dense_score.launches > before[1]
    assert out.total == 2 and out.results


@pytest.mark.parametrize("W", [96, 192])
def test_serial_scorer_card_matches_cpu(cuda, W):
    """The serial ArrowMultiReadScorer of a 2 kb ZMW on the card against
    the same scorer on the CPU: at the schedule's W = 96 and at W = 192,
    the width its 2x band retry reaches (here set as an explicit band
    width).  Gates equal; score_mutations over a spread of the
    template's mutations (every 7th position and both ends, so interior
    pairs on K3 and edge pairs refilled on K1) within the dense
    tolerance, rtol 2e-5, atol 2e-3."""
    from pbccs_tpu_torch.models.arrow.mutations import enumerate_unique
    from pbccs_tpu_torch.models.arrow.scorer import ArrowMultiReadScorer

    rng = np.random.default_rng(29)
    tpl, reads, strands, snr = simulate_zmw(rng, 2000, 5)
    L = len(tpl)
    cfg = params.ArrowConfig(banding=params.BandingOptions(
        band_width=None if W == 96 else W))
    args = (tpl, snr, reads, strands, [0] * 5, [L] * 5)
    cpu = ArrowMultiReadScorer(*args, config=cfg, min_zscore=-5.0,
                               device="cpu")
    fills, dense = fc.arrow_fill.launches, ds.dense_score.launches
    gpu = ArrowMultiReadScorer(*args, config=cfg, min_zscore=-5.0)
    assert gpu._W == cpu._W == W
    np.testing.assert_array_equal(gpu.statuses, cpu.statuses)
    muts = [m for m in enumerate_unique(tpl)
            if m.start % 7 == 0 or m.start < 5 or m.start > L - 5]
    got = gpu.score_mutations(muts)
    assert fc.arrow_fill.launches > fills and ds.dense_score.launches > dense
    np.testing.assert_allclose(got, cpu.score_mutations(muts), rtol=2e-5,
                               atol=2e-3)


def test_cuda_oom_splits_a_pinned_batch(cuda, monkeypatch):
    """A real torch.cuda.OutOfMemoryError: with the allocator capped
    between the reserved peak of an 8-ZMW and of a 16-ZMW dispatch (2 kb
    ZMWs, pinned shapes), polish_prepared_batch splits the batch, records
    a ceiling of 8 for its bucket, quarantines nothing, and its records
    equal the unsplit batch's (sequences, QVs, z-scores)."""
    import pbccs_tpu_torch.pipeline as tp
    from pbccs_tpu_torch.obs.metrics import default_registry
    from pbccs_tpu_torch.resilience import quarantine, resources

    rng = np.random.default_rng(31)
    chunks = []
    for z in range(16):
        _, reads, _, snr = simulate_zmw(rng, 2000, 6)
        chunks.append(tp.Chunk(f"o/{z}", [tp.Subread(f"o/{z}/{i}", r)
                                          for i, r in enumerate(reads)],
                               snr))
    settings = tp.ConsensusSettings()
    _, preps = tp.prepare_batch(chunks, settings)
    assert len(preps) == 16
    pin = tp._pinned_batch_shapes(preps, None)
    want = tp.polish_prepared_batch(preps, settings, device=cuda)

    def reserved_peak(sub):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_reserved()
        tp._polish_batch_arrow(sub, settings, cuda, buckets=pin)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_reserved() - base

    half = max(reserved_peak(preps[:8]), reserved_peak(preps[8:]))
    full = reserved_peak(preps)
    assert full > half
    monkeypatch.setattr(resources, "_default_governor",
                        resources.MemoryGovernor())
    torch.cuda.empty_cache()
    limit = torch.cuda.memory_reserved() + (half + full) // 2
    total = torch.cuda.get_device_properties(cuda).total_memory
    quarantine.reset_event_counts()
    scope = default_registry().scope()
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        got = tp.polish_prepared_batch(preps, settings, device=cuda)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert scope.counter_value("ccs_zmw_failures_total",
                               stage="polish.capacity",
                               exc="OutOfMemoryError") >= 1
    assert scope.counter_value("ccs_resource_oom_splits_total") >= 1
    assert resources.default_governor().cap(
        resources.shape_bucket(*pin)) == 8
    assert quarantine.event_counts() == dict.fromkeys(
        quarantine.event_counts(), 0)
    assert [f for f, _ in got] == [f for f, _ in want]
    for (_, a), (_, b) in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.sequence == b.sequence
        np.testing.assert_array_equal(a.qvs, b.qvs)
        np.testing.assert_array_equal(a.zscores, b.zscores)


def test_watchdog_worker_launches_on_the_callers_stream(cuda):
    """run_with_deadline moves the guarded call onto a worker thread; the
    worker enters the caller's device and current stream, so K1 launches
    on a non-default stream the caller set, with the same result."""
    from pbccs_tpu_torch.resilience import watchdog

    args = _k1_args(cuda, 96)
    want = fc.arrow_fill(*args)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    before = fc.arrow_fill.launches

    def guarded():
        return torch.cuda.current_stream().cuda_stream, fc.arrow_fill(*args)

    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        stream, got = watchdog.run_with_deadline(guarded, 120.0,
                                                 site="test.stream")
    side.synchronize()
    assert stream == side.cuda_stream
    assert stream != torch.cuda.default_stream().cuda_stream
    assert fc.arrow_fill.launches == before + 1
    for g, w in zip(got, want):
        _assert_same_fill(g, w)


def test_device_pool_polishes_on_cuda0(cuda):
    """A DevicePool over the first card runs one prebaked polish on its
    worker thread, where cuda:0 is the current device, and writes what
    process_chunks writes on the card."""
    from pbccs_tpu_torch.pipeline import (Chunk, Subread,
                                          polish_prepared_batch,
                                          prebake_polish, prepare_batch,
                                          process_chunks)
    from pbccs_tpu_torch.sched import DevicePool, select_devices

    rng = np.random.default_rng(29)
    chunks = []
    for z in range(3):
        _, reads, _, snr = simulate_zmw(rng, 300, 5)
        chunks.append(Chunk(f"p/{z}", [Subread(f"p/{z}/{i}", r)
                                       for i, r in enumerate(reads)], snr))
    _, preps = prepare_batch(chunks)
    prebaked = prebake_polish(preps)

    def task(dev):
        return (torch.cuda.current_device(), dev,
                polish_prepared_batch(preps, device=dev, prebaked=prebaked))

    fills = fc.arrow_fill.launches
    with DevicePool(select_devices(1)) as pool:
        current, dev, outcomes = pool.submit("k", task).result(600)
    assert current == 0 and dev == torch.device("cuda", 0)
    assert fc.arrow_fill.launches > fills
    got = {r.id: r for _, r in outcomes if r is not None}
    want = {r.id: r for r in process_chunks(chunks).results}
    assert sorted(got) == sorted(want) and got
    for k in got:
        assert got[k].sequence == want[k].sequence
        np.testing.assert_array_equal(got[k].qvs, want[k].qvs)


@pytest.mark.parametrize("quiver", [False, True])
def test_read_scorers_card_match_cpu(cuda, quiver):
    """score_read launches K1 and score_read_quiver K2 once on the card;
    each log-likelihood agrees with the CPU's (the plain version) within
    1e-4 absolute, the fills' contract."""
    from pbccs_tpu_torch.models.quiver.features import flat_default_features
    from pbccs_tpu_torch.models.readscorer import (score_read,
                                                   score_read_quiver)
    from pbccs_tpu_torch.ops import quiver_fill_cuda as qk

    tpl, reads, _, snr = simulate_zmw(np.random.default_rng(8), 500, 2)
    fn, args, kernel = ((score_read_quiver,
                         (flat_default_features(reads[0]), tpl),
                         qk.quiver_fill) if quiver
                        else (score_read, (reads[0], tpl, snr),
                              fc.arrow_fill))
    before = kernel.launches
    got = fn(*args, device=cuda)
    assert kernel.launches == before + 1
    assert abs(got - fn(*args, device="cpu")) <= 1e-4


def test_engine_on_cuda_matches_pinned_batch_polish(cuda):
    """The serve engine on the card (its polish executor thread under
    cuda:0) against polish_prepared_batch on the card at the flush's
    pinned (Imax, Jmax, R, Z): byte-equal results, K1 and K3 launched by
    the engine."""
    from pbccs_tpu_torch.pipeline import (Chunk, ConsensusSettings, Subread,
                                          polish_prepared_batch,
                                          prepare_chunk)
    from pbccs_tpu_torch.serve.engine import (CcsEngine, ServeConfig,
                                              flush_buckets)

    rng = np.random.default_rng(31)
    chunks = []
    for z in range(3):
        _, reads, _, snr = simulate_zmw(rng, 300, 5)
        chunks.append(Chunk(f"s/{z}", [Subread(f"s/{z}/{i}", r)
                                       for i, r in enumerate(reads)], snr))
    fills, dense = fc.arrow_fill.launches, ds.dense_score.launches
    cfg = ServeConfig(max_batch=3, max_wait_ms=60_000.0, prep_workers=1)
    with CcsEngine(config=cfg) as eng:
        reqs = [eng.submit(c) for c in chunks]
        for r in reqs:
            assert r.wait(600.0) and r.error is None, r.error
    assert fc.arrow_fill.launches > fills and ds.dense_score.launches > dense
    settings = ConsensusSettings()
    preps = [prepare_chunk(c, settings)[1] for c in chunks]
    want = polish_prepared_batch(preps, settings,
                                 buckets=flush_buckets(preps))
    for r, (failure, result) in zip(reqs, want):
        assert r.failure == failure
        assert r.result.sequence == result.sequence
        np.testing.assert_array_equal(r.result.qvs, result.qvs)
        assert r.result.predicted_accuracy == result.predicted_accuracy


def test_batch_polisher_refuses_an_unbuilt_width_at_construction(cuda):
    """band_width=80 on the card: ValueError when the BatchPolisher is
    built, before any launch -- never mid-refine."""
    from pbccs_tpu_torch.models.arrow.params import (ArrowConfig,
                                                     BandingOptions)
    from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask

    rng = np.random.default_rng(37)
    tpl, reads, strands, snr = simulate_zmw(rng, 200, 4)
    task = ZmwTask("w/0", tpl, snr, reads, list(strands),
                   [0] * len(reads), [len(tpl)] * len(reads))
    cfg = ArrowConfig(banding=BandingOptions(band_width=80))
    fills = fc.arrow_fill.launches
    with pytest.raises(ValueError, match="band width 80"):
        BatchPolisher([task], config=cfg, device=cuda)
    assert fc.arrow_fill.launches == fills
