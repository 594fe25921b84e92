"""Batch-failure recovery of the port's process_chunks: quarantine
bisection, the serial rescue, draft-only degradation, and device errors
that are re-raised instead of bisected: a kernel build, load or launch
failure, a kernel wrapper's refusal of its arguments, a CUDA error.

A poison ZMW is injected by monkeypatching the batch dispatch
(pipeline._polish_batch_arrow) to raise whenever the batch holds it;
the serial polish (pipeline.polish_prepared) is poisoned the same way
where a test needs the rescue to fail too.  Contract: the other ZMWs
are byte-identical to a clean run (sequence, QVs, z-scores), the poison
ZMW is rescued by the serial path or quarantined, and every event is
counted (resilience.quarantine.event_counts)."""

import numpy as np
import pytest
import torch

import pbccs_tpu_torch.pipeline as tp
from pbccs_tpu_torch.device import is_device_error
from pbccs_tpu_torch.ops import dense_score_cuda as dsc
from pbccs_tpu_torch.ops import fwdbwd_cuda as fc
from pbccs_tpu_torch.ops import quiver_fill_cuda as qfc
from pbccs_tpu_torch.ops.cuda_lib import KernelError, LaunchRefused
from pbccs_tpu_torch.resilience import quarantine
from pbccs_tpu_torch.simulate import simulate_zmw

torch.set_num_threads(1)

N_ZMWS = 5
POISON = "q/3"


def _chunks():
    rng = np.random.default_rng(77)
    out = []
    for z in range(N_ZMWS):
        _, reads, _, snr = simulate_zmw(rng, 70, 4)
        out.append(tp.Chunk(f"q/{z}", [tp.Subread(f"q/{z}/{i}", r)
                                       for i, r in enumerate(reads)], snr))
    return out


@pytest.fixture(scope="module")
def clean():
    quarantine.reset_event_counts()
    tally = tp.process_chunks(_chunks(), device="cpu")
    assert quarantine.event_counts() == dict.fromkeys(
        quarantine.event_counts(), 0)
    assert tally.counts[tp.Failure.SUCCESS] == N_ZMWS
    return {r.id: r for r in tally.results}


def _poison_batch(monkeypatch, exc=None):
    real = tp._polish_batch_arrow
    dispatched = []

    def dispatch(preps, settings, device, *, buckets=None):
        dispatched.append(([p.chunk.id for p in preps], buckets))
        if any(p.chunk.id == POISON for p in preps):
            raise exc or ValueError("poison ZMW")
        return real(preps, settings, device, buckets=buckets)

    monkeypatch.setattr(tp, "_polish_batch_arrow", dispatch)
    return dispatched


def _poison_serial(monkeypatch):
    real = tp.polish_prepared

    def polish(prep, settings, *, device=None):
        if prep.chunk.id == POISON:
            raise ValueError("poison ZMW, serially too")
        return real(prep, settings, device=device)

    monkeypatch.setattr(tp, "polish_prepared", polish)


def _same(a, b):
    assert a.sequence == b.sequence
    np.testing.assert_array_equal(a.qvs, b.qvs)
    np.testing.assert_array_equal(a.zscores, b.zscores)
    assert a.global_zscore == b.global_zscore
    assert (a.num_passes, a.status_counts, a.mutations_tested,
            a.mutations_applied) == (b.num_passes, b.status_counts,
                                     b.mutations_tested, b.mutations_applied)
    assert not a.draft_only and not b.draft_only


def test_bisection_isolates_and_rescues(monkeypatch, clean):
    dispatched = _poison_batch(monkeypatch)
    quarantine.reset_event_counts()
    tally = tp.process_chunks(_chunks(), device="cpu")
    ev = quarantine.event_counts()
    assert ev["isolations"] == 1 and ev["serial_rescues"] == 1
    assert ev["quarantined"] == 0 and ev["bisect_dispatches"] >= 1
    assert tally.counts[tp.Failure.SUCCESS] == N_ZMWS
    got = {r.id: r for r in tally.results}
    for k, r in clean.items():
        if k != POISON:
            _same(got[k], r)
    # the rescued ZMW went through the serial scorer: same consensus
    assert got[POISON].sequence == clean[POISON].sequence
    # every sub-dispatch is pinned to the parent batch's shapes
    parent = dispatched[0][1]
    assert parent is None
    pins = {b for _, b in dispatched[1:]}
    assert len(pins) == 1 and None not in pins
    # the poison ZMW alone failed its own pinned dispatch before rescue
    assert [POISON] in [ids for ids, _ in dispatched]


@pytest.mark.parametrize("degrade", [False, True])
def test_quarantined_zmw(monkeypatch, clean, degrade):
    """A ZMW whose serial rescue fails too is quarantined: tallied Other,
    or with degrade_quarantined emitted as its draft, flagged draft_only,
    QVs capped; the others are untouched."""
    _poison_batch(monkeypatch)
    _poison_serial(monkeypatch)
    quarantine.reset_event_counts()
    settings = tp.ConsensusSettings(degrade_quarantined=degrade)
    tally = tp.process_chunks(_chunks(), settings, device="cpu")
    ev = quarantine.event_counts()
    assert ev["quarantined"] == 1 and ev["degraded"] == int(degrade)
    got = {r.id: r for r in tally.results}
    for k, r in clean.items():
        if k != POISON:
            _same(got[k], r)
    if degrade:
        assert tally.counts[tp.Failure.SUCCESS] == N_ZMWS
        d = got[POISON]
        assert d.draft_only
        assert (d.qvs == quarantine.DRAFT_QV_CAP).all()
        assert len(d.qvs) == len(d.sequence)
    else:
        assert POISON not in got
        assert tally.counts[tp.Failure.OTHER] == 1
        assert tally.counts[tp.Failure.SUCCESS] == N_ZMWS - 1


def test_serial_fallback_reruns_the_batch(monkeypatch, clean):
    """on_error="serial": every ZMW of the failed batch is re-polished by
    the serial scorer; the poison one is quarantined."""
    _poison_batch(monkeypatch)
    _poison_serial(monkeypatch)
    quarantine.reset_event_counts()
    tally = tp.process_chunks(_chunks(), on_error="serial", device="cpu")
    ev = quarantine.event_counts()
    assert ev["serial_rescues"] == N_ZMWS and ev["quarantined"] == 1
    assert ev["isolations"] == 0 and ev["bisect_dispatches"] == 0
    got = {r.id: r for r in tally.results}
    assert sorted(got) == sorted(k for k in clean if k != POISON)
    for k in got:
        assert got[k].sequence == clean[k].sequence


DEVICE_ERRORS = [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    KernelError("dense_score: CUDA launch failed with error 719"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
]


@pytest.mark.parametrize("exc", DEVICE_ERRORS,
                         ids=lambda e: type(e).__name__)
@pytest.mark.parametrize("on_error", ["bisect", "serial"])
def test_device_errors_are_reraised(monkeypatch, exc, on_error):
    dispatched = _poison_batch(monkeypatch, exc)
    quarantine.reset_event_counts()
    with pytest.raises(type(exc)):
        tp.process_chunks(_chunks(), on_error=on_error, device="cpu")
    assert len(dispatched) == 1
    assert quarantine.event_counts() == dict.fromkeys(
        quarantine.event_counts(), 0)


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device="meta")


def _refuse_arrow_fill():
    """K1's wrapper at a band width that was not built (224)."""
    R, I, J = 4, 80, 80
    i8, i32 = torch.int8, torch.int32
    fc.arrow_fill(_meta(R, I, dtype=i8), _meta(R, dtype=i32),
                  _meta(R, J, dtype=i8), _meta(R, J, 4), _meta(R, dtype=i32),
                  _meta(R, J + 1, dtype=i32), 224)


def _refuse_dense_score():
    """K3's wrapper given int64 read lengths."""
    R, I, J, W = 4, 80, 80, 64
    f32, i8, i32 = torch.float32, torch.int8, torch.int32
    dsc.dense_score(_meta(R, J + 1, W), _meta(R, J + 1, W),
                    _meta(R, J + 1, dtype=i32), _meta(R, J + 2),
                    _meta(R, J + 2), _meta(R, I, dtype=i8),
                    _meta(R, dtype=torch.int64), _meta(R, J, dtype=i8),
                    _meta(R, dtype=i32), _meta(R, J, 4, dtype=f32),
                    _meta(R, 8, 4), _meta(R, 2, dtype=i32))


def _refuse_quiver_fill():
    """K2's wrapper at a band width that is not a multiple of 32."""
    R, J = 4, 80
    i8, i32 = torch.int8, torch.int32
    qfc.quiver_fill(_meta(R, 82, qfc.N_COLS), _meta(R, dtype=i32),
                    _meta(R, J, dtype=i8), _meta(R, dtype=i32),
                    _meta(R, dtype=i32), _meta(R, dtype=i32),
                    _meta(R, J + 1, dtype=i32), 48, True, False)


REFUSALS = {"arrow_fill": (_refuse_arrow_fill, "band width 224"),
            "dense_score": (_refuse_dense_score, "rlens must be"),
            "quiver_fill": (_refuse_quiver_fill, "band width 48")}


@pytest.mark.parametrize("kernel", sorted(REFUSALS))
@pytest.mark.parametrize("on_error", ["bisect", "serial"])
def test_wrapper_refusal_is_reraised(monkeypatch, kernel, on_error):
    """A kernel wrapper that refuses its arguments before a launch (here
    on meta tensors, which pass the CPU branch by) is a fault of the
    program, not of the batch's ZMWs: process_chunks re-raises it from
    the first dispatch, with no bisection, rescue or quarantine."""
    refuse, match = REFUSALS[kernel]
    dispatched = []

    def dispatch(preps, settings, device, *, buckets=None):
        dispatched.append([p.chunk.id for p in preps])
        refuse()

    monkeypatch.setattr(tp, "_polish_batch_arrow", dispatch)
    quarantine.reset_event_counts()
    with pytest.raises(LaunchRefused, match=match) as e:
        tp.process_chunks(_chunks(), on_error=on_error, device="cpu")
    assert isinstance(e.value, KernelError) and is_device_error(e.value)
    assert len(dispatched) == 1
    assert quarantine.event_counts() == dict.fromkeys(
        quarantine.event_counts(), 0)


def test_device_error_in_serial_path_is_reraised(monkeypatch):
    """batch_polish=False: the per-ZMW isolation lets a device error
    through too."""
    def polish(prep, settings, *, device=None):
        raise KernelError("arrow_fill: CUDA launch failed with error 700")

    monkeypatch.setattr(tp, "polish_prepared", polish)
    with pytest.raises(KernelError):
        tp.process_chunks(_chunks()[:2], batch_polish=False, device="cpu")


@pytest.mark.parametrize("exc,want", [
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (RuntimeError("CUDA driver error: device not ready"), True),
    (KernelError("nvcc failed"), True),
    (LaunchRefused("arrow_fill: band width 224 is not one of ..."), True),
    (torch.cuda.OutOfMemoryError("out of memory"), True),
    (ValueError("template outgrew bucket"), False),
    (RuntimeError("shape mismatch"), False),
    (IndexError("index 5 is out of bounds"), False),
])
def test_is_device_error(exc, want):
    assert is_device_error(exc) is want
    try:
        try:
            raise exc
        except Exception as e:
            raise ValueError("wrapped") from e
    except ValueError as outer:
        assert is_device_error(outer) is want


def test_on_error_is_checked():
    with pytest.raises(ValueError, match="on_error"):
        tp.process_chunks(_chunks()[:1], on_error="retry", device="cpu")


def test_serial_process_chunks_matches_batch(clean):
    """batch_polish=False runs every ZMW through the serial scorer: the
    same consensus as the batch path, QVs within 1."""
    quarantine.reset_event_counts()
    tally = tp.process_chunks(_chunks(), batch_polish=False, device="cpu")
    assert quarantine.event_counts()["serial_rescues"] == 0
    assert tally.counts[tp.Failure.SUCCESS] == N_ZMWS
    for r in tally.results:
        c = clean[r.id]
        assert r.sequence == c.sequence
        assert np.abs(r.qvs.astype(int) - c.qvs.astype(int)).max() <= 1
