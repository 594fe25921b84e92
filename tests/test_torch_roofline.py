"""The port's roofline plane (obs/roofline.py), on the CPU.

Its cards are counted from the shapes (pbccs_tpu's come from XLA's cost
analysis, so only the plane's behaviour is held against pbccs_tpu's
tests/test_roofline.py, not its numbers): cards are deterministic and
round-trip byte-stable, charging is integer-exact, charging with no card
and a plane disabled by PBCCS_ROOFLINE=0 are no-ops, the efficiency
denominator is the card's (never a TPU figure), and `ccs roofline`
renders cards and ledgers.  The kernel work counts are the ones
chip_smoke.py's kernel table used before they moved here: at the main
path's shapes the bounds are K1 fused 0.303 ms, K3 all live 1.061 ms and
K2 log-likelihood-only 14.78 ms."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pbccs_tpu_torch.cli import run
from pbccs_tpu_torch.obs import roofline
from pbccs_tpu_torch.obs.ledger import PerfLedger
from pbccs_tpu_torch.obs.metrics import MetricsRegistry, default_registry
from pbccs_tpu_torch.ops import dense_score_cuda, quiver_fill_cuda
from pbccs_tpu_torch.parallel.batch import BatchPolisher, ZmwTask
from pbccs_tpu_torch.simulate import simulate_zmw

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GEOM = dict(imax=64, jmax=64, r=4, z=2, width=64, guided_passes=0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card(**over):
    geo = {**_GEOM, **over}
    return roofline.card_from_shapes(platform="cpu", **geo)


# ------------------------------------------------------------ work counts


def test_chip_smoke_bounds_come_from_the_counts():
    """chip_smoke's k1_bound, k3_bound and k2_bound give the moved
    counts' bytes and operations on CPU tensors at the main path's
    shapes (R = 384 reads, Jmax = 2112, W = 96; K2 at the scorer's
    26,816 rows x 2002 columns), and PR 8's bounds."""
    cs = _chip_smoke()
    R, Imax, Jmax, W = 384, 2304, 2112, 96
    reads = torch.zeros(R, Imax, dtype=torch.int8)
    tpls = torch.zeros(R, Jmax, dtype=torch.int8)
    for dirs in ((False, True), (False,), (True,)):
        ms, by, n_bytes, ops = cs.k1_bound(reads, tpls, W, dirs)
        assert (n_bytes, *ops) == roofline.k1_work(R, Imax, Jmax, W, dirs)
        assert ms == roofline.bound_seconds(n_bytes, *ops)[0] * 1e3
    assert round(cs.k1_bound(reads, tpls, W, (False, True))[0], 3) == 0.303
    ms, by, n_bytes, ops = cs.k3_bound(R, Jmax + 1, Imax, Jmax, W)
    assert (n_bytes, *ops) == roofline.k3_work(R, Jmax + 1, Imax, Jmax, W)
    assert round(ms, 3) == 1.061 and by == "operations"
    half = cs.k3_bound(R, Jmax + 1, Imax, Jmax, W, R * Jmax // 2, R * 17)
    assert half[2:] == (roofline.k3_work(R, Jmax + 1, Imax, Jmax, W,
                                         R * Jmax // 2, R * 17)[0],
                        roofline.k3_work(R, Jmax + 1, Imax, Jmax, W,
                                         R * Jmax // 2, R * 17)[1:])
    # K2: the forward-strand reads of a 2 kb ZMW against single-mutation
    # windows (deletion, substitution, insertion lengths), read-major
    rows, n_reads, P = 26816, 4, 2400
    M = -(-rows // n_reads)
    wlens = torch.as_tensor(np.resize([1999, 2000, 2001], M),
                            dtype=torch.int32)
    rx = dict(row_read=torch.arange(n_reads).repeat_interleave(M)[:rows],
              row_win=torch.arange(M).repeat(n_reads)[:rows],
              wins=torch.zeros(M, 2001, dtype=torch.int8), wlens=wlens)
    qx = dict(W=W, tables=torch.zeros(n_reads, P, roofline.K2_TABLE_COLS))
    for vals in (False, True):
        ms, by, n_bytes, ops = cs.k2_bound(qx, rx, vals)
        J = wlens[rx["row_win"].long()]
        cols = rows * 2002 if vals else int((J + 1).sum())
        assert (n_bytes, *ops) == roofline.k2_work(
            rows, M, 2001, W, n_reads, P, cols, vals)
    assert round(cs.k2_bound(qx, rx, False)[0], 2) == 14.78


def test_constants_are_the_kernels():
    assert roofline.K3_BLOCK == dense_score_cuda.PB
    assert roofline.K2_TABLE_COLS == quiver_fill_cuda.N_COLS
    assert roofline.RATE_INT_OP == 64 * 132 * 1.98e9
    assert roofline.RATE_F32_OP == 128 * 132 * 1.98e9


@pytest.mark.parametrize("passes", [0, 1, 3])
def test_setup_work_is_the_setups_k1_launches(passes):
    """No guided pass: one fused launch; g passes: g + 1 forward launches
    and one backward."""
    R = _GEOM["z"] * _GEOM["r"]
    got = roofline.setup_work(**{**_GEOM, "guided_passes": passes})
    args = (R, _GEOM["imax"], _GEOM["jmax"], _GEOM["width"])
    if passes == 0:
        assert got == roofline.k1_work(*args)
    else:
        f, b = roofline.k1_work(*args, (False,)), roofline.k1_work(
            *args, (True,))
        assert got == tuple((passes + 1) * x + y for x, y in zip(f, b))


# ------------------------------------------------------------ cards


def test_card_fields_are_counted():
    card = _card()
    n_bytes, n_int, n_f32 = roofline.setup_work(**_GEOM)
    assert (card.flops, card.int_ops, card.bytes_accessed) == (
        n_f32, n_int, n_bytes)
    assert card.optimal_seconds == pytest.approx(
        roofline.bound_seconds(n_bytes, n_int, n_f32)[0], rel=1e-5)
    assert card.peak_hbm_bytes == roofline.setup_peak_bytes(
        imax=64, jmax=64, r=4, z=2, width=64)
    assert card.intensity == round(n_f32 / n_bytes, 6)
    assert card.torch_version == torch.__version__
    assert card.label == "I64xJ64xR4" and card.platform == "cpu"
    assert not hasattr(card, "jax_version")


def test_cards_deterministic_and_byte_stable(tmp_path):
    path = str(tmp_path / "cards.json")
    cards = {c.label: c for c in (_card(), _card(jmax=128, z=3))}
    assert roofline.cards_to_doc(cards) == roofline.cards_to_doc(
        {c.label: c for c in (_card(), _card(jmax=128, z=3))})
    assert roofline.save_cards(path, cards)
    blob = open(path, "rb").read()
    assert roofline.load_cards(path) == cards
    assert roofline.save_cards(path, cards)
    assert open(path, "rb").read() == blob


def test_load_cards_tolerates_garbage(tmp_path):
    p = tmp_path / "cards.json"
    p.write_text("{not json")
    assert roofline.load_cards(str(p)) == {}
    p.write_text(json.dumps({"schema_version": 999, "cards": {}}))
    assert roofline.load_cards(str(p)) == {}
    assert roofline.load_cards(str(tmp_path / "missing.json")) == {}


def test_cards_path_default_and_override(monkeypatch, tmp_path):
    monkeypatch.delenv("PBCCS_ROOFLINE_CARDS", raising=False)
    assert roofline.cards_path() == os.path.join(_REPO, "build",
                                                 "roofline_cards.json")
    monkeypatch.setenv("PBCCS_ROOFLINE_CARDS", str(tmp_path / "c.json"))
    assert roofline.cards_path() == str(tmp_path / "c.json")


# ------------------------------------------------------------ the tracker


@pytest.fixture
def tracker(monkeypatch, tmp_path):
    monkeypatch.setenv("PBCCS_ROOFLINE_CARDS", str(tmp_path / "cards.json"))
    monkeypatch.delenv("PBCCS_ROOFLINE", raising=False)
    reg = MetricsRegistry()
    return roofline.RooflineTracker(reg), reg


def test_charging_is_integer_exact(tracker):
    tr, reg = tracker
    card = tr.ensure_card(**_GEOM, device="cpu")
    assert card is not None and tr.card(card.label) is card
    for z in (1, 2, 3, 5):
        scope = reg.scope()
        tr.charge_execution(imax=64, jmax=64, r=4, z=z)
        got = scope.counter_value(roofline.FLOPS_TOTAL, bucket=card.label)
        assert got == card.flops * z // card.z == card.flops_for(z)
        assert scope.counter_value(roofline.BYTES_TOTAL,
                                   bucket=card.label) == card.bytes_for(z)


def test_charging_without_card_is_noop(tracker):
    tr, reg = tracker
    scope = reg.scope()
    tr.charge_execution(imax=64, jmax=64, r=4, z=4)
    assert scope.delta() == {}


def test_disabled_plane_is_inert(tracker, monkeypatch):
    tr, reg = tracker
    monkeypatch.setenv("PBCCS_ROOFLINE", "0")
    assert tr.ensure_card(**_GEOM) is None
    tr.charge_execution(imax=64, jmax=64, r=4, z=4)
    with tr.refine_scope(imax=64, jmax=64, r=4):
        pass
    with tr.dispatch_scope("I64xJ64xR4"):
        pass
    assert tr.status_block() is None and reg.snapshot() == {}


def test_refine_and_dispatch_scopes_measure(tracker):
    tr, reg = tracker
    tr.ensure_card(**_GEOM, device="cpu")
    tr.charge_execution(imax=64, jmax=64, r=4, z=2)
    with tr.refine_scope(imax=64, jmax=64, r=4):
        pass
    with tr.dispatch_scope("I64xJ64xR4", zmws=2):
        with tr.dispatch_scope("I64xJ64xR4"):   # inner scope not counted
            pass
    block = tr.status_block()
    entry = block["buckets"]["I64xJ64xR4"]
    assert entry["flops_charged"] == _card().flops
    assert entry["dispatches"] == 1 and entry["refine_s"] >= 0
    assert block["peak_tflops"] == roofline.CPU_PEAK_TFLOPS
    values = {k: v for k, (_, v) in reg.snapshot().items()}
    assert (roofline.EFFICIENCY_OVERALL, ()) in values
    assert values[(roofline.BOUND_FLOPS, (("bucket", "I64xJ64xR4"),))] \
        == _card().flops


def test_peak_is_the_cards_never_a_tpu_figure(tracker, monkeypatch):
    """CPU: the nominal 0.1; an sm_90 card: SMs x 128 x 1.98 GHz; the
    env override wins."""
    tr, _ = tracker

    class Props:
        major, multi_processor_count = 9, 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    assert tr.peak_tflops(torch.device("cpu")) == 0.1
    assert tr.peak_tflops(torch.device("cuda", 0)) == pytest.approx(
        132 * 128 * 1.98e9 / 1e12)
    monkeypatch.setenv("PBCCS_ROOFLINE_PEAK_TFLOPS", "12.5")
    assert tr.peak_tflops(torch.device("cuda", 0)) == 12.5
    assert not hasattr(roofline, "PLATFORM_PEAK_TFLOPS")


def test_batch_polisher_notes_charges_and_scopes(monkeypatch, tmp_path):
    """BatchPolisher notes its bucket's card before the first setup,
    charges the setup and measures refine: on the CPU, through the
    process-wide tracker (emptied first: other tests of the process may
    have noted the bucket), and persists the card."""
    monkeypatch.setenv("PBCCS_ROOFLINE_CARDS", str(tmp_path / "cards.json"))
    roofline.tracker().reset_for_tests()
    rng = np.random.default_rng(5)
    tpl, reads, strands, snr = simulate_zmw(rng, 40, 3)
    task = ZmwTask("m/1", tpl, snr, reads, strands, [0] * 3, [len(tpl)] * 3)
    scope = default_registry().scope()
    pol = BatchPolisher([task], device="cpu")
    pol.refine()
    label = roofline.bucket_label(pol._Imax, pol._Jmax, pol._R)
    card = roofline.tracker().card(label)
    assert card is not None and card.width == pol._W
    assert scope.counter_value(roofline.FLOPS_TOTAL, bucket=label) == \
        card.flops_for(pol._Z)
    assert scope.counter_value(roofline.REFINE_SECONDS, bucket=label) > 0
    assert label in roofline.load_cards(str(tmp_path / "cards.json"))


# ------------------------------------------------------------ ccs roofline


def test_ccs_roofline_cards_report(tmp_path, capsys):
    path = str(tmp_path / "cards.json")
    roofline.save_cards(path, {"I64xJ64xR4": _card()})
    assert run(["roofline", "--cards", path, "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["source"] == "cards"
    [row] = doc["rows"]
    assert row["bucket"] == "I64xJ64xR4" and row["flops"] == _card().flops
    assert row["torch_version"] == torch.__version__
    assert run(["roofline", "--cards", path]) == 0
    assert "I64xJ64xR4" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no cards"):
        run(["roofline", "--cards", str(tmp_path / "none.json")])


def test_ccs_roofline_ledger_report(tmp_path, capsys):
    path = str(tmp_path / "ledger.ndjson")
    led = PerfLedger(path)
    led.append({"kind": "batch_run", "roofline_flops": 1000,
                "roofline_bytes": 2000, "roofline_achieved_tflops": 0.001,
                "roofline_efficiency": 0.01, "polish_dispatches": 3})
    led.close()
    assert run(["roofline", "--ledger", path, "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["source"] == "ledger"
    [row] = doc["rows"]
    assert row["flops"] == 1000 and row["efficiency"] == 0.01
    bare = str(tmp_path / "bare.ndjson")
    PerfLedger(bare).append({"kind": "batch_run"})
    with pytest.raises(SystemExit, match="no record with roofline"):
        run(["roofline", "--ledger", bare])
