"""The plain Arrow reference: its log-likelihoods and single-base
mutation scores against a dense recursion and a brute-force refill, its
QVs, and its bfloat16 control."""

from __future__ import annotations

import numpy as np
import pytest

import portbench_helpers  # noqa: F401  (puts the benchmark on the path)

import arrow_ref as A
import bench_sim
import judge
from pbccs_tpu_torch.ops.fwdbwd_ref import loglik_dense


def _zmw(seed, length=60, passes=3):
    cfg = {"insert_length": length, "passes": [passes, passes],
           "snr": [6.0, 12.0]}
    return bench_sim.make_pool(cfg, 1, 0, seed)[0]


def _full(z):
    return [(0, len(z.truth))] * len(z.reads)


def _mutated(tpl, p, s):
    if s < A.INS:
        t = tpl.copy()
        t[p] = s
        return t
    if s < A.DEL:
        return np.concatenate([tpl[:p], [s - A.INS], tpl[p:]]).astype(np.int8)
    return np.concatenate([tpl[:p], tpl[p + 1:]]).astype(np.int8)


def test_loglik_and_mutation_scores_match_a_dense_refill():
    z = _zmw(11)
    table = A.transition_table(z.snr)
    reads = [z.reads[0], z.reads[2]]
    pr = A.Pairs(reads, [z.truth] * 2, [table] * 2, "cpu", band=32)
    alpha, ll = A.fill_alpha(pr)
    beta, ll_b = A.fill_beta(pr)
    grid = A.slot_scores(pr, alpha, beta, ll, 0, 1 << 30)
    L = len(z.truth)
    for k, r in enumerate(reads):
        dense = loglik_dense(r, z.truth, A.track(z.truth, table))
        assert float(ll[k]) == pytest.approx(dense, abs=1e-5)
        assert float(ll_b[k]) == pytest.approx(dense, abs=1e-5)
        for p in range(2, L - 4):
            for s in range(A.N_SLOTS):
                if s == z.truth[p]:
                    assert np.isnan(grid[k, p, s])
                    continue
                t = _mutated(z.truth, p, s)
                want = loglik_dense(r, t, A.track(t, table)) - dense
                assert float(grid[k, p, s]) == pytest.approx(want, abs=1e-5)


def test_a_wider_band_changes_nothing():
    z = _zmw(12, length=400)
    table = A.transition_table(z.snr)
    lls = [float(A.fill_alpha(A.Pairs([z.reads[0]], [z.truth], [table],
                                      "cpu", band=b))[1][0])
           for b in (128, 256)]
    assert lls[0] == pytest.approx(lls[1], abs=1e-9)


def test_reverse_strand_reads_score_in_the_forward_frame():
    z = _zmw(13, length=90, passes=4)
    fwd = A.score_consensi([(z.truth, z.reads, z.strands, _full(z), z.snr)], "cpu",
                           edge=8)[0]
    rc = A.COMPLEMENT[z.truth[::-1].astype(np.int64)]
    back = A.score_consensi([(rc, z.reads, [1 - s for s in z.strands],
                              _full(z), z.snr)], "cpu", edge=8)[0]
    L = len(z.truth)
    # substitution at p to b is substitution at L-1-p to comp(b)
    for p in range(10, L - 10):
        for b in range(4):
            x = fwd["totals"][p, b]
            y = back["totals"][L - 1 - p, A.COMPLEMENT[b]]
            assert np.isnan(x) == np.isnan(y)
            if not np.isnan(x):
                assert x == pytest.approx(y, abs=1e-6)


def test_the_truth_is_near_a_local_optimum_and_an_altered_base_is_not():
    z = _zmw(14, length=150, passes=6)
    mask = A.unique_mask(z.truth)
    r = A.score_consensi([(z.truth, z.reads, z.strands, _full(z), z.snr)], "cpu",
                         edge=8)[0]
    assert np.nanmax(np.where(mask, r["totals"], np.nan)) < 3.0
    alt = z.truth.copy()
    alt[70] = (alt[70] + 1) % 4
    r2 = A.score_consensi([(alt, z.reads, z.strands, _full(z), z.snr)], "cpu",
                          edge=8)[0]
    assert np.nanmax(np.where(A.unique_mask(alt), r2["totals"],
                              np.nan)) > 20.0


def test_qvs_follow_the_formula():
    tot = np.full((3, A.N_SLOTS), np.nan)
    tot[0, :2] = [-3.0, -5.0]
    tot[1, 0] = 2.0
    tot[2, 0] = -1000.0
    mask = np.ones_like(tot, bool)
    s = np.exp(-3.0) + np.exp(-5.0)
    want = round(-10 * np.log10(s / (1 + s)))
    assert A.qvs(tot, mask).tolist() == [want, 93, 93]


def test_the_bfloat16_control_fails_where_float64_passes():
    z = _zmw(15, length=300, passes=5)
    seq = "".join("ACGT"[c] for c in z.truth)
    qv = A.qvs(A.score_consensi([(z.truth, z.reads, z.strands, _full(z), z.snr)],
                                "cpu", edge=judge.EDGE)[0]["totals"],
               A.unique_mask(z.truth))
    entry = [(0, "Success", z.id, seq, qv)]
    cfg = {"settings": {"min_zscore": -5.0, "min_passes": 3}}
    sound = judge.sample_numbers(entry, [z], cfg, "cpu")
    control = judge.sample_numbers(entry, [z], cfg, "cpu",
                                   A.Arith("bfloat16"), control=True)
    assert sound["qv_gap"] == 0.0
    assert control["qv_gap"] > 3.0 or control["unsupported_zmws"] > 0
    assert control["score_gap_nats"] > sound["score_gap_nats"]


def test_a_read_window_leaves_out_bases_no_read_covers():
    z = _zmw(16, length=200, passes=5)
    seq = "".join("ACGT"[c] for c in z.truth)
    junk = "ACGTTGCAAC"
    padded = junk + seq + junk[::-1]
    strands = judge.read_strands(padded, z.reads)
    assert strands == z.strands
    for ts, te in judge.read_windows(padded, z.reads, strands):
        assert abs(ts - len(junk)) <= 3 and abs(te - len(junk) - 200) <= 3
    css = np.concatenate([np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                                          np.frombuffer(junk.encode(),
                                                        np.uint8)),
                          z.truth.astype(np.int64),
                          np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                                          np.frombuffer(junk[::-1].encode(),
                                                        np.uint8))])
    wins = judge.read_windows(padded, z.reads, strands)
    r = A.score_consensi([(css, z.reads, strands, wins, z.snr)], "cpu",
                         edge=2)[0]
    # the junk takes no evidence: no read's score moves there
    assert np.nanmax(np.abs(r["totals"][2:len(junk) - 4])) == 0.0


def test_reads_the_program_left_out_are_counted():
    z = _zmw(17, length=300, passes=6)
    seq = "".join("ACGT"[c] for c in z.truth)
    cfg = {"settings": {"min_zscore": -5.0, "min_passes": 3}}

    def numbers(reads):
        qv = A.qvs(A.score_consensi(
            [(z.truth, reads, z.strands[:len(reads)],
              _full(z)[:len(reads)], z.snr)], "cpu",
            edge=judge.EDGE)[0]["totals"], A.unique_mask(z.truth),
            judge.QV_CAP)
        return judge.sample_numbers([(0, "Success", z.id, seq, qv)], [z],
                                    cfg, "cpu")

    assert numbers(z.reads)["dropped_read_pct"] == 0.0
    half = numbers(z.reads[:3])
    assert half["dropped_read_pct"] >= 100.0 * 2 / 6
    assert half["qv_gap"] < 1.0
