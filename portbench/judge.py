"""Whether what the timed polish returned is correct.

The window's outcomes arrive as plain records (pool index, status, id,
sequence, QVs), so nothing here knows the program.  Five numbers are
compared, each against the limit that `limits/<config>.json` sets from
measured readings (PERF.md gives them):

- bad_outcomes: outcomes that are missing, `Other`, carry another ZMW's
  id, or emit a read whose QVs do not cover its bases;
- unsupported_zmws: sampled Success reads that fewer than the
  configuration's min_passes of their ZMW's subreads support (a read
  supports the consensus when the reference's Z-score of it against its
  window of the consensus passes the configuration's gate);
- qv_gap: the largest mean, over one sampled read's positions away from
  its ends, of |the program's QV - the reference's QV| (both clamped to
  [0, QV_CAP]), the reference's QVs taken over the supporting subreads
  less those the program can be seen to have dropped (_read_set);
- dropped_read_pct: the share, in %, of the subreads the reference's
  own gate keeps for the sampled reads that _read_set finds the program
  left out (a read gate, mask or shed in the program that drops reads
  it should keep shows here, and nowhere else: the other numbers are
  taken over the read set that _read_set fitted);
- score_gap_nats: the widest gap, over the sampled Success reads and
  every position away from their ends, by which the emitted consensus
  lies below the best single-base mutation of it, under the plain Arrow
  reference summed over the same subreads;
- favorable_per_kb: the positions away from the ends where that gap
  passes FAVORABLE_NATS, per 1,000 bases, over all the sampled Success
  reads together (a read whose subread the program shed after some
  rounds keeps positions polished with it, which its one read would
  put far above the rest).

Each number is taken over the window's outcomes and again over those of
the check batch, a pool whose content the seed draws polished after the
window, and the two are merged (counts added, the worse of the rest).
The sample of each is drawn from the seed among its Success outcomes,
one per ZMW, and holds its longest consensus."""

from __future__ import annotations

import math

import numpy as np

import arrow_ref as ar
import edit_qv

#: the least fall of the mean |QV difference| for which the reference
#: takes a read out of the set it judges a ZMW's QVs with
DROP_GAIN = 0.5
#: bases at each end of a consensus that the gap and QV numbers leave
#: out: there the subreads' windows, which the program takes from its
#: draft and the reference from the consensus, differ by a few bases
EDGE = 16
#: the QVs compared are the program's own values up to this, past the
#: emitted qualities' 93: at 30 passes nearly every QV passes 93, and a
#: QV computed in bfloat16 differs only there
QV_CAP = 1000
#: the gain in nats past which a position counts as favorable
FAVORABLE_NATS = 3.0
NUMBERS = ("bad_outcomes", "unsupported_zmws", "qv_gap", "score_gap_nats",
           "favorable_per_kb", "dropped_read_pct")
#: the status of a dispatched ZMW the polish returned no outcome for
MISSING = "Missing"
#: how the numbers of two judged sets of outcomes (the window's and the
#: check batch's) combine
_ADDED = ("bad_outcomes", "unsupported_zmws")


def filtered_reads(reads: list) -> list:
    """The subreads the pipeline's read filter keeps: non-empty, ACGT
    only, shorter than twice the median length (reference FilterReads,
    Consensus.h:224-292; all simulated subreads are full passes)."""
    med = float(np.median([len(r) for r in reads]))
    return [r for r in reads
            if 0 < len(r) < 2.0 * med and bool((np.asarray(r) < 4).all())]


def read_strands(css_seq: str, reads: list) -> list[int]:
    """0 where a subread runs along the consensus, 1 where it runs along
    the reverse complement, by shared 12-mers."""
    fwd = edit_qv.kmers(css_seq)
    rev = edit_qv.kmers(edit_qv.revcomp(css_seq))
    return [0 if edit_qv.same_strand(edit_qv.decode(r), fwd, rev) else 1
            for r in reads]


def read_windows(css_seq: str, reads: list, strands: list) -> list:
    """Each subread's window [ts, te) of the consensus: the stretch the
    whole read aligns to with the fewest edits, on its strand.  Where a
    consensus keeps bases no read covers (the program clips reads to
    its draft's extents and cannot polish past them), the windows leave
    them out."""
    L = len(css_seq)
    rc = edit_qv.revcomp(css_seq)
    out = []
    for r, s in zip(reads, strands):
        ts, te = edit_qv.window(edit_qv.decode(r), rc if s else css_seq)
        out.append((L - te, L - ts) if s else (ts, te))
    return out


def outcome_numbers(batches, pool) -> dict:
    """bad_outcomes over every outcome of a set of batches.  batches: per
    batch a list of (pool index, status, id, seq, qvs), one for each ZMW
    dispatched, with the status MISSING where the polish returned none."""
    bad = 0
    for batch in batches:
        for zi, status, rid, seq, q in batch:
            if status != "Success":
                bad += status in ("Other", MISSING)
            elif rid != pool[zi].id or len(seq) == 0 or len(seq) != len(q):
                bad += 1
    return {"bad_outcomes": bad}


def draw_sample(batches, n: int, seed: int) -> list[tuple[int, int]]:
    """(batch, position) of n Success outcomes of distinct ZMWs, drawn
    from the seed, the longest consensus of the window first."""
    ok = [(b, k) for b, batch in enumerate(batches)
          for k, o in enumerate(batch) if o[1] == "Success"]
    if not ok:
        return []
    rng = np.random.default_rng([seed % (1 << 63), 0x6A75646765])
    longest = max(ok, key=lambda bk: len(batches[bk[0]][bk[1]][3]))
    picked, seen = [longest], {batches[longest[0]][longest[1]][0]}
    for i in rng.permutation(len(ok)):
        if len(picked) >= n:
            break
        b, k = ok[i]
        zi = batches[b][k][0]
        if zi not in seen:
            seen.add(zi)
            picked.append((b, k))
    return picked


def _read_set(per_read, used, mask, qv, inner):
    """The subset of the usable reads whose QVs explain `qv` best: from
    all of them, drop the read whose removal lowers the mean |QV
    difference| most, while that gains more than DROP_GAIN and one read
    at least remains.  The program drops reads too: at its draft (the
    Z-score gate) and whenever a read's fills stop mating after a round
    of mutations, which needs no least number of reads left, and the
    reference cannot follow it there."""
    def mismatch(sel):
        ref_qv = ar.qvs(per_read[sel].sum(0), mask, QV_CAP)
        return float(np.abs(qv[inner] - ref_qv[inner]).mean())

    sel = used.copy()
    cur = mismatch(sel) if sel.any() else np.inf
    while sel.sum() > 1:
        trials = []
        for i in np.flatnonzero(sel):
            t = sel.copy()
            t[i] = False
            trials.append((mismatch(t), i))
        best, i = min(trials)
        if best > cur - DROP_GAIN:
            break
        sel[i], cur = False, best
    return sel, cur


def sample_numbers(entries, pool, cfg, device, arith: ar.Arith = ar.F64,
                   control: bool = False) -> dict:
    """unsupported_zmws, score_gap_nats, qv_gap, favorable_per_kb and
    dropped_read_pct over the sampled Success outcomes `entries` ((pool
    index, status, id, seq, qvs)).

    Each read's scores come from the float64 reference; the read set is
    the one whose QVs explain the emitted QVs best (_read_set).  With
    `control`, the reference computed in `arith` stands in the program's
    place: on the same consensus, at each position it puts first
    whichever of the base there and its mutations it scores best, and
    its own QVs and Z-scores are the ones judged."""
    if not entries:
        return {"unsupported_zmws": 0, "score_gap_nats": 0.0, "qv_gap": 0.0,
                "favorable_per_kb": 0.0, "dropped_read_pct": 0.0}
    min_z = float(cfg["settings"].get("min_zscore", -5.0))
    min_passes = int(cfg["settings"].get("min_passes", 3))
    items = []
    for zi, _, _, seq, _ in entries:
        reads = filtered_reads(pool[zi].reads)
        css = np.frombuffer(seq.encode(), np.uint8)
        css = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), css)
        strands = read_strands(seq, reads)
        items.append((css, reads, strands,
                      read_windows(seq, reads, strands), pool[zi].snr))
    ref = ar.score_consensi(items, device, ar.F64, EDGE, min_z)
    alt = ar.score_consensi(items, device, arith, EDGE, min_z) \
        if control else None
    unsupported, gap, qv_gap = 0, 0.0, 0.0
    usable = dropped = favorable = bases = 0
    for i, (entry, it) in enumerate(zip(entries, items)):
        css = it[0]
        L = len(css)
        if L <= 2 * EDGE:
            continue
        mask = ar.unique_mask(css) & np.isfinite(ref[i]["totals"])
        inner = slice(EDGE, L - EDGE)
        if control:
            mine = np.where(mask, alt[i]["totals"], -np.inf)
            their_qv = ar.qvs(alt[i]["totals"], mask, QV_CAP)
            used = alt[i]["used"]
        else:
            their_qv = np.clip(np.asarray(entry[4], np.float64), 0, QV_CAP)
            used = ref[i]["used"]
        if int(used.sum()) < min_passes:
            unsupported += 1
            continue
        sel, mis = _read_set(ref[i]["per_read"], used, mask, their_qv,
                             inner)
        usable += int(used.sum())
        dropped += int(used.sum()) - int(sel.sum())
        tot = np.where(mask, ref[i]["per_read"][sel].sum(0), -np.inf)
        best = np.maximum(tot.max(-1), 0.0)            # per position
        if control:
            pick = mine.argmax(-1)
            took = mine[np.arange(L), pick] > 0.0
            gaps = best - np.where(took, tot[np.arange(L), pick], 0.0)
        else:
            gaps = best
        gap = max(gap, float(gaps[inner].max()))
        favorable += int((gaps[inner] > FAVORABLE_NATS).sum())
        bases += L
        qv_gap = max(qv_gap, mis)
    return {"unsupported_zmws": unsupported, "score_gap_nats": gap,
            "qv_gap": qv_gap,
            "favorable_per_kb": 1e3 * favorable / bases if bases else 0.0,
            "dropped_read_pct": 100.0 * dropped / usable if usable else 0.0}


def merged(a: dict, b: dict) -> dict:
    """The numbers of two judged sets together: counts added, the rest
    the worse of the two."""
    return {k: a[k] + b[k] if k in _ADDED else max(a[k], b[k]) for k in a}


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(correct, one line per number with its limit)."""
    ok, lines = True, []
    for name in NUMBERS:
        v, lim = numbers[name], float(limits[name])
        good = math.isfinite(float(v)) and float(v) <= lim
        ok &= good
        lines.append(f"{name} {v} limit {lim} {'ok' if good else 'FAIL'}")
    return ok, lines
