"""Plain Arrow pair-HMM in PyTorch: the reference that judges the port.

Scores reads against a consensus and every single-base mutation of it,
written from the model's equations (the recursion of ConsensusCore's
Arrow SimpleRecursor, the trained P6-C4 transition coefficients) and
nothing else: no kernel, no band schedule, no state of the program.

- The recursion runs in log space, by template column, over a band of
  `BAND` read rows centred on the straight line from (0, 0) to (I, J),
  far wider than a read strays from it.  The insertion moves inside a
  column are one affine scan, solved with logcumsumexp.
- A mutation's score per read comes from the forward columns up to the
  mutation, two or three columns recomputed on the mutated template, and
  the backward column where the two templates agree again: the sum over
  the rows of that column of (paths entering it) x (paths leaving it).
- `Arith` sets the precision: float64, or every value rounded to
  bfloat16 (the control of the correctness check).

Everything takes leading batch axes; nothing here knows of batches,
slots or windows of the program."""

from __future__ import annotations

import math

import numpy as np
import torch

#: miscall probability of the trained Arrow model (ArrowConfig.hpp:52)
MISMATCH_PROBABILITY = 0.00505052456472967
#: transition moves, in this order in every track
MATCH, BRANCH, STICK, DARK = 0, 1, 2, 3
#: trained P6-C4 SNR-polynomial coefficients per dinucleotide context
#: (ctx = next + 4 * (cur != next): AA CC GG TT NA NC NG NT); rows are
#: the softmax numerators Dark, Match, Stick (Branch is the reference),
#: columns [1, snr, snr^2, snr^3] of the next base's channel
#: (ConsensusCore Arrow ContextParameterProvider.cpp:23-66)
CONTEXT_COEFF = np.array([
    [[3.76122480667588, -0.536010820176981, 0.0275375059387171, -0.000470200724345621],
     [3.57517725358548, -0.0257545295375707, -0.000163673803286944, 5.3256984681724e-06],
     [0.858421613302247, -0.0276654216841666, -8.85549766507732e-05, -4.85355908595337e-05]],
    [[5.66725538674764, -1.10462196933913, 0.0879811093908922, -0.00259393800835979],
     [4.11682756767018, -0.124758322644639, 0.00659795177909886, -0.000361914629195461],
     [3.17103818507405, -0.729020290806687, 0.0749784690396837, -0.00262779517495421]],
    [[3.81920778703052, -0.540309003502589, 0.0389569264893982, -0.000901245733796236],
     [3.31322216145728, 0.123514009118836, -0.00807401406655071, 0.000230843924466035],
     [2.06006877520527, -0.451486652688621, 0.0375212898173045, -0.000937676250926241]],
    [[5.39308368236762, -1.32931568057267, 0.107844580241936, -0.00316462903462847],
     [4.21031404956015, -0.347546363361823, 0.0293839179303896, -0.000893802212450644],
     [2.33143889851302, -0.586068444099136, 0.040044954697795, -0.000957298861394191]],
    [[2.35936060895653, -0.463630601682986, 0.0179206897766131, -0.000230839937063052],
     [3.22847830625841, -0.0886820214931539, 0.00555981712798726, -0.000137686231186054],
     [-0.101031042923432, -0.0138783767832632, -0.00153408019582419, 7.66780338484727e-06]],
    [[5.956054206161, -1.71886470811695, 0.153315470604752, -0.00474488595513198],
     [3.89418464416296, -0.174182841558867, 0.0171719290275442, -0.000653629721359769],
     [2.40532887070852, -0.652606650098156, 0.0688783864119339, -0.00246479494650594]],
    [[3.53508304630569, -0.788027301381263, 0.0469367803413207, -0.00106221924705805],
     [2.85440184222226, 0.166346531056167, -0.0166161828155307, 0.000439492705370092],
     [0.238188180807376, 0.0589443522886522, -0.0123401045958974, 0.000336854126836293]],
    [[5.36199280681367, -1.46099908985536, 0.126755291030074, -0.0039102734460725],
     [3.41597143103046, -0.066984162951578, 0.0138944877787003, -0.000558939998921912],
     [1.37371376794871, -0.246963827944892, 0.0209674231346363, -0.000684856715039738]],
], dtype=np.float64)

#: read rows per template column; the band is centred on the diagonal
BAND = 256
#: slots per template position: substitution to A C G T, insertion of
#: A C G T before it, its deletion
N_SLOTS = 9
SUB, INS, DEL = 0, 4, 8
_LOG3 = math.log(3.0)
_NEG = -math.inf
COMPLEMENT = np.array([3, 2, 1, 0], np.int64)


class Arith:
    """The precision of a computation: the dtype values are held in and a
    rounding applied after every step."""

    def __init__(self, name: str):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x


F64 = Arith("float64")


def transition_table(snr) -> np.ndarray:
    """(8, 4) transition probabilities (Match, Branch, Stick, Dark) of each
    dinucleotide context at a ZMW's four channel SNRs, in float64."""
    chan = np.tile(np.asarray(snr, np.float64), 2)
    xb = np.exp(np.einsum("crp,cp->cr", CONTEXT_COEFF,
                          chan[:, None] ** np.arange(4)))
    den = 1.0 + xb.sum(-1)
    return np.stack([xb[:, 1] / den, 1.0 / den, xb[:, 2] / den,
                     xb[:, 0] / den], -1)


def context(cur, nxt):
    return nxt + 4 * (cur != nxt)


def track(tpl: np.ndarray, table: np.ndarray) -> np.ndarray:
    """(J, 4) moves leaving each template position; the last row is 0."""
    tpl = np.asarray(tpl, np.int64)
    out = np.zeros((len(tpl), 4))
    if len(tpl) > 1:
        out[:-1] = table[context(tpl[:-1], tpl[1:])]
    return out


def moments(trk: np.ndarray) -> tuple[float, float]:
    """Closed-form mean and variance of a read's log-likelihood under the
    model, summed over the template positions (ConsensusCore Arrow
    Expectations.hpp:11-57)."""
    live = trk.sum(-1) > 0
    p = np.maximum(trk[live], 1e-30)
    pm, pb, ps, pd = p[:, MATCH], p[:, BRANCH], p[:, STICK], p[:, DARK]
    eps = MISMATCH_PROBABILITY
    lg3 = -_LOG3

    def enn(lm, ld, lb, ls, em, ed, eb, es):
        md = (lm + em) * pm / (pm + pd) + (ld + ed) * pd / (pm + pd)
        ei = (lb + eb) * pb / (pb + ps) + (ls + es) * ps / (pb + ps)
        return md + ei * (ps + pb) / (pm + pd)

    lm, lb, ls, ld = np.log(pm), np.log(pb), np.log(ps), np.log(pd)
    mean = enn(lm, ld, lb, ls, eps * lg3, 0.0, 0.0, lg3)
    sq = enn(lm ** 2, ld ** 2, lb ** 2, ls ** 2, eps * lg3 * lg3, 0.0, 0.0,
             lg3 * lg3)
    return float(mean.sum()), float((sq - mean * mean).sum())


# ----------------------------------------------------------------- the fills

class Pairs:
    """N (read, template) pairs on one device, padded: reads (N, Imax) and
    templates (N, Jmax) as int64 codes, lengths I, J (N,), log move tracks
    ltr (N, Jmax, 4), the per-pair log transition table ltab (N, 8, 4),
    and the band's first row at each column, off (N, Jmax + 1)."""

    def __init__(self, reads, tpls, tables, device, ar: Arith = F64,
                 band: int = BAND):
        self.ar, self.band, self.device = ar, band, device
        n = len(reads)
        imax = max(len(r) for r in reads) + 1
        jmax = max(len(t) for t in tpls) + 1
        rd = np.full((n, imax), 4, np.int64)
        tp = np.full((n, jmax), 4, np.int64)
        tr = np.zeros((n, jmax, 4))
        for k, (r, t, tab) in enumerate(zip(reads, tpls, tables)):
            rd[k, :len(r)] = r
            tp[k, :len(t)] = t
            tr[k, :len(t)] = track(t, tab)
        I = np.array([len(r) for r in reads], np.int64)
        J = np.array([len(t) for t in tpls], np.int64)
        col = np.arange(jmax + 1)[None, :]
        centre = np.rint(col * I[:, None] / J[:, None]).astype(np.int64)
        top = np.maximum(I[:, None] + 1 - band, 0)
        off = np.clip(centre - band // 2, 0, top)
        t = lambda x, dt=torch.int64: torch.as_tensor(x, dtype=dt,  # noqa: E731
                                                      device=device)
        dt = ar.dtype
        with np.errstate(divide="ignore"):
            self.ltr = ar.r(t(np.log(tr), dt))
            self.ltab = ar.r(t(np.log(np.stack(tables)), dt))
        self.reads, self.tpls, self.I, self.J, self.off = (
            t(rd), t(tp), t(I), t(J), t(off))
        self.lhit = math.log(1.0 - MISMATCH_PROBABILITY)
        self.lmiss = math.log(MISMATCH_PROBABILITY / 3.0)
        self.lane = torch.arange(band, device=device)

    def read_at(self, rows, idx):
        """Read base at 0-based read position `rows` of pairs `idx`
        (4 outside the read)."""
        imax = self.reads.shape[1]
        return torch.where((rows >= 0) & (rows < imax),
                           self.reads[idx[:, None], rows.clamp(0, imax - 1)],
                           4)


def _shift(prev: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """prev's lanes moved by d (E,): out[:, k] = prev[:, k + d], -inf
    where k + d leaves the band."""
    band = prev.shape[-1]
    k = torch.arange(band, device=prev.device)[None, :] + d[:, None]
    inside = (k >= 0) & (k < band)
    return torch.where(inside, prev.gather(1, k.clamp(0, band - 1)), _NEG)


def _scan(b: torch.Tensor, c: torch.Tensor, ar: Arith) -> torch.Tensor:
    """x[k] = logaddexp(b[k], x[k-1] + c[k]) along the last axis."""
    s = ar.r(torch.cumsum(c, -1))
    return ar.r(s + ar.r(torch.logcumsumexp(ar.r(b - s), -1)))


def _entry(pr: Pairs, prev, d, rows, idx, t_cur, lm_prev, ld_prev, first):
    """Log of the paths entering column cells `rows` from the previous
    column (match and deletion moves), before the column's insertions."""
    ar = pr.ar
    rb = pr.read_at(rows - 1, idx)
    em = torch.where(rb == t_cur[:, None], pr.lhit, pr.lmiss).to(ar.dtype)
    diag = _shift(prev, d - 1)
    if first:
        return torch.where(rows == 1, ar.r(diag + em), _NEG)
    m = torch.where(rows >= 2, ar.r(ar.r(diag + em) + lm_prev[:, None]), _NEG)
    dl = ar.r(_shift(prev, d) + ld_prev[:, None])
    return ar.r(torch.logaddexp(m, dl))


def _insertions(pr: Pairs, rows, idx, t_next, ltr_cur):
    """Log coefficient of the insertion move into each row of a column."""
    rb = pr.read_at(rows - 1, idx)
    return torch.where(rb == t_next[:, None], ltr_cur[:, BRANCH:BRANCH + 1],
                       pr.ar.r(ltr_cur[:, STICK:STICK + 1] - _LOG3))


def _column(pr: Pairs, prev, d, rows, idx, t_cur, t_next, ltr_prev, ltr_cur,
            first=False):
    """One generic forward column: returns (entry, full column)."""
    valid = (rows >= 1) & (rows <= pr.I[idx, None] - 1)
    b = torch.where(valid, _entry(pr, prev, d, rows, idx, t_cur,
                                  ltr_prev[:, MATCH], ltr_prev[:, DARK],
                                  first), _NEG)
    c = torch.where(valid & (rows >= 2), _insertions(pr, rows, idx, t_next,
                                                     ltr_cur), 0.0)
    return b, torch.where(valid, _scan(b, c, pr.ar), _NEG)


def fill_alpha(pr: Pairs) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward band values (N, Jmax + 1, BAND) and each pair's
    log-likelihood (N,)."""
    n, jmax = pr.tpls.shape
    idx = torch.arange(n, device=pr.device)
    a = torch.full((n, jmax + 1, pr.band), _NEG, dtype=pr.ar.dtype,
                   device=pr.device)
    a[:, 0, 0] = 0.0
    zero4 = torch.zeros((n, 4), dtype=pr.ar.dtype, device=pr.device)
    for j in range(1, jmax):
        rows = pr.off[:, j, None] + pr.lane
        d = pr.off[:, j] - pr.off[:, j - 1]
        _, x = _column(pr, a[:, j - 1], d, rows, idx, pr.tpls[:, j - 1],
                       pr.tpls[:, j], pr.ltr[:, j - 2] if j >= 2 else zero4,
                       pr.ltr[:, j - 1], first=(j == 1))
        a[:, j] = torch.where((j <= pr.J - 1)[:, None], x, _NEG)
    last = pr.J - 1
    lane = pr.I - 1 - pr.off[idx, last]
    em = torch.where(pr.reads[idx, pr.I - 1] == pr.tpls[idx, last],
                     pr.lhit, pr.lmiss)
    ll = pr.ar.r(a[idx, last, lane.clamp(0, pr.band - 1)] + em)
    inside = (lane >= 0) & (lane < pr.band)
    return a, torch.where(inside, ll, _NEG)


def fill_beta(pr: Pairs) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward band values (N, Jmax + 1, BAND) on the same band rows and
    each pair's log-likelihood (N,)."""
    ar = pr.ar
    n, jmax = pr.tpls.shape
    idx = torch.arange(n, device=pr.device)
    bt = torch.full((n, jmax + 1, pr.band), _NEG, dtype=ar.dtype,
                    device=pr.device)
    I = pr.I[:, None]
    for j in range(jmax - 1, 0, -1):
        rows = pr.off[:, j, None] + pr.lane
        d = pr.off[:, j + 1] - pr.off[:, j]
        nxt = bt[:, j + 1]
        r_next = pr.read_at(rows, idx)             # read base i (0-based)
        t_next = pr.tpls[:, j]
        em = torch.where(r_next == t_next[:, None], pr.lhit, pr.lmiss
                         ).to(ar.dtype)
        ltr = pr.ltr[:, j - 1]
        generic = (j < pr.J - 1)[:, None]
        pinned = (j == pr.J - 1)[:, None]
        m = torch.where(generic & (rows <= I - 2),
                        ar.r(ar.r(_shift(nxt, 1 - d) + em)
                             + ltr[:, MATCH:MATCH + 1]),
                        torch.where(pinned & (rows == I - 1), em, _NEG))
        dl = torch.where(generic, ar.r(_shift(nxt, -d) + ltr[:, DARK:DARK + 1]),
                         _NEG)
        valid = (rows >= 1) & (rows <= I - 1) & (j <= pr.J - 1)[:, None]
        b = torch.where(valid, ar.r(torch.logaddexp(m, dl)), _NEG)
        c = torch.where(valid & (rows <= I - 2),
                        torch.where(r_next == t_next[:, None],
                                    ltr[:, BRANCH:BRANCH + 1],
                                    ar.r(ltr[:, STICK:STICK + 1] - _LOG3)),
                        0.0)
        x = _scan(b.flip(-1), c.flip(-1), ar).flip(-1)
        bt[:, j] = torch.where(valid, x, _NEG)
    lane = 1 - pr.off[:, 1]
    em = torch.where(pr.reads[:, 0] == pr.tpls[:, 0], pr.lhit, pr.lmiss)
    ll = ar.r(bt[idx, 1, lane.clamp(0, pr.band - 1)] + em)
    return bt, torch.where((lane >= 0) & (lane < pr.band), ll, _NEG)


# ------------------------------------------------------------ the mutations

def slot_scores(pr: Pairs, alpha, beta, ll, pos_lo: int, pos_hi: int,
                chunk: int = 1 << 15) -> torch.Tensor:
    """(N, Jmax, 9) log-likelihood change of each pair's read under every
    single-base mutation of its template (slots: substitution to A C G T,
    insertion of A C G T before the position, its deletion) at positions
    [max(pos_lo, 2), min(pos_hi, J - 4)); NaN elsewhere and for a
    substitution to the base already there."""
    ar = pr.ar
    n, jmax = pr.tpls.shape
    out = torch.full((n, jmax, N_SLOTS), math.nan, dtype=ar.dtype,
                     device=pr.device)
    pos = torch.arange(jmax, device=pr.device)
    live = ((pos[None, :] >= max(pos_lo, 2))
            & (pos[None, :] < torch.clamp(pr.J[:, None] - 4, max=pos_hi)))
    pair, p = torch.nonzero(live, as_tuple=True)
    pair = pair.repeat_interleave(N_SLOTS)
    p = p.repeat_interleave(N_SLOTS)
    slot = torch.arange(N_SLOTS, device=pr.device).repeat(len(pair)
                                                          // N_SLOTS)
    for lo in range(0, len(pair), chunk):
        e, q, s = pair[lo:lo + chunk], p[lo:lo + chunk], slot[lo:lo + chunk]
        out[e, q, s] = _link(pr, alpha, beta, ll, e, q, s)
    t = pr.tpls[pair[::N_SLOTS], p[::N_SLOTS]]
    out[pair[::N_SLOTS], p[::N_SLOTS], t] = math.nan   # sub to itself
    return out


def _link(pr: Pairs, alpha, beta, ll, e, p, s) -> torch.Tensor:
    """Score of slot s at position p of pair e, for E entries."""
    ar = pr.ar
    t = pr.tpls
    nb = torch.where(s < INS, s, torch.where(s < DEL, s - INS, 0))
    t_m1, t0, t1 = t[e, p - 1], t[e, p], t[e, p + 1]
    is_sub, is_ins, is_del = s < INS, (s >= INS) & (s < DEL), s == DEL
    tab = pr.ltab[e]

    def lt(a, b):
        return tab[torch.arange(len(e), device=e.device), context(a, b)]

    off = pr.off
    ltr_m2 = pr.ltr[e, p - 2]
    # column p of the mutated template (all three kinds)
    nxt_p = torch.where(is_del, t1, nb)
    ltr_p1 = lt(t_m1, nxt_p)                       # moves leaving p-1
    rows = off[e, p, None] + pr.lane
    _, col_p = _column(pr, alpha[e, p - 1], off[e, p] - off[e, p - 1], rows,
                       e, t_m1, nxt_p, ltr_m2, ltr_p1)
    # column p+1 (substitution, insertion); deletion links from column p
    nxt_q = torch.where(is_sub, t1, t0)
    ltr_q = lt(nb, nxt_q)                          # moves leaving p
    rows_q = off[e, p + 1, None] + pr.lane
    _, col_q = _column(pr, col_p, off[e, p + 1] - off[e, p], rows_q, e, nb,
                       nxt_q, ltr_p1, ltr_q)
    # the entry column, on the frame of the backward column it links to
    c0 = torch.where(is_ins, p + 1, p + 2)
    prev = torch.where(is_del[:, None], col_p, col_q)
    prev_off = torch.where(is_del, off[e, p], off[e, p + 1])
    t_cur = torch.where(is_del, t1, torch.where(is_sub, t1, t0))
    ltr_prev = torch.where(is_del[:, None], ltr_p1, ltr_q)
    rows_c = off[e, c0, None] + pr.lane
    valid = (rows_c >= 1) & (rows_c <= pr.I[e, None] - 1)
    b = torch.where(valid, _entry(pr, prev, off[e, c0] - prev_off, rows_c, e,
                                  t_cur, ltr_prev[:, MATCH],
                                  ltr_prev[:, DARK], False), _NEG)
    link = torch.logsumexp(ar.r(b + beta[e, c0]), -1)
    return ar.r(ar.r(link) - ll[e])


# ------------------------------------------------------------ per consensus

def score_consensi(items, device, ar: Arith = F64, edge: int = 16,
                   min_zscore: float = -5.0) -> list[dict]:
    """Every read of each ZMW scored against its window of the consensus
    and against each single-base mutation of the consensus, all ZMWs in
    one batch of pairs.

    items: (css, reads, strands, windows, snr) per ZMW -- the consensus
    as forward codes; the native read codes; 0 where a read runs along
    css, 1 where it runs along its reverse complement; each read's
    window [ts, te) of css; the channel SNRs.  A read is aligned end to
    end to its window (oriented by its strand) and a mutation outside
    the window leaves it unchanged.  Reads whose Z-score falls below
    `min_zscore` (NaN: none) take no part.  Returns per ZMW
    {"per_read": (n, L, 9) each read's scores in the forward frame, NaN
    outside [edge, L - edge), within a few bases of the read's window
    ends and for a substitution to the base there; "totals": (L, 9)
    their sum over the used reads; "ll", "z": (n,) per read; "used":
    (n,) bool}."""
    reads, tpls, tables = [], [], []
    for css, rds, strands, wins, snr in items:
        css = np.asarray(css, np.int64)
        table = transition_table(snr)
        for r, s, (ts, te) in zip(rds, strands, wins):
            w = css[ts:te]
            reads.append(r)
            tpls.append(COMPLEMENT[w[::-1]] if s else w)
            tables.append(table)
    pr = Pairs(reads, tpls, tables, device, ar)
    alpha, ll = fill_alpha(pr)
    beta, _ = fill_beta(pr)
    grid = slot_scores(pr, alpha, beta, ll, 0, 1 << 30
                       ).double().cpu().numpy()
    del alpha, beta
    ll = ll.double().cpu().numpy()
    out, k = [], 0
    for css, rds, strands, wins, snr in items:
        css = np.asarray(css, np.int64)
        L = len(css)
        n = len(rds)
        mv = [moments(track(tpls[k + i], tables[k + i])) for i in range(n)]
        z = np.array([(ll[k + i] - mu) / math.sqrt(max(var, 1e-12))
                      for i, (mu, var) in enumerate(mv)])
        used = np.isfinite(z) if np.isnan(min_zscore) else (
            np.isfinite(z) & (z >= min_zscore))
        per_read = np.zeros((n, L, N_SLOTS))
        for i, (s, (ts, te)) in enumerate(zip(strands, wins)):
            g = grid[k + i]
            if not s:
                per_read[i, ts:te] = g[:te - ts]
                continue
            # forward position p: substitution and deletion at te-1-p of
            # the reversed window, insertion before p at te-p, bases
            # complemented
            q = te - 1 - np.arange(ts, te)
            per_read[i, ts:te] = np.concatenate(
                [g[q][:, SUB + COMPLEMENT], g[q + 1][:, INS + COMPLEMENT],
                 g[q][:, DEL:DEL + 1]], 1)
        keep = np.zeros(L, bool)
        keep[edge:L - edge] = True
        per_read[:, ~keep] = np.nan
        per_read[:, np.arange(L), css] = np.nan
        total = per_read[used].sum(0) if used.any() else \
            np.where(np.isnan(per_read[0]), np.nan, 0.0)
        out.append({"totals": total, "per_read": per_read,
                    "ll": ll[k:k + n], "z": z, "used": used})
        k += n
    return out


def unique_mask(css: np.ndarray) -> np.ndarray:
    """(L, 9) the mutations the refine loop and QV sweep enumerate: three
    substitutions, insertions of a base other than the previous one, and
    the deletion of a base that starts its homopolymer
    (UniqueSingleBaseMutationEnumerator)."""
    css = np.asarray(css, np.int64)
    L = len(css)
    prev = np.concatenate([[-1], css[:-1]])
    m = np.zeros((L, N_SLOTS), bool)
    b = np.arange(4)[None, :]
    m[:, SUB:SUB + 4] = b != css[:, None]
    m[:, INS:INS + 4] = b != prev[:, None]
    m[:, DEL] = css != prev
    return m


def qvs(totals: np.ndarray, mask: np.ndarray, cap: float = 93) -> np.ndarray:
    """Per-position QV from the summed exp(score) of the negative-scoring
    mutations (ConsensusQVs, Consensus-inl.hpp:277-297), clamped to
    [0, cap]: 93 is the emitted read's qualities' ceiling; a position
    with no negative-scoring mutation reads `cap`."""
    sc = np.where(mask & np.isfinite(totals) & (totals < 0), totals, -np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        m = sc.max(-1)
        t = m + np.log(np.exp(sc - m[:, None]).sum(-1))
        qv = -10.0 * (t - np.logaddexp(0.0, t)) / math.log(10.0)
    qv = np.where(np.isfinite(m), np.rint(qv), cap)
    return np.clip(qv, 0, cap)
