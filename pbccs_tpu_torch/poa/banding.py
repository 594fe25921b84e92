"""SDP-anchored POA banding: per-vertex alignable read ranges.

Parity: reference ConsensusCore/src/C++/Poa/RangeFinder.cpp:72-167
(SdpRangeFinder::InitRangeFinder) + src/SparsePoa.cpp:65-69 (anchors from
SparseAlign).  Semantics re-derived:

  * anchors = chained shared k-mers between the graph's current consensus
    sequence and the read, (cssPos, readPos) pairs;
  * a consensus-path vertex whose cssPos carries an anchor gets the direct
    range [readPos - WIDTH, readPos + WIDTH) clamped to the read;
  * a forward pass in topological order gives anchorless vertices the union
    of their predecessors' ranges stepped +1 (clamped), a reverse pass the
    union of successors' ranges stepped -1; the final range is the hull of
    both passes.

Note the reference snapshot *computes* these ranges but its
makeAlignmentColumn ignores beginRow/endRow and still fills full columns
(PoaGraphImpl.cpp:235-352); here the ranges genuinely band the fill, making
the draft stage O(V * band) instead of O(V * I) -- the behavior later
upstream versions adopted and the property long reads need.

k-mer size: the reference uses k=6 (SparsePoa.cpp:65-69).  At k=6 two L-bp
sequences share ~L^2/4096 random k-mers, which is fine at the reference's
operating point but quadratic-explodes for 10kb+ inserts, so beyond
_LONG_SEQ the anchor finder switches to k=10 (the reference's own default
FindSeedsConfig TSize elsewhere, SparseAlignment.h:278) where random
collisions stay rare while true anchors remain dense.
"""

from __future__ import annotations

import bisect
import os

import numpy as np

from pbccs_tpu_torch.align.seeds import find_seeds


def banding_enabled() -> bool:
    """SDP-anchored banding of the read-vs-graph fill (PBCCS_POA_BAND=0
    disables, falling back to full-width columns for A/B comparison)."""
    return os.environ.get("PBCCS_POA_BAND", "").strip().lower() not in (
        "0", "false", "off", "no")

WIDTH = 30          # reference RangeFinder.cpp:15
_LONG_SEQ = 1000    # switch from k=6 to k=10 above this length
_MAX_OCC = 64       # mask k-mers occurring more often than this in the css
_BIG = np.int64(1) << 40


def anchor_k(len_css: int, len_read: int) -> int:
    return 6 if max(len_css, len_read) < _LONG_SEQ else 10


def anchor_chain(seeds: np.ndarray) -> np.ndarray:
    """Longest strictly-increasing (cssPos, readPos) subsequence of the
    seeds -- the banding anchor chain.

    The reference chains banding anchors with its full gain-scored SDP
    (ChainSeeds.cpp:203-361, O(n log n) via sweep-line visibility sets);
    the numpy/native chainers here are O(n^2) all-pairs, quadratic in
    template length since anchors ~ L/5.  Banding only needs a monotone
    anchor backbone (ranges are +-WIDTH hulls anyway), so this O(n log n)
    patience LIS -- implemented identically in native/pbccs_native.cpp
    (AnchorChain) -- replaces the scored chain on the banding path only."""
    n = len(seeds)
    if n == 0:
        return seeds.reshape(0, 2)
    # sort by cssPos asc, readPos DESC so equal-cssPos seeds cannot chain
    # onto each other under the strict-increase rule below
    s = seeds[np.lexsort((-seeds[:, 1], seeds[:, 0]))]
    rs = s[:, 1].tolist()
    tails_r: list[int] = []
    tails_i: list[int] = []
    parent = [-1] * n
    for i, r in enumerate(rs):
        k = bisect.bisect_left(tails_r, r)  # strictly increasing readPos
        parent[i] = tails_i[k - 1] if k else -1
        if k == len(tails_r):
            tails_r.append(r)
            tails_i.append(i)
        else:
            tails_r[k] = r
            tails_i[k] = i
    chain = []
    i = tails_i[-1]
    while i >= 0:
        chain.append(i)
        i = parent[i]
    chain.reverse()
    return s[chain]


def sdp_vertex_ranges(n_vertices: int,
                      order: list[int],
                      preds: list[list[int]],
                      succs: list[list[int]],
                      css_path: list[int],
                      chain: np.ndarray,
                      read_len: int,
                      width: int = WIDTH) -> np.ndarray | None:
    """(n_vertices, 2) DP-row ranges [lo, hi) per vertex from a chained
    anchor set (anchor_chain over find_seeds css<->read), or None when the
    chain is too thin to band safely (caller falls back to the full-width
    fill)."""
    I = read_len
    if len(chain) < 2:
        return None

    # hull-identity encoding: empty = (+BIG, -BIG)
    lo = np.full(n_vertices, _BIG, np.int64)
    hi = np.full(n_vertices, -_BIG, np.int64)
    direct = np.zeros(n_vertices, bool)
    path = np.asarray(css_path, np.int64)
    vs = path[chain[:, 0]]
    rp = chain[:, 1].astype(np.int64)
    lo[vs] = np.maximum(rp - width, 0)
    hi[vs] = np.minimum(rp + width, I)
    direct[vs] = True

    flo, fhi = lo.copy(), hi.copy()
    for v in order:
        if not direct[v] and preds[v]:
            b, e = _BIG, -_BIG
            for p in preds[v]:
                if flo[p] <= fhi[p]:  # stepped empty stays empty
                    b = min(b, min(flo[p] + 1, I))
                    e = max(e, min(fhi[p] + 1, I))
            flo[v], fhi[v] = b, e

    rlo, rhi = lo.copy(), hi.copy()
    for v in reversed(order):
        if not direct[v] and succs[v]:
            b, e = _BIG, -_BIG
            for s in succs[v]:
                if rlo[s] <= rhi[s]:
                    b = min(b, max(rlo[s] - 1, 0))
                    e = max(e, max(rhi[s] - 1, 0))
            rlo[v], rhi[v] = b, e

    lo = np.minimum(flo, rlo)
    hi = np.maximum(fhi, rhi)
    empty = lo > hi
    lo[empty] = 0
    hi[empty] = I

    # read positions [lo, hi] -> DP rows [lo, hi+2) (row i consumes read
    # position i-1; +1 more so a trailing delete/extra row is reachable)
    out = np.empty((n_vertices, 2), np.int64)
    out[:, 0] = np.clip(lo, 0, I)
    out[:, 1] = np.clip(hi + 2, 1, I + 1)
    out[:, 1] = np.maximum(out[:, 1], out[:, 0] + 1)
    return out
