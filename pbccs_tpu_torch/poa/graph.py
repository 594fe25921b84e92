"""Partial-order alignment (POA) draft stage -- host implementation.

The draft stage is graph-shaped and branchy, so (like the reference, which
keeps it a small fraction of per-ZMW cost next to polishing) it runs on the
host; the polish stage on device then dominates.  Column fills are
vectorized over read positions with a prefix-max trick for the within-column
insertion recurrence, so the Python layer does O(V) vector ops, not O(V*I)
scalar ops.  A native C++ engine is the planned drop-in replacement.

Semantics parity (re-derived, not transcribed):
  * LOCAL alignment of each read against the DAG, params
    match=+3, mismatch=-5, insert=-4, delete=-4
    (reference PoaConsensus.cpp:54-59 DefaultPoaConfig).
  * Each read is tried in both orientations; the better-scoring one is
    committed if its score >= 0 (reference src/SparsePoa.cpp:96-137).
  * Threading: every read base maps to a graph vertex (matched vertices are
    reused and their read count incremented; mismatches/inserts/unaligned
    prefixes+suffixes fork new vertex chains)
    (reference PoaGraphTraversals.cpp:227-395 tracebackAndThread).
  * Spanning-read tagging over the aligned span
    (reference PoaGraphTraversals.cpp:106-113 tagSpan).
  * Consensus = best-sum path over vertex scores
    2*reads - max(spanning, min_coverage) - 1e-4, DP over topological order
    (reference PoaGraphTraversals.cpp:116-192 consensusPath).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

MATCH_S, MISMATCH_S, INSERT_S, DELETE_S = 3.0, -5.0, -4.0, -4.0

# traceback move codes
_START, _MATCH, _DELETE, _EXTRA = 0, 1, 2, 3


@dataclasses.dataclass
class AlignmentPlan:
    """Result of a tentative read-vs-graph alignment (TryAddRead)."""

    score: float
    read: np.ndarray
    reverse_complemented: bool
    best_vertex: int
    best_row: int
    cols: np.ndarray       # (n_idx, I+1) scores per aligned vertex column
    match_pred: np.ndarray  # (n_idx, I+1) best predecessor for match move
    del_pred: np.ndarray    # (n_idx, I+1) best predecessor for delete move
    ranges: np.ndarray | None = None  # (n_idx, 2) banded DP rows, None=full


class PoaGraph:
    """A DAG of single bases with per-vertex read/spanning counts."""

    def __init__(self):
        self.base: list[int] = []
        self.nreads: list[int] = []
        self.spanning: list[int] = []
        self.preds: list[list[int]] = []
        self.succs: list[list[int]] = []
        self.n_reads = 0

    # ------------------------------------------------------------- plumbing

    def _add_vertex(self, base: int) -> int:
        # any graph mutation invalidates the consensus-path vertex scores
        # (find_possible_variants must see scores for the current topology)
        if hasattr(self, "vertex_score"):
            del self.vertex_score
        v = len(self.base)
        self.base.append(int(base))
        self.nreads.append(1)
        self.spanning.append(0)
        self.preds.append([])
        self.succs.append([])
        return v

    def _add_edge(self, u: int, v: int) -> None:
        if u == v:
            return
        if v not in self.succs[u]:
            self.succs[u].append(v)
            self.preds[v].append(u)

    def topo_order(self) -> list[int]:
        n = len(self.base)
        indeg = np.zeros(n, np.int64)
        for v in range(n):
            indeg[v] = len(self.preds[v])
        q = deque(v for v in range(n) if indeg[v] == 0)
        order = []
        while q:
            v = q.popleft()
            order.append(v)
            for w in self.succs[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    q.append(w)
        assert len(order) == n, "cycle in POA graph"
        return order

    # ------------------------------------------------------------ threading

    def add_first_read(self, read: np.ndarray) -> list[int]:
        """threadFirstRead (PoaGraphTraversals.cpp:194-225)."""
        path = []
        prev = -1
        for b in read:
            v = self._add_vertex(b)
            if prev >= 0:
                self._add_edge(prev, v)
            path.append(v)
            prev = v
        self.n_reads += 1
        self._tag_span(path[0], path[-1])
        return path

    def try_add_read(self, read: np.ndarray, reverse_complemented: bool = False,
                     ranges: np.ndarray | None = None,
                     order: list[int] | None = None) -> AlignmentPlan:
        """LOCAL-align `read` against the current graph without mutating it.

        `ranges` (from poa.banding.sdp_vertex_ranges) bands each vertex's
        column to DP rows [lo, hi); cells outside the band keep value 0 =
        "a LOCAL alignment may start here", so the banded fill stays a
        well-formed LOCAL DP and compute drops to O(V * band).  Storage
        here remains full-width (the native engine stores only the bands;
        this fallback favors simplicity).  `order` lets the caller reuse an
        already-computed topological order."""
        I = len(read)
        order = self.topo_order() if order is None else order
        n = len(self.base)

        cols = np.zeros((n, I + 1), np.float32)
        match_pred = np.full((n, I + 1), -1, np.int64)
        del_pred = np.full((n, I + 1), -1, np.int64)
        zeros = np.zeros(I + 1, np.float32)
        ramp = INSERT_S * np.arange(I + 1, dtype=np.float32)
        subs = np.where(read[None, :] == np.arange(4)[:, None],
                        MATCH_S, MISMATCH_S).astype(np.float32)

        for v in order:
            lo, hi = (0, I + 1) if ranges is None else map(int, ranges[v])
            L = hi - lo
            s = max(lo, 1)  # first row with a match/extra move
            sub = subs[self.base[v]] if 0 <= self.base[v] < 4 \
                else np.full(I, MISMATCH_S, np.float32)
            best_m = np.full(L, -np.inf, np.float32)
            best_d = np.full(L, -np.inf, np.float32)
            bm_pred = np.full(L, -1, np.int64)
            bd_pred = np.full(L, -1, np.int64)
            preds = self.preds[v] or [-1]
            for p in preds:
                pc = zeros if p < 0 else cols[p]
                m = np.full(L, -np.inf, np.float32)
                m[s - lo:] = pc[s - 1: hi - 1] + sub[s - 1: hi - 1]
                upd = m > best_m
                best_m = np.where(upd, m, best_m)
                bm_pred[upd] = p
                d = pc[lo:hi] + DELETE_S
                upd = d > best_d
                best_d = np.where(upd, d, best_d)
                bd_pred[upd] = p
            # cell = max(0, match, delete, extra) where extra chains within
            # the column: solved by prefix-max of (b - insert_ramp).
            b = np.maximum(0.0, np.maximum(best_m, best_d))
            cols[v, lo:hi] = np.maximum.accumulate(b - ramp[lo:hi]) + ramp[lo:hi]
            match_pred[v, lo:hi] = bm_pred
            del_pred[v, lo:hi] = bd_pred

        # best local end anywhere (EndMove, LOCAL)
        flat = int(np.argmax(cols))
        best_vertex, best_row = divmod(flat, I + 1)
        score = float(cols[best_vertex, best_row])
        return AlignmentPlan(score, np.asarray(read), reverse_complemented,
                             best_vertex, best_row, cols, match_pred, del_pred,
                             ranges)

    def commit_add(self, plan: AlignmentPlan) -> list[int]:
        """Thread the read along the traceback of `plan`; returns the read
        path (one vertex per read base).

        Mirrors tracebackAndThread (PoaGraphTraversals.cpp:227-395): matched
        vertices are reused; mismatch/extra bases fork new vertices chained
        toward `fork` (the next vertex of the read's path); deletions skip
        graph vertices; unaligned read prefix/suffix become fresh chains."""
        read = plan.read
        I = len(read)
        path = [-1] * I
        cols = plan.cols

        def new_chain_vertex(i, fork):
            nv = self._add_vertex(read[i - 1])
            if fork >= 0:
                self._add_edge(nv, fork)
            path[i - 1] = nv
            return nv

        # thread unaligned suffix (EndMove, LOCAL)
        fork = -1
        i = I
        while i > plan.best_row:
            fork = new_chain_vertex(i, fork)
            i -= 1

        v = plan.best_vertex
        prev_visited = -1  # reference's `v`: vertex last visited in traceback
        while v >= 0 and i >= 0:
            if plan.ranges is not None and not (
                    plan.ranges[v, 0] <= i < plan.ranges[v, 1]):
                break  # walked outside the band: treat as StartMove
            cell = cols[v, i]
            vb = self.base[v]
            mp = plan.match_pred[v, i]
            dp = plan.del_pred[v, i]
            if i > 0:
                sub = MATCH_S if read[i - 1] == vb else MISMATCH_S
                m_val = (cols[mp, i - 1] if mp >= 0 else 0.0) + sub
                e_val = cols[v, i - 1] + INSERT_S
            else:
                m_val = e_val = -np.inf
            d_val = (cols[dp, i] if dp >= 0 else 0.0) + DELETE_S

            if i > 0 and cell == m_val:
                if read[i - 1] == vb:
                    if hasattr(self, "vertex_score"):
                        del self.vertex_score  # coverage changed
                    self.nreads[v] += 1
                    if fork >= 0:
                        self._add_edge(v, fork)
                        fork = -1
                    path[i - 1] = v
                else:
                    if fork < 0:
                        fork = prev_visited
                    fork = new_chain_vertex(i, fork)
                i -= 1
                prev_visited = v
                v = mp
            elif cell == d_val and dp >= 0:
                if fork < 0:
                    fork = prev_visited
                prev_visited = v
                v = dp
            elif i > 0 and cell == e_val:
                if fork < 0:
                    fork = prev_visited
                fork = new_chain_vertex(i, fork)
                i -= 1
            else:
                break  # StartMove: alignment starts here

        # thread remaining prefix as a new chain
        if i > 0 and fork < 0:
            fork = prev_visited
        while i > 0:
            fork = new_chain_vertex(i, fork)
            i -= 1

        self.n_reads += 1
        self._tag_span(path[0], plan.best_vertex)
        return path

    def _tag_span(self, start: int, end: int) -> None:
        """SpanningReads++ on every vertex lying on a path start->end."""
        fwd = self._reachable(start, self.succs)
        bwd = self._reachable(end, self.preds)
        for v in fwd & bwd:
            self.spanning[v] += 1

    def _reachable(self, root: int, adj: list[list[int]]) -> set[int]:
        seen = {root}
        stack = [root]
        while stack:
            u = stack.pop()
            for w in adj[u]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return seen

    # ------------------------------------------------------------ consensus

    def consensus_path(self, min_coverage: int) -> list[int]:
        order = self.topo_order()
        reach = {}
        best_prev = {}
        best_v, best_score = -1, -np.inf
        self.vertex_score = np.zeros(len(self.base), np.float32)
        for v in order:
            score = 2.0 * self.nreads[v] - max(self.spanning[v], min_coverage) - 1e-4
            self.vertex_score[v] = score
            r = score
            bp = -1
            for p in self.preds[v]:
                c = score + reach[p]
                if c > r:
                    r = c
                    bp = p
            reach[v] = r
            best_prev[v] = bp
            if r > best_score or (r == best_score and v < best_v):
                best_score = r
                best_v = v
        path = []
        v = best_v
        while v >= 0:
            path.append(v)
            v = best_prev[v]
        path.reverse()
        return path

