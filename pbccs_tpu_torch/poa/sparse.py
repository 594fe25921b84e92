"""SparsePoa equivalent: orientation handling + consensus + per-read extents.

Parity: reference src/SparsePoa.cpp:96-199 / include/pacbio/ccs/SparsePoa.h.

The alignment/threading engine has two behavior-identical backends: the
native C++ engine (native/pbccs_native.cpp, used when the library loads --
the draft stage is the host-side bottleneck once polishing runs on the
accelerator) and the pure-Python PoaGraph (the reference implementation and
fallback; PBCCS_NATIVE=0 forces it).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pbccs_tpu_torch import native
from pbccs_tpu_torch.align.seeds import find_seeds
from pbccs_tpu_torch.models.arrow.params import revcomp
from pbccs_tpu_torch.poa.banding import (_MAX_OCC, anchor_chain,
                                         anchor_k, banding_enabled,
                                         sdp_vertex_ranges)
from pbccs_tpu_torch.poa.graph import PoaGraph


@dataclasses.dataclass
class PoaAlignmentSummary:
    """Reference SparsePoa.h:71-86."""

    reverse_complemented: bool = False
    extent_on_read: tuple[int, int] = (0, 0)
    extent_on_consensus: tuple[int, int] = (0, 0)


class SparsePoa:
    def __init__(self):
        self._native = native.native_poa()
        self._graph = PoaGraph() if self._native is None else None
        self._snapshot: PoaGraph | None = None
        self.read_paths: list[list[int]] = []
        self.reverse_complemented: list[bool] = []

    @property
    def graph(self) -> PoaGraph:
        """The POA graph.  On the Python backend this is the live graph; on
        the native backend it is a READ-ONLY snapshot (bases/edges/counts/
        consensus scores) cached until the next added read -- mutations made
        to the snapshot are discarded."""
        if self._native is not None:
            if self._snapshot is None:
                self._snapshot = self._native.export_graph()
            return self._snapshot
        return self._graph

    def orient_and_add_read(self, read: np.ndarray, min_score_to_add: float = 0.0) -> int:
        """Try both orientations, commit the better one if it clears the
        score bar; returns the read key or -1
        (reference SparsePoa.cpp:96-137)."""
        if self._native is not None:
            res = self._native.orient_add(read, min_score_to_add)
            self._snapshot = None
            if res is None:
                return -1
            path, rc = res
            self.read_paths.append(path)
            self.reverse_complemented.append(rc)
            return len(self.read_paths) - 1

        if self._graph.n_reads == 0:
            path = self._graph.add_first_read(read)
            self.read_paths.append(path)
            self.reverse_complemented.append(False)
            return 0
        ranges_fwd = ranges_rev = None
        g = self._graph
        order = g.topo_order()
        if banding_enabled():
            # the reference computes SDP ranges against the graph's current
            # consensus each TryAddRead (PoaGraphImpl.cpp:394-401)
            css_path = g.consensus_path(0)
            # the min_cov=0 scores consensus_path just cached are
            # banding-internal; do not let them masquerade as a
            # caller-requested consensus
            del g.vertex_score
            css = np.asarray([g.base[v] for v in css_path], np.int8)
            rc = revcomp(read)
            k = anchor_k(len(css), len(read))
            chain_f = anchor_chain(find_seeds(css, read, k, max_occ=_MAX_OCC))
            chain_r = anchor_chain(find_seeds(css, rc, k, max_occ=_MAX_OCC))
            # Orientation triage by chain density: the wrong strand chains
            # only a few spurious anchors, so a much thinner chain means
            # that orientation is (almost surely) wrong -- give it a
            # minimal one-row band (scores ~0, loses the orientation
            # contest) instead of a wide garbage band or a full O(V*I)
            # fill.  Comparable chains (palindromic inserts) band both.
            minimal = np.zeros((len(g.base), 2), np.int64)
            minimal[:, 1] = 1
            if len(chain_f) >= 2 and len(chain_f) >= 4 * len(chain_r):
                ranges_fwd = sdp_vertex_ranges(len(g.base), order, g.preds,
                                               g.succs, css_path, chain_f,
                                               len(read))
                ranges_rev = minimal
            elif len(chain_r) >= 2 and len(chain_r) >= 4 * len(chain_f):
                ranges_rev = sdp_vertex_ranges(len(g.base), order, g.preds,
                                               g.succs, css_path, chain_r,
                                               len(rc))
                ranges_fwd = minimal
            else:
                ranges_fwd = sdp_vertex_ranges(len(g.base), order, g.preds,
                                               g.succs, css_path, chain_f,
                                               len(read))
                ranges_rev = sdp_vertex_ranges(len(g.base), order, g.preds,
                                               g.succs, css_path, chain_r,
                                               len(rc))
        fwd = self._graph.try_add_read(read, False, ranges=ranges_fwd,
                                       order=order)
        rev = self._graph.try_add_read(revcomp(read), True, ranges=ranges_rev,
                                       order=order)
        plan = fwd if fwd.score >= rev.score else rev
        if plan.score < min_score_to_add:
            return -1
        path = self._graph.commit_add(plan)
        self.read_paths.append(path)
        self.reverse_complemented.append(plan.reverse_complemented)
        return len(self.read_paths) - 1

    def find_consensus(self, min_coverage: int):
        """Returns (consensus codes, per-read PoaAlignmentSummary list)
        (reference SparsePoa.cpp:139-199)."""
        if self._native is not None:
            path = self._native.consensus_path(min_coverage)
            self._snapshot = None  # consensus (re)computes vertex scores
            css = self._native.bases()[np.asarray(path, np.int64)] \
                if path else np.zeros(0, np.int8)
        else:
            path = self._graph.consensus_path(min_coverage)
            css = np.asarray([self._graph.base[v] for v in path], np.int8)
        self.last_consensus_path = path
        css_position = {v: i for i, v in enumerate(path)}

        summaries = []
        for key, read_path in enumerate(self.read_paths):
            read_s = read_e = css_s = css_e = 0
            found = False
            for read_pos, v in enumerate(read_path):
                if v in css_position:
                    if not found:
                        css_s = css_position[v]
                        read_s = read_pos
                        found = True
                    css_e = css_position[v] + 1
                    read_e = read_pos + 1
            summaries.append(PoaAlignmentSummary(
                reverse_complemented=self.reverse_complemented[key],
                extent_on_read=(read_s, read_e),
                extent_on_consensus=(css_s, css_e)))
        return css, summaries
