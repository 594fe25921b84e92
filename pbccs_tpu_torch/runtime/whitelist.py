"""ZMW whitelist: parse `--zmws` selection specs and answer membership.

Spec grammar (parity: reference include/pacbio/ccs/Whitelist.h:52-130):
  all | *:*                      every ZMW of every movie
  <ranges>                       global ZMW ranges, e.g. "1-3,5"
  *:<ranges>                     same
  <movie>:<ranges>               ranges scoped to one movie
  <movie>:*                      every ZMW of one movie
  spec;spec;...                  union over movies (each movie at most once,
                                 no mixing global with per-movie)

Copy of pbccs_tpu.runtime.whitelist.
"""

from __future__ import annotations

from pbccs_tpu_torch.utils.intervals import IntervalTree


class Whitelist:
    def __init__(self, spec: str):
        self._all = False
        self._global: IntervalTree | None = None
        self._movies: dict[str, IntervalTree | None] = {}

        if spec in ("all", "*:*"):
            self._all = True
            return

        for mspec in spec.split(";"):
            if mspec in ("all", "*:*") or self._global is not None:
                raise ValueError("invalid whitelist specification")
            parts = mspec.split(":")
            if len(parts) == 1:
                if not self._movies:
                    self._global = IntervalTree.from_string(parts[0])
                    continue
            elif len(parts) == 2 and parts[0] == "*":
                if not self._movies:
                    self._global = IntervalTree.from_string(parts[1])
                    continue
            elif len(parts) == 2 and parts[0] not in self._movies:
                self._movies[parts[0]] = (
                    None if parts[1] == "*" else IntervalTree.from_string(parts[1]))
                continue
            raise ValueError("invalid whitelist specification")

    def contains(self, movie_name: str, hole_number: int) -> bool:
        if self._all:
            return True
        if self._global is not None:
            return self._global.contains(hole_number)
        if movie_name in self._movies:
            tree = self._movies[movie_name]
            return tree is None or tree.contains(hole_number)
        return False
