"""Half-open integer intervals + a self-merging interval set.

Parity: reference include/pacbio/ccs/Interval.h (FromString at :210-234) and
IntervalTree.h (self-merging multiset, :52-205).

Copy of pbccs_tpu.utils.intervals.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True, order=True)
class Interval:
    """[left, right) with right >= left."""

    left: int
    right: int

    def __post_init__(self):
        if self.left > self.right:
            raise ValueError(f"invalid interval [{self.left}, {self.right})")

    def __len__(self) -> int:
        return self.right - self.left

    def contains(self, x: int) -> bool:
        return self.left <= x < self.right

    def overlaps(self, other: "Interval") -> bool:
        return self.left < other.right and other.left < self.right

    def touches(self, other: "Interval") -> bool:
        """Overlapping or directly adjacent (mergeable)."""
        return self.left <= other.right and other.left <= self.right

    @staticmethod
    def from_string(s: str) -> "Interval":
        """"5" -> [5,6); "3-7" -> [3,8) (inclusive right in the spec)."""
        parts = s.split("-")
        try:
            if len(parts) == 1:
                left = int(parts[0])
                if left < 0:
                    raise ValueError
                return Interval(left, left + 1)
            if len(parts) == 2:
                left, right = int(parts[0]), int(parts[1])
                if 0 <= left <= right:
                    return Interval(left, right + 1)
        except ValueError:
            pass
        raise ValueError(f"invalid Interval specification: {s!r}")

    def __str__(self) -> str:
        if len(self) == 1:
            return str(self.left)
        return f"{self.left}-{self.right - 1}"


class IntervalTree:
    """Sorted set of disjoint intervals; inserts merge with neighbors."""

    def __init__(self, intervals: Iterable[Interval] = ()):
        self._ivals: list[Interval] = []
        self._lefts: list[int] = []
        for i in intervals:
            self.insert(i)

    def insert(self, interval: Interval) -> None:
        lo = bisect.bisect_left(self._lefts, interval.left)
        # absorb any neighbor that overlaps or touches
        start = lo
        while start > 0 and self._ivals[start - 1].touches(interval):
            start -= 1
        end = lo
        while end < len(self._ivals) and self._ivals[end].touches(interval):
            end += 1
        merged = interval
        for i in self._ivals[start:end]:
            merged = Interval(min(merged.left, i.left), max(merged.right, i.right))
        self._ivals[start:end] = [merged]
        self._lefts[start:end] = [merged.left]

    def contains(self, x: int) -> bool:
        idx = bisect.bisect_right(self._lefts, x) - 1
        return idx >= 0 and self._ivals[idx].contains(x)

    def gaps(self) -> "IntervalTree":
        """Intervals between stored intervals (reference IntervalTree::Gaps)."""
        out = IntervalTree()
        for a, b in zip(self._ivals, self._ivals[1:]):
            out.insert(Interval(a.right, b.left))
        return out

    def __iter__(self):
        return iter(self._ivals)

    def __len__(self) -> int:
        return len(self._ivals)

    @staticmethod
    def from_string(s: str) -> "IntervalTree":
        """Comma-separated interval specs: "1-3,5" (reference
        IntervalTree::FromString)."""
        tree = IntervalTree()
        for part in s.split(","):
            tree.insert(Interval.from_string(part))
        return tree
