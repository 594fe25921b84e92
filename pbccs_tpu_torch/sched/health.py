"""Fleet-health and sticky-routing helpers (port of pbccs_tpu.sched.health).

Two pieces the device pool routes and benches with, kept apart from
pool.py so the serve tier's router can share them once it is ported:

  * ``StickyMap`` -- the bucket-key -> home-member affinity map behind
    sticky routing (an idle home always wins; a busy home loses to the
    least-loaded healthy member, which then becomes an additional home).
    DevicePool routes polish-shape buckets to devices with it.
  * ``HealthTracker`` -- consecutive-failure strike counting with
    benching and success-driven re-admission, for members whose health
    is PROBED (a recovered member must re-admit; a benched device never
    comes back).  DevicePool's strikes are interwoven with its requeue
    transaction and stay in pool.py.

Both classes are lock-free on purpose: the owner already serializes
routing decisions under its own lock, and a second lock here would only
create ordering hazards.  Pure Python, a copy of pbccs_tpu's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Sequence, TypeVar

M = TypeVar("M")

# routing outcomes (metric label values shared by pool and router)
ROUTE_HOME = "home"
ROUTE_SPILL = "spill"
ROUTE_NEW = "new"


class StickyMap:
    """Bucket-key -> home-member affinity for sticky routing.

    Members are referenced by a hashable id (worker index, replica
    name); the caller supplies the live member objects plus ``load`` /
    ``depth`` accessors at route time, so the map itself never holds a
    stale member reference.  NOT thread-safe: callers route under their
    own scheduler lock.
    """

    def __init__(self) -> None:
        self._homes: dict[Hashable, set[Hashable]] = {}

    def note(self, key: Hashable, member_id: Hashable) -> None:
        """Record that `key` ran on `member_id` (it becomes a home)."""
        self._homes.setdefault(key, set()).add(member_id)

    def forget_member(self, member_id: Hashable) -> None:
        """Drop a member from every home set (benched / left the fleet):
        nothing should stick to a member that cannot take work."""
        for homes in self._homes.values():
            homes.discard(member_id)

    def homes(self, key: Hashable) -> set[Hashable]:
        return set(self._homes.get(key, ()))

    def resident_count(self, member_id: Hashable) -> int:
        """How many distinct bucket keys call this member home (the
        routing tie-break prefers members with fewer resident buckets,
        spreading the compiled-program menu across the fleet)."""
        return sum(1 for homes in self._homes.values()
                   if member_id in homes)

    def route(self, key: Hashable, members: Sequence[M], *,
              member_id: Callable[[M], Hashable],
              load: Callable[[M], tuple],
              depth: Callable[[M], int],
              spill_depth: int = 0) -> tuple[M, str]:
        """Pick a member for `key` among `members` (already filtered to
        healthy + eligible).  Returns (member, outcome) with outcome in
        home|spill|new; the caller records the route via note() once the
        work is actually enqueued (so a raced rejection never mints a
        phantom home).

        `load` is the least-loaded total order (ties broken inside it);
        `depth` is the queued+running count the spill threshold compares
        against."""
        if not members:
            raise ValueError("route() needs at least one member")
        home_set = self._homes.get(key, ())
        homes = [m for m in members if member_id(m) in home_set]
        if homes:
            best = min(homes, key=load)
            if depth(best) <= spill_depth:
                return best, ROUTE_HOME
            # a busy home can still be the least-loaded member on a
            # saturated fleet -- that route is home, not spill
            target = min(members, key=load)
            return target, (ROUTE_HOME if member_id(target) in home_set
                            else ROUTE_SPILL)
        return min(members, key=load), ROUTE_NEW


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Strike/re-admission knobs for probed members."""

    # consecutive failures before a member is marked unhealthy
    bench_after: int = 2
    # consecutive probe successes an UNHEALTHY member needs before
    # re-admission (1 = first good probe readmits; >1 damps flapping)
    readmit_after: int = 1

    def __post_init__(self):
        if self.bench_after < 1:
            raise ValueError("bench_after must be >= 1")
        if self.readmit_after < 1:
            raise ValueError("readmit_after must be >= 1")


class _MemberHealth:
    __slots__ = ("healthy", "strikes", "successes", "failures_total",
                 "benched_total")

    def __init__(self) -> None:
        self.healthy = True
        self.strikes = 0          # consecutive failures while healthy
        self.successes = 0        # consecutive successes while unhealthy
        self.failures_total = 0
        self.benched_total = 0


class HealthTracker:
    """Consecutive-failure benching with probe-driven re-admission.

    record_failure()/record_success() return True exactly on the
    transition (became unhealthy / recovered), so the caller can count
    metrics and run its requeue sweep once per transition instead of
    once per probe.  NOT thread-safe (see module docstring).
    """

    def __init__(self, policy: HealthPolicy | None = None) -> None:
        self.policy = policy or HealthPolicy()
        self._members: dict[Hashable, _MemberHealth] = {}

    def _member(self, member_id: Hashable) -> _MemberHealth:
        m = self._members.get(member_id)
        if m is None:
            m = self._members[member_id] = _MemberHealth()
        return m

    def healthy(self, member_id: Hashable) -> bool:
        return self._member(member_id).healthy

    def forget(self, member_id: Hashable) -> None:
        """Drop a member's health state entirely (it left the fleet);
        a future member reusing the name starts healthy, no strikes."""
        self._members.pop(member_id, None)

    def record_failure(self, member_id: Hashable) -> bool:
        """One failed probe/dispatch; True when this strike benched the
        member (the caller fails over its in-flight work ONCE)."""
        m = self._member(member_id)
        m.failures_total += 1
        m.successes = 0
        if not m.healthy:
            return False
        m.strikes += 1
        if m.strikes >= self.policy.bench_after:
            m.healthy = False
            m.benched_total += 1
            m.strikes = 0
            return True
        return False

    def record_success(self, member_id: Hashable) -> bool:
        """One successful probe/dispatch; True when it re-admitted a
        previously-unhealthy member (flapping members re-enter only
        after readmit_after consecutive good probes)."""
        m = self._member(member_id)
        m.strikes = 0
        if m.healthy:
            return False
        m.successes += 1
        if m.successes >= self.policy.readmit_after:
            m.healthy = True
            m.successes = 0
            return True
        return False

    def snapshot(self, member_id: Hashable) -> dict:
        m = self._member(member_id)
        return {"healthy": m.healthy, "strikes": m.strikes,
                "failures": m.failures_total,
                "benched_times": m.benched_total}
