"""Node accounting for the hybrid-workload cluster.

The ledger tracks six disjoint pools whose sizes always sum to N:

  free                 idle, unreserved
  od_reserved[od]      idle, reserved for a noticed on-demand job (CUA/CUP)
  job_hold[jid]        idle, returned-lease nodes held for a preempted job
  running occupancy    sum of cur_size over running jobs
  down                 failed, awaiting repair (fault injection, repro.faults)
  draining             quarantined by the service after persistent launch
                       failures; never scheduled until an operator undrains

Reserved nodes may be *borrowed* by backfilled jobs (paper §III-B1): the
borrowed count moves from od_reserved into running occupancy and is tracked
on the borrower so it can be preempted "immediately" at od arrival.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class NodeLedger:
    total: int
    free: int = -1
    od_reserved: Dict[int, int] = field(default_factory=dict)
    job_hold: Dict[int, int] = field(default_factory=dict)
    occupied: int = 0
    down: int = 0
    draining: int = 0

    def __post_init__(self) -> None:
        if self.free < 0:
            self.free = self.total

    # -- invariant ----------------------------------------------------------
    def check(self) -> None:
        s = (self.free + sum(self.od_reserved.values())
             + sum(self.job_hold.values()) + self.occupied
             + self.down + self.draining)
        assert s == self.total, (
            f"node leak: free={self.free} od_res={self.od_reserved} "
            f"hold={self.job_hold} occ={self.occupied} down={self.down} "
            f"draining={self.draining} != {self.total}")
        assert self.free >= 0
        assert self.down >= 0 and self.draining >= 0
        assert all(v >= 0 for v in self.od_reserved.values())
        assert all(v >= 0 for v in self.job_hold.values())

    @property
    def up(self) -> int:
        """Nodes currently part of the schedulable machine."""
        return self.total - self.down - self.draining

    # -- reservations ---------------------------------------------------------
    def reserve_from_free(self, od: int, want: int) -> int:
        """Move up to `want` free nodes into od's reservation."""
        k = min(want, self.free)
        if k > 0:
            self.free -= k
            self.od_reserved[od] = self.od_reserved.get(od, 0) + k
        return k

    def release_reservation(self, od: int) -> int:
        """Return od's idle reserved nodes to the free pool."""
        k = self.od_reserved.pop(od, 0)
        self.free += k
        return k

    def reserved_of(self, od: int) -> int:
        return self.od_reserved.get(od, 0)

    # -- job holds (returned leases for preempted jobs) ----------------------
    def add_hold(self, jid: int, k: int) -> None:
        if k > 0:
            self.job_hold[jid] = self.job_hold.get(jid, 0) + k

    def take_hold(self, jid: int) -> int:
        return self.job_hold.pop(jid, 0)

    def hold_of(self, jid: int) -> int:
        return self.job_hold.get(jid, 0)

    def hold_to_free(self, jid: int, k: int) -> None:
        """Move k of jid's held nodes into the free pool (the queue-head
        hold steal, paper deadlock resolution)."""
        have = self.job_hold[jid]
        assert 0 < k <= have
        if k == have:
            del self.job_hold[jid]
        else:
            self.job_hold[jid] = have - k
        self.free += k

    # -- allocation ----------------------------------------------------------
    def allocate(self, size: int, *, from_free: int = 0, od: int = None,
                 from_reserved: int = 0, from_hold: int = 0,
                 hold_jid: int = None) -> None:
        """Move nodes into running occupancy from the stated pools."""
        assert from_free + from_reserved + from_hold == size
        assert from_free <= self.free
        self.free -= from_free
        if from_reserved:
            assert od is not None and self.od_reserved.get(od, 0) >= from_reserved
            self.od_reserved[od] -= from_reserved
            if self.od_reserved[od] == 0:
                del self.od_reserved[od]
        if from_hold:
            assert hold_jid is not None
            have = self.job_hold.get(hold_jid, 0)
            assert have >= from_hold
            self.job_hold[hold_jid] = have - from_hold
            if self.job_hold[hold_jid] == 0:
                del self.job_hold[hold_jid]
        self.occupied += size

    def free_nodes(self, k: int) -> None:
        """Running job returns k nodes to the free pool."""
        assert k <= self.occupied
        self.occupied -= k
        self.free += k

    def occupied_to_reserved(self, od: int, k: int) -> None:
        """Nodes vacated by preemption/shrink go straight to od's reservation."""
        assert k <= self.occupied
        self.occupied -= k
        self.od_reserved[od] = self.od_reserved.get(od, 0) + k

    def occupied_to_hold(self, jid: int, k: int) -> None:
        assert k <= self.occupied
        self.occupied -= k
        self.add_hold(jid, k)

    # -- failure / repair / quarantine (repro.faults, service hardening) -----
    def fail_free(self) -> None:
        assert self.free > 0
        self.free -= 1
        self.down += 1

    def fail_reserved(self, od: int) -> None:
        have = self.od_reserved[od]
        assert have > 0
        if have == 1:
            del self.od_reserved[od]
        else:
            self.od_reserved[od] = have - 1
        self.down += 1

    def fail_hold(self, jid: int) -> None:
        have = self.job_hold[jid]
        assert have > 0
        if have == 1:
            del self.job_hold[jid]
        else:
            self.job_hold[jid] = have - 1
        self.down += 1

    def fail_occupied(self) -> None:
        assert self.occupied > 0
        self.occupied -= 1
        self.down += 1

    def repair(self) -> None:
        """A downed node comes back; it re-enters the free pool (the
        simulator routes it onward like any release)."""
        assert self.down > 0
        self.down -= 1
        self.free += 1

    def drain_free(self) -> None:
        """Quarantine one idle node (service launch-failure handling)."""
        assert self.free > 0
        self.free -= 1
        self.draining += 1

    def undrain(self) -> None:
        assert self.draining > 0
        self.draining -= 1
        self.free += 1


@dataclass
class Lease:
    """Nodes an on-demand job borrowed from a lender (paper §III-B3)."""

    lender: int
    nodes: int
    kind: str  # "preempt" | "shrink"


LeaseBook = Dict[int, List[Lease]]


def utilization_integral() -> Tuple[float, float]:  # pragma: no cover
    raise NotImplementedError("tracked by the simulator's metrics module")
