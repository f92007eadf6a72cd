"""SLO monitor: the production-shaped gates the shadow service must hold.

Two service-level objectives, both from the paper's goals:

* **decision latency** — p99 of the wall time a scheduling event batch
  takes, bounded by Obs-10's 10 ms (the decision path must stay
  interactive under heavy traffic);
* **on-demand wait** — p99 of (first_start - submit) for on-demand jobs,
  optional bound (the paper's "minimal waiting" goal; scenario-dependent,
  so unbounded by default).

The monitor aggregates streamingly (counts + bounded series) so it works
as a record sink on year-scale replays, and renders an :class:`SloReport`
whose ``ok`` is the CI gate.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.job import JobType
from repro_torch.core.simulator import JobRecord


def _p99(xs: List[float]) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), 99)) \
        if xs else float("nan")


@dataclass
class SloPolicy:
    """The bounds a service run is gated on."""

    decision_p99_ms: float = 10.0          # paper Obs 10
    od_wait_p99_s: Optional[float] = None  # None: report, don't gate


@dataclass
class SloReport:
    ok: bool
    decision_p99_ms: float
    decision_bound_ms: float
    od_wait_p99_s: float
    od_wait_bound_s: Optional[float]
    n_decisions: int
    n_od: int
    violations: List[str] = field(default_factory=list)

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class SloMonitor:
    """Accumulates decision latencies and per-record waits; ``report()``
    evaluates them against an :class:`SloPolicy`."""

    def __init__(self, policy: Optional[SloPolicy] = None):
        self.policy = policy or SloPolicy()
        self.decision_ms: List[float] = []
        self.od_wait_s: List[float] = []
        self.n_records = 0

    def add_decision_latency(self, ms: float) -> None:
        self.decision_ms.append(ms)

    def add_record(self, rec: JobRecord) -> None:
        """Record sink hook: harvest the on-demand wait as records retire
        (works streamingly; on-demand counts are machine-bounded)."""
        self.n_records += 1
        if rec.job.jtype is JobType.ONDEMAND and rec.first_start is not None:
            self.od_wait_s.append(rec.first_start - rec.job.submit_time)

    def report(self) -> SloReport:
        pol = self.policy
        dec_p99 = _p99(self.decision_ms)
        od_p99 = _p99(self.od_wait_s)
        violations = []
        if self.decision_ms and dec_p99 > pol.decision_p99_ms:
            violations.append(
                f"decision p99 {dec_p99:.3f}ms > {pol.decision_p99_ms}ms "
                "bound (paper Obs 10)")
        if pol.od_wait_p99_s is not None and self.od_wait_s \
                and od_p99 > pol.od_wait_p99_s:
            violations.append(
                f"on-demand wait p99 {od_p99:.1f}s > {pol.od_wait_p99_s}s")
        return SloReport(ok=not violations,
                         decision_p99_ms=dec_p99,
                         decision_bound_ms=pol.decision_p99_ms,
                         od_wait_p99_s=od_p99,
                         od_wait_bound_s=pol.od_wait_p99_s,
                         n_decisions=len(self.decision_ms),
                         n_od=len(self.od_wait_s),
                         violations=violations)
