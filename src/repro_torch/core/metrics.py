"""Evaluation metrics (paper §IV-D), streaming record summaries, and the
incremental (bounded-memory) aggregation used by year-scale replays.

Two aggregation paths produce the same :class:`Metrics` schema:

* :func:`collect` — post-hoc over ``sim.records`` (the legacy path;
  requires every JobRecord retained);
* :class:`StreamingMetrics` — a record *sink* (see
  ``Simulator(record_sink=...)``): means via Welford accumulators and
  quantiles via P² sketches, O(1) state per metric regardless of trace
  length.  Means are float-accurate to accumulation order; the
  P² quantiles are approximate (see docs/performance.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import numpy as np

from .job import JobType
from .simulator import JobRecord, Simulator


@dataclass
class Metrics:
    avg_turnaround_h: float
    avg_turnaround_rigid_h: float
    avg_turnaround_malleable_h: float
    avg_turnaround_od_h: float
    system_utilization: float
    od_instant_start_rate: float
    preemption_ratio_rigid: float
    preemption_ratio_malleable: float
    shrink_ratio_malleable: float
    n_completed: int
    n_jobs: int
    decision_p99_ms: Optional[float] = None
    # Mean bounded slowdown (BSLD, Feitelson): max(1, turnaround /
    # max(t_actual, 10s)).  Keyword-defaulted so checkpoints and golden
    # rows written before the field existed still round-trip.
    avg_bounded_slowdown: Optional[float] = None
    # Fault-axis columns (repro_torch.faults): populated only when a fault
    # model is active, None (and dropped from as_dict) on a perfect
    # machine, so golden rows written before the axis existed — and
    # every faults="none" run — keep an unchanged schema.
    n_node_failures: Optional[int] = None        # node_down events applied
    n_interruptions: Optional[int] = None        # running jobs hit
    lost_work_node_h: Optional[float] = None     # work+setup lost to faults
    goodput: Optional[float] = None              # useful / up-capacity integral

    def as_dict(self) -> Dict[str, float]:
        return {k: v for k, v in self.__dict__.items() if v is not None}


def _avg_turnaround(recs: List[JobRecord]) -> float:
    ts = [r.turnaround for r in recs if r.turnaround is not None]
    return float(np.mean(ts)) / 3600.0 if ts else float("nan")


def bounded_slowdown(turnaround: float, t_actual: float,
                     tau: float = 10.0) -> float:
    """BSLD for one job: max(1, turnaround / max(t_actual, tau))."""
    return max(1.0, turnaround / max(t_actual, tau))


def _fault_metrics(sim: Simulator, completed_work: float) -> Dict[str, float]:
    """Fault-axis Metrics kwargs; empty (fields stay None) on a perfect
    machine.  Goodput is the node-seconds of *work that completed* over
    the up-capacity integral ∫(total - down - draining)dt — the fraction
    of the machine that actually existed which produced finished results.
    (The legacy ``occupied - waste`` utilization proxy is kept unchanged
    but can go negative under heavy restart thrash, because every
    preemption pre-charges a restart setup that a later fault may kill
    mid-setup; see docs/faults.md.)  The denominator is snapshotted at
    the last job completion, so trailing fault events beyond the
    workload's span do not dilute it."""
    if getattr(sim, "fault_model_name", "none") == "none":
        return {}
    denom = sim.avail_at_completion or sim.avail_integral
    return {
        "n_node_failures": sim.fault_downs,
        "n_interruptions": sim.n_interruptions,
        "lost_work_node_h": sim.fault_lost_node_s / 3600.0,
        "goodput": (completed_work / denom if denom > 0 else float("nan")),
    }


def records_sha256(records: Mapping[int, JobRecord]) -> str:
    """Job-for-job digest over the deterministic per-record outcome
    fields — the repeatability gate for fault-enabled cells (same
    mechanism, scenario, seed, and fault spec must reproduce it)."""
    import hashlib
    import json
    h = hashlib.sha256()
    for jid in sorted(records):
        r = records[jid]
        h.update(json.dumps(
            [jid, r.job.jtype.value, r.first_start, r.completion,
             r.killed, r.n_preempted, r.n_shrunk, r.instant]).encode())
    return h.hexdigest()


def summarize_records(records: Mapping[int, JobRecord],
                      max_records: int = 256) -> dict:
    """Down-sampled per-run record summary for streaming sweeps.

    Month-scale runs produce tens of thousands of JobRecords; shipping
    them through the process-pool pipe (and holding them per finished
    run) defeats streaming aggregation.  This keeps the distribution —
    turnaround/wait percentiles over *all* records — plus an evenly
    strided sample of at most ``max_records`` compact per-job tuples
    ``(jid, jtype, turnaround_s, n_preempted, n_shrunk)`` for record-
    level inspection.
    """
    recs = list(records.values())
    turns = np.asarray([r.turnaround for r in recs
                        if r.turnaround is not None], dtype=np.float64)
    waits = np.asarray([r.first_start - r.job.submit_time for r in recs
                        if r.first_start is not None], dtype=np.float64)

    def _pcts(a: np.ndarray) -> dict:
        if a.size == 0:
            return {"p50": float("nan"), "p90": float("nan"),
                    "p99": float("nan")}
        p50, p90, p99 = np.percentile(a, (50, 90, 99))
        return {"p50": float(p50), "p90": float(p90), "p99": float(p99)}

    stride = max(1, -(-len(recs) // max_records)) if max_records > 0 else 1
    sample = [(r.job.jid, r.job.jtype.value,
               None if r.turnaround is None else round(r.turnaround, 3),
               r.n_preempted, r.n_shrunk)
              for r in recs[::stride]] if max_records > 0 else []
    return {"n_records": len(recs),
            "sample_stride": stride,
            "turnaround_s": _pcts(turns),
            "wait_s": _pcts(waits),
            "sample": sample}


# ---------------------------------------------------- incremental primitives
# Welford and P2Quantile live in repro_torch.core.sketches (the simulator holds
# a sketch for its streaming decision-latency p99, and metrics imports the
# simulator — the sketches must sit below both); re-exported here so
# existing ``from repro_torch.core.metrics import P2Quantile`` imports keep
# working.
from .sketches import P2Quantile, Welford  # noqa: E402,F401


def decision_p99_ms(sim: Simulator) -> Optional[float]:
    """p99 of the tracked decision latencies, in ms, or None when none
    were recorded.  Reads whichever representation the simulator kept:
    the exact materialized list (np.percentile, the legacy output), or —
    on streaming/``record_sink`` runs, where the list would grow without
    bound — the O(1) P² sketch (approximate; the p99 is the only
    quantile ever consumed from it)."""
    sketch = getattr(sim, "_decision_sketch", None)
    if sketch is not None:
        return float(sketch.result() * 1e3) if sketch.count else None
    if sim.decision_times:
        return float(np.percentile(np.array(sim.decision_times) * 1e3, 99))
    return None


class StreamingMetrics:
    """Incremental :class:`Metrics` aggregation — the record sink for
    ``Simulator(record_sink=...)``.

    Call it with each retired :class:`JobRecord`; after ``sim.run()``,
    :meth:`result` returns the same Metrics schema :func:`collect`
    produces (means bit-comparable up to accumulation order, quantile
    summaries approximate), and :meth:`summary` the percentile summary
    ``summarize_records`` would have built — all in O(1) memory.

    ``instant_eps`` mirrors ``SimConfig.instant_eps`` (the sink cannot
    re-derive it from retired records).
    """

    def __init__(self, instant_eps: float = 1.0):
        self.instant_eps = instant_eps
        self.turn = {t: Welford() for t in JobType}
        self.turn_all = Welford()
        self.bsld = Welford()
        self.seen = {t: 0 for t in JobType}
        self.completed = 0
        self.completed_work = 0.0   # node-seconds of finished (unkilled) work
        self.od_instant = 0
        self.preempted = {t: 0 for t in JobType}
        self.shrunk_malleable = 0
        self.first_submit = float("inf")
        self.turn_q = {p: P2Quantile(p) for p in (0.50, 0.90, 0.99)}
        self.wait_q = {p: P2Quantile(p) for p in (0.50, 0.90, 0.99)}

    @property
    def n_records(self) -> int:
        return sum(self.seen.values())

    def __call__(self, rec: JobRecord) -> None:
        job = rec.job
        self.seen[job.jtype] += 1
        self.first_submit = min(self.first_submit, job.submit_time)
        if rec.completion is not None:
            self.completed += 1
            if not rec.killed:
                self.completed_work += job.work
        t = rec.turnaround
        if t is not None:
            self.turn[job.jtype].add(t)
            self.turn_all.add(t)
            self.bsld.add(bounded_slowdown(t, job.t_actual))
            for q in self.turn_q.values():
                q.add(t)
        if rec.first_start is not None:
            wait = rec.first_start - job.submit_time
            for q in self.wait_q.values():
                q.add(wait)
            if job.jtype is JobType.ONDEMAND and wait <= self.instant_eps:
                self.od_instant += 1
        if rec.n_preempted > 0:
            self.preempted[job.jtype] += 1
        if job.jtype is JobType.MALLEABLE and rec.n_shrunk > 0:
            self.shrunk_malleable += 1

    @staticmethod
    def _ratio(num: int, den: int) -> float:
        return num / den if den else float("nan")

    def result(self, sim: Simulator) -> Metrics:
        """Finalize against the finished simulator (utilization needs its
        node-seconds integrals; decision times live there too)."""
        dec = decision_p99_ms(sim)
        n = self.n_records
        if n == 0:
            nan = float("nan")
            return Metrics(nan, nan, nan, nan, nan, nan, nan, nan, nan,
                           n_completed=0, n_jobs=0, decision_p99_ms=dec)
        horizon = sim.finish_time() - self.first_submit
        useful = sim.occupied_integral - sim.waste_node_seconds
        util = useful / (sim.cfg.n_nodes * horizon) if horizon > 0 \
            else float("nan")
        return Metrics(
            avg_turnaround_h=self.turn_all.result() / 3600.0,
            avg_turnaround_rigid_h=self.turn[JobType.RIGID].result() / 3600.0,
            avg_turnaround_malleable_h=(
                self.turn[JobType.MALLEABLE].result() / 3600.0),
            avg_turnaround_od_h=self.turn[JobType.ONDEMAND].result() / 3600.0,
            system_utilization=util,
            od_instant_start_rate=self._ratio(self.od_instant,
                                              self.seen[JobType.ONDEMAND]),
            preemption_ratio_rigid=self._ratio(
                self.preempted[JobType.RIGID], self.seen[JobType.RIGID]),
            preemption_ratio_malleable=self._ratio(
                self.preempted[JobType.MALLEABLE],
                self.seen[JobType.MALLEABLE]),
            shrink_ratio_malleable=self._ratio(
                self.shrunk_malleable, self.seen[JobType.MALLEABLE]),
            n_completed=self.completed,
            n_jobs=n,
            decision_p99_ms=dec,
            avg_bounded_slowdown=self.bsld.result(),
            **_fault_metrics(sim, self.completed_work),
        )

    def summary(self) -> dict:
        """The shape of :func:`summarize_records` with sketch-backed
        percentiles and no per-job sample (those records are gone)."""
        def _pcts(qs: Dict[float, P2Quantile]) -> dict:
            return {f"p{round(p * 100)}": qs[p].result() for p in qs}
        return {"n_records": self.n_records, "sample_stride": 0,
                "turnaround_s": _pcts(self.turn_q),
                "wait_s": _pcts(self.wait_q),
                "sample": [], "approximate_quantiles": True}


def collect(sim: Simulator) -> Metrics:
    recs = list(sim.records.values())
    if not recs:
        # an empty trace (e.g. an over-filtered scenario) has no horizon:
        # every averaged metric is NaN rather than a min()-over-empty crash
        nan = float("nan")
        return Metrics(nan, nan, nan, nan, nan, nan, nan, nan, nan,
                       n_completed=0, n_jobs=0,
                       decision_p99_ms=decision_p99_ms(sim))
    by_type = {t: [r for r in recs if r.job.jtype is t] for t in JobType}
    od = by_type[JobType.ONDEMAND]
    rigid = by_type[JobType.RIGID]
    mall = by_type[JobType.MALLEABLE]

    horizon = sim.finish_time() - min(r.job.submit_time for r in recs)
    useful = sim.occupied_integral - sim.waste_node_seconds
    util = useful / (sim.cfg.n_nodes * horizon) if horizon > 0 else float("nan")

    def _instant(r: JobRecord) -> bool:
        if r.first_start is None:
            return False
        return (r.first_start - r.job.submit_time) <= sim.cfg.instant_eps

    dec = decision_p99_ms(sim)
    return Metrics(
        avg_turnaround_h=_avg_turnaround(recs),
        avg_turnaround_rigid_h=_avg_turnaround(rigid),
        avg_turnaround_malleable_h=_avg_turnaround(mall),
        avg_turnaround_od_h=_avg_turnaround(od),
        system_utilization=util,
        od_instant_start_rate=(float(np.mean([_instant(r) for r in od]))
                               if od else float("nan")),
        preemption_ratio_rigid=(float(np.mean([r.n_preempted > 0 for r in rigid]))
                                if rigid else float("nan")),
        preemption_ratio_malleable=(float(np.mean([r.n_preempted > 0 for r in mall]))
                                    if mall else float("nan")),
        shrink_ratio_malleable=(float(np.mean([r.n_shrunk > 0 for r in mall]))
                                if mall else float("nan")),
        n_completed=sum(r.completion is not None for r in recs),
        n_jobs=len(recs),
        decision_p99_ms=dec,
        avg_bounded_slowdown=(
            float(np.mean([bounded_slowdown(r.turnaround, r.job.t_actual)
                           for r in recs if r.turnaround is not None]))
            if any(r.turnaround is not None for r in recs) else float("nan")),
        **_fault_metrics(sim, sum(
            r.job.work for r in recs
            if r.completion is not None and not r.killed)),
    )
