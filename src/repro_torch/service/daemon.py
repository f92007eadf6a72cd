"""The scheduler service daemon: replay-paced and live event loops.

:class:`SchedulerService` wires the pieces together — a
:class:`~repro_torch.service.core.ServiceCore` (the narrating simulator), a
:class:`~repro_torch.service.clock.ReplayClock` (wall→sim pacing), a
:class:`~repro_torch.service.decisionlog.DecisionLog` (JSONL + fidelity
digest), an :class:`~repro_torch.service.slo.SloMonitor` (gates), and a
:class:`~repro_torch.service.launchers.Launcher` (execution backend).

Two loops share the core:

* :meth:`SchedulerService.run_replay` — shadow mode.  A trace or
  Scenario's jobs arrive as live traffic at ``speed`` sim-seconds per
  wall-second (``inf`` = as fast as decisions can be made, the CI
  mode).  Each iteration sleeps until the next event's sim time, steps
  the core through exactly that event batch under a perf_counter, and
  appends the drained decisions with the batch latency attached.
* :meth:`SchedulerService.run_live` — jobs arrive through an
  :class:`~repro_torch.service.admission.AdmissionQueue` instead of a trace;
  the loop polls admissions between batches and exits when the queue
  is closed and the core drains.

The pacing loop passes ``step_until`` a non-decreasing sequence of
limits, which the simulator guarantees processes the exact event
sequence one offline ``run()`` would — see docs/service.md for why that
makes shadow fidelity hold by construction rather than by testing luck.

Batch scheduling rounds (``SimConfig.batch_rounds``, via
``ServiceConfig.sim_overrides``) need no daemon changes:
``Simulator.next_event_time`` reports a pending deferred pass's round
boundary as the next event, so both loops sleep to round boundaries and
each ``step_until(next_event_time())`` call runs the deferred pass at
exactly its boundary.  Shadow fidelity still holds by construction —
the offline comparison run shares the same ``batch_rounds``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.job import JobSpec
from repro_torch.core.simulator import JobRecord, SimConfig, Simulator

from .admission import AdmissionQueue
from .clock import ReplayClock
from .core import ServiceCore
from .decisionlog import (DIGEST_EXEMPT_EVENTS, DecisionLog, decision_digest)
from .launchers import (DryrunLauncher, Launcher, NullLauncher,
                        RetryingLauncher)
from .slo import SloMonitor, SloPolicy


@dataclass
class ServiceConfig:
    """Service-level knobs; simulator mechanics ride in ``sim_overrides``."""

    n_nodes: int
    mechanism: str = "CUA&SPAA"
    queue_policy: str = "EASY"
    #: sim-seconds per wall-second; ``inf`` never sleeps (CI/benchmarks)
    speed: float = math.inf
    decision_log_path: Optional[str] = None
    keep_log_rows: bool = True
    #: rotate the decision log to ``<path>.<n>`` past this size (None = never)
    log_rotate_bytes: Optional[int] = None
    #: pull a node from service when a launch action fails persistently
    quarantine_on_launch_failure: bool = True
    slo: SloPolicy = field(default_factory=SloPolicy)
    sim_overrides: Dict[str, object] = field(default_factory=dict)

    def sim_config(self) -> SimConfig:
        return SimConfig(n_nodes=self.n_nodes, mechanism=self.mechanism,
                         queue_policy=self.queue_policy, **self.sim_overrides)


@dataclass
class ShadowReport:
    """What one service run produced, shaped for CI artifacts."""

    ok: bool                      # every SLO held
    digest: str                   # fidelity fingerprint of the decision log
    n_decisions: int
    n_jobs: int
    finish_time: float            # sim time of the last completion
    wall_s: float                 # wall clock the replay took
    latency: Dict[str, float]     # decision-latency summary (ms)
    slo: Dict                     # SloReport.as_dict()
    launcher_counts: Optional[Dict[str, int]] = None
    admission_counts: Optional[Dict[str, int]] = None   # live mode only

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class SchedulerService:
    """One service instance = one core + one decision log + one launcher.

    Without a ``record_sink`` the core retains every JobRecord (tests
    and fidelity checks read them back); with one, records retire
    streamingly through the monitor into the sink and the service holds
    O(active) state — the year-scale replay posture.
    """

    def __init__(self, cfg: ServiceConfig, jobs: Iterable[JobSpec] = (),
                 launcher: Optional[Launcher] = None,
                 record_sink: Optional[Callable[[JobRecord], None]] = None):
        self.cfg = cfg
        self.launcher = launcher or NullLauncher()
        self.monitor = SloMonitor(cfg.slo)
        self._streaming = record_sink is not None
        sink = None
        if record_sink is not None:
            def sink(rec, _user=record_sink):
                self.monitor.add_record(rec)
                _user(rec)
        jobs = jobs if not isinstance(jobs, tuple) else list(jobs)
        self.core = ServiceCore(cfg.sim_config(), jobs,
                                launcher=self.launcher, record_sink=sink)
        self.log = DecisionLog(cfg.decision_log_path,
                               keep_rows=cfg.keep_log_rows,
                               rotate_bytes=cfg.log_rotate_bytes)
        if isinstance(self.launcher, RetryingLauncher) and \
                self.launcher.on_give_up is None:
            self.launcher.on_give_up = self._on_launch_failed
        self.clock: Optional[ReplayClock] = None
        self._admission: Optional[AdmissionQueue] = None
        self.wall_s = 0.0

    def _on_launch_failed(self, action: str, subject, exc: Exception) -> None:
        """A backend action failed persistently (RetryingLauncher gave
        up).  Record it as a runtime row — ``seq=-1``, digest-exempt, so
        the fidelity fingerprint is untouched — and optionally pull a
        node out of service on the theory that repeated launch failures
        mean bad hardware."""
        jid = getattr(subject, "jid",
                      getattr(getattr(subject, "job", None), "jid", -1))
        self.log.append({"seq": -1, "t_sim": round(self.core.now, 6),
                         "event": "launch_failed", "jid": jid,
                         "action": action, "error": str(exc)})
        if self.cfg.quarantine_on_launch_failure:
            self.core.quarantine(1)

    # ------------------------------------------------------------ event loop
    def _step_batch(self, t_next: float) -> None:
        """Process one event batch under the latency meter and log the
        decisions it produced (log I/O stays outside the meter: the SLO
        bounds scheduling latency, not disk flushes)."""
        t0 = time.perf_counter()
        self.core.step_until(t_next)
        lat_ms = (time.perf_counter() - t0) * 1e3
        self.monitor.add_decision_latency(lat_ms)
        for d in self.core.drain_decisions():
            self.log.append(d, latency_ms=lat_ms)
        self.launcher.tick()

    def _wind_down(self, t0_wall: float) -> ShadowReport:
        self.core.finalize()
        self.launcher.close()
        self.log.close()
        if not self._streaming:           # harvest od waits post-hoc
            for rec in self.core.records.values():
                self.monitor.add_record(rec)
        self.wall_s = time.monotonic() - t0_wall
        return self.report()

    def run_replay(self) -> ShadowReport:
        """Shadow mode: replay the constructor's jobs as live arrivals."""
        t0_wall = time.monotonic()
        first = self.core.next_event_time()
        self.clock = ReplayClock(self.cfg.speed,
                                 origin=first if first is not None else 0.0)
        while True:
            t_next = self.core.next_event_time()
            if t_next is None:
                break
            self.clock.sleep_until(t_next)
            self._step_batch(t_next)
        return self._wind_down(t0_wall)

    def run_live(self, admission: AdmissionQueue,
                 poll_s: float = 0.02) -> ShadowReport:
        """Live mode: drain an admission queue between event batches;
        returns once the queue is closed and the core has drained.  The
        core must have been built with ``jobs=[]`` (see
        ``ServiceCore.admit``)."""
        self._admission = admission
        t0_wall = time.monotonic()
        self.clock = ReplayClock(self.cfg.speed, origin=self.core.now)
        while True:
            for spec in admission.drain():
                self.core.admit(spec)
            t_next = self.core.next_event_time()
            if t_next is None:
                if admission.closed and not len(admission):
                    break
                time.sleep(poll_s)
                continue
            now_sim = self.clock.now_sim()
            if t_next <= now_sim:
                self._step_batch(t_next)
                continue
            # next event is in the (scaled) future: nap, but wake early
            # enough to notice new admissions
            time.sleep(min(poll_s, (t_next - now_sim) / self.cfg.speed))
        return self._wind_down(t0_wall)

    # --------------------------------------------------------------- results
    def report(self) -> ShadowReport:
        slo = self.monitor.report()
        counts = getattr(self.launcher, "counts", None)
        adm = self._admission
        return ShadowReport(
            ok=slo.ok, digest=self.log.digest,
            n_decisions=self.log.n_rows, n_jobs=self.core.n_ingested,
            finish_time=self.core.finish_time(),
            wall_s=round(self.wall_s, 3),
            latency=self.log.latency_summary(), slo=slo.as_dict(),
            launcher_counts=dict(counts) if counts is not None else None,
            admission_counts=dict(adm.counts) if adm is not None else None)

    # -------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, cfg: ServiceConfig, jobs: Iterable[JobSpec],
                launcher: Optional[Launcher] = None,
                record_sink: Optional[Callable[[JobRecord], None]] = None
                ) -> Tuple["SchedulerService", "RecoveryReport"]:
        """Resume a killed daemon from its on-disk decision log.

        Because the decision stream is a pure function of
        (trace, mechanism), recovery is deterministic replay: read every
        complete row from the (possibly rotated, possibly torn) log at
        ``cfg.decision_log_path``, build a fresh core over the same jobs,
        and step it until it has re-made exactly the logged decisions.
        The replayed prefix's digest must equal the logged prefix's —
        proof the recovered core stands in the crashed daemon's exact
        state — then any overshoot (decisions the crashed daemon made
        but never flushed... impossible, or ones the replay batch made
        past the last logged row) is appended, and the service continues
        with the recovered log open for append.  The returned service's
        eventual digest is identical to an uninterrupted run's.

        Limitation: replay assumes the crashed run's *decision-affecting*
        state came only from (trace, mechanism).  Runtime quarantines
        (``launch_failed`` rows) shrink the free pool, so runs that
        quarantined nodes cannot be byte-faithfully replayed — recovery
        then reports ``digests_match=False`` rather than guessing.
        """
        if not cfg.decision_log_path:
            raise ValueError("recover() needs cfg.decision_log_path")
        log, rows = DecisionLog.recover(cfg.decision_log_path,
                                        keep_rows=cfg.keep_log_rows,
                                        rotate_bytes=cfg.log_rotate_bytes)
        logged = [r for r in rows
                  if r.get("event") not in DIGEST_EXEMPT_EVENTS]
        k = len(logged)

        bare = replace(cfg, decision_log_path=None)
        svc = cls(bare, list(jobs), launcher=launcher,
                  record_sink=record_sink)
        svc.cfg = cfg
        svc.log.close()
        svc.log = log                 # appends continue the on-disk stream

        replayed: List[Dict] = []
        while svc.core.n_decisions < k:
            t_next = svc.core.next_event_time()
            if t_next is None:
                break                 # log claims more decisions than trace
            svc.core.step_until(t_next)
            replayed.extend(svc.core.drain_decisions())
        dec = [r for r in replayed
               if r.get("event") not in DIGEST_EXEMPT_EVENTS]
        runtime = [r for r in replayed
                   if r.get("event") in DIGEST_EXEMPT_EVENTS]
        prefix_digest = decision_digest(dec[:k])
        digests_match = prefix_digest == decision_digest(logged)
        for d in dec[k:] + runtime:   # decisions past the last flushed row
            log.append(d)
        report = RecoveryReport(
            ok=digests_match, digests_match=digests_match,
            n_log_rows=len(rows), n_decisions_recovered=k,
            n_overshoot=max(0, len(dec) - k),
            digest_prefix=prefix_digest, resumed_at=svc.core.now)
        return svc, report


@dataclass
class RecoveryReport:
    """What :meth:`SchedulerService.recover` reconstructed."""

    ok: bool                      # replayed prefix digest == logged digest
    digests_match: bool
    n_log_rows: int               # complete rows read back (incl. runtime)
    n_decisions_recovered: int    # decision rows the replay had to re-make
    n_overshoot: int              # extra decisions the final batch produced
    digest_prefix: str
    resumed_at: float             # sim time the recovered core stands at

    def as_dict(self) -> dict:
        return dict(self.__dict__)


# ------------------------------------------------------------------ fidelity
@dataclass
class FidelityReport:
    """Shadow-mode contract check: the paced service vs the offline
    simulator on the identical trace + mechanism."""

    ok: bool                      # digests match AND records match
    digests_match: bool
    records_match: bool
    digest_service: str
    digest_reference: str
    n_jobs: int
    mismatched_jids: List[int]
    service: ShadowReport

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["service"] = self.service.as_dict()
        return d


def shadow_fidelity(jobs: Iterable[JobSpec], cfg: ServiceConfig,
                    launcher: Optional[Launcher] = None) -> FidelityReport:
    """Run the paced shadow service AND the offline reference on the
    same jobs, then compare:

    1. decision digests — the service's paced ``step_until`` stream vs
       one offline ``run()`` of an identical narrating core;
    2. job records — first_start / completion / killed / preemption and
       shrink counts per jid against a *plain* Simulator (no service
       code in the loop at all).

    Both must match exactly; this is the gate benchmarks/run.py and CI
    enforce.  JobSpecs are shared across the three runs (the simulator
    never mutates specs after construction).
    """
    jobs = list(jobs)
    svc = SchedulerService(cfg, list(jobs),
                           launcher=launcher
                           if launcher is not None
                           else DryrunLauncher(cfg.n_nodes))
    rep = svc.run_replay()

    ref = ServiceCore(cfg.sim_config(), list(jobs), launcher=NullLauncher())
    ref.run()
    ref_digest = decision_digest(ref.drain_decisions())

    sim = Simulator(cfg.sim_config(), list(jobs))
    sim_records = sim.run()
    mismatched = []
    for jid, r in sim_records.items():
        s = svc.core.records.get(jid)
        if s is None or (s.first_start, s.completion, s.killed,
                         s.n_preempted, s.n_shrunk) != \
                (r.first_start, r.completion, r.killed,
                 r.n_preempted, r.n_shrunk):
            mismatched.append(jid)
    if len(svc.core.records) != len(sim_records):
        mismatched.append(-1)     # sentinel: record sets differ in size

    digests_match = rep.digest == ref_digest
    records_match = not mismatched
    return FidelityReport(ok=digests_match and records_match,
                          digests_match=digests_match,
                          records_match=records_match,
                          digest_service=rep.digest,
                          digest_reference=ref_digest,
                          n_jobs=len(jobs),
                          mismatched_jids=mismatched,
                          service=rep)
