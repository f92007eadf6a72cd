"""ServiceCore: the scheduler daemon's decision engine.

Fidelity by construction — ServiceCore IS the offline
:class:`repro_torch.core.Simulator`, subclassed to narrate.  It overrides the
simulator's placement primitives (`_begin_run`, `_preempt`, `_shrink`,
`_expand`, `_on_end`, `_on_od_timeout`) to emit one structured decision
row per action and forward it to a :class:`~repro_torch.service.launchers.
Launcher`; it adds no logic of its own, so the decision sequence a paced
replay produces (``step_until`` with the daemon's non-decreasing limits)
is bit-identical to what one offline ``run()`` on the same trace +
mechanism produces.  That identity, fingerprinted by
:func:`~repro_torch.service.decisionlog.decision_digest`, is the shadow-mode
contract (docs/service.md).

Launcher hooks fire *before* the superclass mutates state: a preempt/end
frees nodes that the same event may immediately hand to an expand, and a
validating launcher's mirror ledger must see the release first or it
would report a phantom over-commit.  (`finish` therefore receives the
record before ``completion`` is stamped — backends key on ``rec.job``.)
"""
from __future__ import annotations

import itertools
from dataclasses import replace
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.core.job import JobSpec, NoticeKind
from repro_torch.core.simulator import JobRecord, SimConfig, Simulator

from .launchers import Launcher, NullLauncher


class ServiceCore(Simulator):
    """A Simulator that narrates every placement decision.

    Decisions accumulate in ``self._pending`` until the daemon drains
    them (:meth:`drain_decisions`) into the decision log — the core
    never blocks on I/O inside an event handler, so decision latency
    measures scheduling, not logging.
    """

    def __init__(self, cfg: SimConfig, jobs: Iterable[JobSpec],
                 launcher: Optional[Launcher] = None,
                 record_sink: Optional[Callable[[JobRecord], None]] = None):
        # narration state must exist before super().__init__ ingests jobs
        self.launcher = launcher or NullLauncher()
        self._pending: List[Dict] = []
        self._dseq = itertools.count()
        self.n_decisions = 0
        self._pending_quarantine = 0
        self.n_quarantined = 0
        super().__init__(cfg, jobs, record_sink=record_sink)

    # ------------------------------------------------------------- narration
    def _emit(self, event: str, jid: int, **detail) -> None:
        row = {"seq": next(self._dseq), "t_sim": round(self.now, 6),
               "event": event, "jid": jid}
        row.update(detail)
        self._pending.append(row)
        self.n_decisions += 1

    def _emit_runtime(self, event: str, jid: int, **detail) -> None:
        """Emit a runtime observation row (``seq=-1``).  These record
        backend incidents, not scheduling decisions: they consume no
        decision seq and do not count toward ``n_decisions``, so the
        deterministic decision stream — and its digest — is identical
        with or without them (see DIGEST_EXEMPT_EVENTS)."""
        row = {"seq": -1, "t_sim": round(self.now, 6),
               "event": event, "jid": jid}
        row.update(detail)
        self._pending.append(row)

    def drain_decisions(self) -> List[Dict]:
        """Hand off (and clear) the decisions emitted since the last
        drain — the daemon appends them to the DecisionLog."""
        out, self._pending = self._pending, []
        return out

    # ----------------------------------------------------- live-mode ingress
    def admit(self, job: JobSpec) -> JobSpec:
        """Admit a job submitted to the *live* service (not replayed from
        a trace).  Times are clamped to the current clock so an admission
        racing the event loop can never submit in the past; returns the
        (possibly adjusted) spec actually ingested.  Only valid on the
        materialized path (live cores are built with ``jobs=[]``)."""
        if self._arrivals is not None:
            raise RuntimeError("admit() on a trace-replaying core; live "
                               "admission needs a core built with jobs=[]")
        if job.jid in self.jobs or job.jid in self.records:
            raise ValueError(f"duplicate admission of jid {job.jid}")
        fix = {}
        if job.submit_time < self.now:
            fix["submit_time"] = self.now
        if job.notice_kind is not NoticeKind.NONE:
            if job.notice_time is None or job.notice_time < self.now:
                fix["notice_time"] = self.now
            if job.est_arrival is None or \
                    job.est_arrival < fix.get("submit_time", job.submit_time):
                fix["est_arrival"] = fix.get("submit_time", job.submit_time)
        if fix:
            job = replace(job, **fix)
        self._ingest(job)
        self._emit("admit", job.jid, jtype=job.jtype.value,
                   submit_time=round(job.submit_time, 6), size=job.size)
        return job

    # ----------------------------------------------- narrated sim primitives
    def _begin_run(self, jid: int, size: int) -> None:
        job = self.jobs[jid]
        restart = jid in self.progress   # carry-over => restart after preempt
        self.launcher.start_job(job, size)
        self._emit("start", jid, size=size, jtype=job.jtype.value,
                   restart=restart)
        super()._begin_run(jid, size)

    def _preempt(self, jid: int, beneficiary: Optional[int] = None,
                 lost: int = 0) -> None:
        rs = self.running[jid]
        self.launcher.preempt(rs.job)
        if lost:
            self._emit("preempt", jid, size=rs.cur_size,
                       beneficiary=beneficiary, lost=lost)
        else:   # legacy detail shape — keeps fault-free digests unchanged
            self._emit("preempt", jid, size=rs.cur_size,
                       beneficiary=beneficiary)
        super()._preempt(jid, beneficiary=beneficiary, lost=lost)

    def _shrink(self, jid: int, k: int, od: int) -> None:
        rs = self.running[jid]
        new_size = rs.cur_size - k
        self.launcher.resize(rs.job, new_size)
        self._emit("shrink", jid, k=k, new_size=new_size, od=od)
        super()._shrink(jid, k, od)

    def _expand(self, jid: int, k: int) -> None:
        rs = self.running[jid]
        grow = min(k, rs.job.n_max - rs.cur_size)
        if grow > 0:
            self.launcher.resize(rs.job, rs.cur_size + grow)
            self._emit("expand", jid, k=grow, new_size=rs.cur_size + grow)
        super()._expand(jid, k)

    def _on_end(self, jid: int, epoch: int) -> None:
        rs = self.running.get(jid)
        if rs is not None and rs.epoch == epoch:   # not a stale END event
            killed = rs.work_done(self.now) < rs.job.work - 1e-6
            self.launcher.finish(self.records[jid])
            self._emit("end", jid, size=rs.cur_size, killed=killed,
                       jtype=rs.job.jtype.value)
        super()._on_end(jid, epoch)

    def _on_od_timeout(self, jid: int) -> None:
        fired = self.od_status.get(jid) == "noticed"
        released = self.ledger.reserved_of(jid) if fired else 0
        super()._on_od_timeout(jid)
        if fired:
            self._emit("od_timeout", jid, released=released)

    # ------------------------------------------------- narrated fault events
    def _on_node_down(self, node: int) -> None:
        if node not in self._down_nodes:   # mirror the super's dedup guard
            self._emit("node_down", -1, node=node)
        super()._on_node_down(node)

    def _on_node_up(self, node: int) -> None:
        if node in self._down_nodes:
            self._emit("node_up", -1, node=node)
        super()._on_node_up(node)

    def _fault_shrink(self, jid: int) -> None:
        rs = self.running[jid]
        new_size = rs.cur_size - 1
        self.launcher.resize(rs.job, new_size)
        self._emit("fault_shrink", jid, new_size=new_size)
        super()._fault_shrink(jid)

    def _fault_evict_od(self, jid: int) -> None:
        rs = self.running[jid]
        self.launcher.preempt(rs.job)
        self._emit("fault_evict", jid, size=rs.cur_size)
        super()._fault_evict_od(jid)

    # ------------------------------------------------------------ quarantine
    def quarantine(self, k: int = 1) -> None:
        """Request that ``k`` nodes be pulled from service (a persistent
        launch failure suggests bad hardware).  Nodes move free→draining
        lazily, at the next scheduling pass, and only while the free
        pool has them to give — the base Simulator's hot path is never
        touched, and a busy cluster drains as nodes free up."""
        self._pending_quarantine += k

    def _apply_pending_quarantine(self) -> None:
        while self._pending_quarantine > 0 and self.ledger.free > 0:
            self.ledger.drain_free()
            self._pending_quarantine -= 1
            self.n_quarantined += 1
            self._emit_runtime("quarantine", -1, draining=self.ledger.draining)

    def _schedule(self) -> None:
        if self._pending_quarantine:
            self._apply_pending_quarantine()
        super()._schedule()
