"""Event-driven hybrid-workload scheduling simulator (CQSim-equivalent).

The simulator owns *mechanics* — the event heap, the node ledger, lease
bookkeeping, run/end lifecycle — and delegates every scheduling *decision*
to a :class:`~repro_torch.core.policy.PolicyBundle` resolved from
``SimConfig.mechanism``:

    notice      what to do at advance notice   (N / CUA / CUP, ...)
    arrival     node acquisition at od arrival (PAA / SPAA / STEAL / POOL, ...)
    queue       wait-queue order + backfill    (EASY / FCFS, ...)
    elasticity  malleable expand-back          (NONE / BALANCE, ...)

Legacy strings ("BASE", "CUA&SPAA", ...) reproduce the paper's six
mechanisms bit-for-bit; any registered "<notice>&<arrival>" combination
(e.g. "CUA&STEAL") runs without touching this file.  The lifecycle rules
are the paper's: lease return at on-demand completion and reservation
release 10 min after a no-show's estimated arrival; waiting jobs are
FCFS + EASY backfilled, and reserved nodes may host backfilled jobs that
are preempted the instant the on-demand job arrives (paper §III-B1).

With mechanism="BASE" every job is a plain batch job under FCFS/EASY
(paper Table II).
"""
from __future__ import annotations

import heapq
import itertools
import math
import time as _walltime
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .cluster import Lease, NodeLedger
from .job import JobSpec, JobType, NoticeKind, RunState
from .policy import (ARRIVAL_POLICIES, MECHANISMS, NOTICE_POLICIES,
                     PolicyBundle, SchedulerOps, resolve_mechanism)
from .sketches import P2Quantile
from .structures import OrderedSet, WaitQueue


@dataclass
class SimConfig:
    n_nodes: int
    mechanism: str = "CUA&SPAA"          # "BASE" or any registered mechanism
    release_threshold: float = 600.0      # release reservation 10 min past est
    malleable_warning: float = 120.0      # Amazon-style 2-min warning
    backfill_depth: int = 100
    allow_reserved_backfill: bool = True
    instant_eps: float = 1.0              # wait <= eps counts as instant start
    track_decision_time: bool = False
    queue_policy: str = "EASY"            # registered QueuePolicy name
    #: streaming ingestion horizon (s): when jobs arrive as an iterator,
    #: every job with submit_time within this window of the next event is
    #: ingested before the event runs, so advance-notice events (which
    #: precede their job's arrival by the notice lead) are never pushed
    #: into the past.  Must exceed the workload's largest notice lead +
    #: late window; the default covers the paper's minutes-scale leads
    #: with a wide margin while keeping the ingested-ahead set small.
    arrival_lookahead: float = 14400.0
    #: fault-model spec (repro.faults): "none" (default, bit-for-bit
    #: legacy), a compact string like "exp-mtbf:mtbf_h=168,mttr_h=2",
    #: or a {"model": ..., ...params} dict.  Resolved once at
    #: construction; the failure/repair stream is materialized into the
    #: event heap up front so injection is deterministic per spec.
    faults: object = "none"
    #: batch scheduling rounds (Firmament-style): interval in seconds
    #: between scheduling passes.  0 (default) is the per-event engine —
    #: bit-for-bit the golden-tested behavior, one epilogue ``_schedule``
    #: pass per event.  > 0 accumulates events between fixed round
    #: boundaries (heap pops still advance state and fire per-type
    #: semantics — notices reserve, releases route to collectors, ENDs
    #: retire) and runs ONE deferred pass at the next multiple of
    #: ``batch_rounds``; on-demand arrivals stay immediate-path (their
    #: acquire plus an epilogue pass run at arrival, Obs-10).  Queued
    #: batch jobs trade up to one round of start staleness for
    #: order-of-magnitude fewer passes (docs/performance.md carries the
    #: measured fidelity-vs-speed curve).
    batch_rounds: float = 0.0
    #: run the node-ledger invariant scan (``NodeLedger.check``) after
    #: every event.  Formerly unconditional; the scan was ~4% of the
    #: per-event hot loop (benchmarks/bench_profile.py), so it is now a
    #: debugging aid — property/chaos tests switch it on.
    check_invariants: bool = False

    # legacy introspection helpers; composite mechanisms ("BASE") have no
    # "&" and report themselves on both axes.
    @property
    def notice_policy(self) -> str:
        return self.mechanism.split("&", 1)[0] if "&" in self.mechanism \
            else self.mechanism

    @property
    def arrival_policy(self) -> str:
        return self.mechanism.split("&", 1)[1] if "&" in self.mechanism \
            else self.mechanism


@dataclass
class JobRecord:
    job: JobSpec
    first_start: Optional[float] = None
    completion: Optional[float] = None
    killed: bool = False
    n_preempted: int = 0
    n_shrunk: int = 0
    instant: bool = False

    @property
    def turnaround(self) -> Optional[float]:
        if self.completion is None:
            return None
        return self.completion - self.job.submit_time


class Simulator:
    """One simulation run over a job trace.

    ``jobs`` is either a materialized list (the legacy path: every
    event is pushed up front, bit-for-bit the golden-tested behavior)
    or any other iterable/iterator, which is consumed *lazily*: jobs
    are ingested as the clock approaches their submit time
    (``SimConfig.arrival_lookahead``), so a year-scale trace never
    holds more than the active window of JobSpecs.

    ``record_sink`` (optional) makes completed-job state *retire*: the
    sink callable receives each finished :class:`JobRecord` exactly
    once, after which the simulator drops every per-job structure for
    that jid — ``records``/``jobs`` then hold O(active jobs), not
    O(total), and metrics must be aggregated incrementally by the sink
    (see :class:`repro.core.metrics.StreamingMetrics`).  Without a
    sink, ``records`` accumulates every job as before and
    :func:`repro.core.metrics.collect` works unchanged.
    """

    def __init__(self, cfg: SimConfig, jobs: Iterable[JobSpec],
                 record_sink: Optional[Callable[[JobRecord], None]] = None):
        self.policies: PolicyBundle = resolve_mechanism(cfg.mechanism,
                                                        cfg.queue_policy)
        self.cfg = cfg
        self.record_sink = record_sink
        self.jobs: Dict[int, JobSpec] = {}
        self.ledger = NodeLedger(cfg.n_nodes)
        self.now = 0.0
        self._heap: List[Tuple[float, int, str, tuple]] = []
        self._seq = itertools.count()
        self.queue = WaitQueue()             # waiting jids, order-key sorted
        self.running: Dict[int, RunState] = {}
        self.records: Dict[int, JobRecord] = {}
        self.od_status: Dict[int, str] = {}  # noticed|arrived|timeout|done
        self.collecting = OrderedSet()       # od jids collecting releases (notice order)
        self.od_front: Dict[int, bool] = {}  # arrived ods waiting at queue front
        self.leases: Dict[int, List[Lease]] = {}
        self.progress: Dict[int, dict] = {}  # preempted-job carry-over state
        self.est_remaining: Dict[int, float] = {}
        self._epochs: Dict[int, int] = {}    # monotonic per-jid END epoch
        self._estend_cache: Dict[int, Tuple[float, int]] = {}  # jid -> (est-end base, cur_size)
        # ---- fault injection (repro.faults) -------------------------------
        # The failure/repair stream is materialized up front in its own
        # seq namespace (trace < fault < dynamic at equal times), so the
        # event order is a pure function of the spec — independent of
        # feed timing, step_until partitioning, and the job trace.
        self.fault_model_name = "none"
        self._faults_on = False
        self._down_nodes: set = set()
        self._fault_shrunk: Dict[int, int] = {}  # jid -> nodes owed back
        self.fault_downs = 0                 # node_down events applied
        self.fault_ups = 0                   # node_up events applied
        self.n_interruptions = 0             # running jobs hit by a failure
        self.fault_lost_node_s = 0.0         # node-seconds of work + setup lost
        self.avail_integral = 0.0            # ∫ up-node count dt
        # snapshot at the latest completion: the goodput denominator is
        # the up-capacity over [0, finish_time], not over the (possibly
        # much longer) fault-event horizon
        self.avail_at_completion = 0.0
        if cfg.faults not in (None, "none"):
            # the fault models (the reference's repro.faults) are not
            # copied yet; fault-free runs never reach them
            raise NotImplementedError(
                f"fault model {cfg.faults!r}: fault models are not ported "
                f"yet (ROADMAP queue 1, fault models)")
        self.ops = SchedulerOps(self)        # the handle policies act through
        self._queue_key = self.policies.queue.make_order_key(self.ops)
        self.queue.configure(self._queue_key,
                             incremental=self.policies.queue.order_keys_stable,
                             meta_fn=self._queue_meta)
        # metrics accumulators
        self.occupied_integral = 0.0
        self.waste_node_seconds = 0.0
        self._last_t = 0.0
        #: materialized decision-latency samples (legacy path).  On
        #: streaming runs (a ``record_sink`` is installed) the list
        #: would grow one float per od arrival + scheduling pass over a
        #: million-job replay, so latencies fold into a P² p99 sketch
        #: instead (the p99 is the only statistic ever consumed there —
        #: see metrics.decision_p99_ms); the list then stays empty.
        self.decision_times: List[float] = []
        self._decision_sketch: Optional[P2Quantile] = \
            P2Quantile(0.99) if (record_sink is not None
                                 and cfg.track_decision_time) else None
        self._in_schedule = False
        self._sched_pending = False
        self._sched_now = False              # od arrival: pass runs this event
        self._round_next = math.inf          # pending deferred-pass boundary
        #: per-kind bound handlers, filled lazily on first dispatch — a
        #: dict hit replaces the per-event ``getattr(self, f"_on_{kind}")``
        #: string-build + attribute walk (a profiled hot-loop frame);
        #: subclass overrides still win because binding goes through self.
        self._handlers: Dict[str, Callable[..., None]] = {}
        self.n_ingested = 0                  # jobs pulled from the trace
        self.n_retired = 0                   # records handed to the sink
        self._last_completion = 0.0

        if isinstance(jobs, list):           # legacy: all events up front
            self._arrivals = None
            self._next_arrival: Optional[JobSpec] = None
            for j in jobs:
                self._ingest(j)
        else:                                # streaming: ingest lazily
            self._arrivals = iter(jobs)
            self._next_arrival = next(self._arrivals, None)

    # ------------------------------------------------------------------ events
    # Heap ties break on a sequence number.  Trace events (submit/notice/
    # od_timeout) take (jid, slot)-derived seqs BELOW this base and
    # dynamically scheduled events (end, planned_preempt) counter-derived
    # seqs above it — the exact order the legacy constructor produced by
    # pushing every trace event up front — so lazy ingestion cannot
    # reorder simultaneous events (integer-second SWF traces collide
    # constantly) and streaming stays tie-for-tie identical to the list
    # path.  Fault events (node_down/node_up, repro.faults) sit between
    # the two: at equal times a failure lands after the trace event but
    # before any dynamically scheduled END — and their seq is the index
    # into the materialized fault stream, so it never interacts with
    # either counter.
    _DYN_SEQ_BASE = 1 << 60
    _FAULT_SEQ_BASE = 1 << 59

    def _push(self, t: float, kind: str, data: tuple) -> None:
        heapq.heappush(self._heap,
                       (t, self._DYN_SEQ_BASE + next(self._seq), kind, data))

    def _push_trace(self, t: float, jid: int, slot: int, kind: str,
                    data: tuple) -> None:
        heapq.heappush(self._heap, (t, 4 * jid + slot, kind, data))

    def _ingest(self, j: JobSpec) -> None:
        """Admit one job to the simulation: per-job state + its events."""
        if self._arrivals is not None and j.submit_time < self.now - 1e-9:
            raise ValueError(
                f"streaming arrival out of order: job {j.jid} submits at "
                f"{j.submit_time} but the clock is already at {self.now} "
                "(the arrival iterator must be submit-time sorted)")
        self.jobs[j.jid] = j
        self.records[j.jid] = JobRecord(j)
        self.est_remaining[j.jid] = j.t_estimate
        self.n_ingested += 1
        self._push_trace(j.submit_time, j.jid, 0, "submit", (j.jid,))
        if (j.jtype is JobType.ONDEMAND and j.notice_kind is not NoticeKind.NONE
                and self.policies.od_aware):
            if self._arrivals is not None \
                    and j.notice_time < self.now - 1e-9:
                raise ValueError(
                    f"job {j.jid}'s advance notice at {j.notice_time} is "
                    f"already behind the clock ({self.now}): "
                    "SimConfig.arrival_lookahead "
                    f"({self.cfg.arrival_lookahead}s) must exceed the "
                    "workload's largest notice lead + late window")
            self._push_trace(j.notice_time, j.jid, 1, "notice", (j.jid,))
            # A LATE notice drawn near t=0 can place est_arrival (and so
            # the timeout) before the simulation start, which would pop a
            # negative-time event and break clock monotonicity.  The
            # reservation cannot expire before the notice that creates it,
            # so floor the timeout there — a no-op for every trace whose
            # timeouts already fall after their notices.
            self._push_trace(max(j.est_arrival + self.cfg.release_threshold,
                                 j.notice_time),
                             j.jid, 2, "od_timeout", (j.jid,))

    def _feed(self) -> None:
        """Pull pending arrivals whose submit time falls within
        ``arrival_lookahead`` of the next event, so notice/timeout
        events that *precede* an arrival are heaped before the clock
        can pass them.  No-op on the legacy list path."""
        nxt = self._next_arrival
        if nxt is None:
            return
        # anchor on the *earlier* of next event and next arrival: a
        # far-future heap event (a fault stream's next repair during a
        # quiet spell) must not drag the whole remaining trace into
        # memory.  The very next arrival is always within lookahead of
        # itself, so due arrivals are never missed.
        base = nxt.submit_time if not self._heap \
            else min(self._heap[0][0], nxt.submit_time)
        horizon = base + self.cfg.arrival_lookahead
        while nxt is not None and nxt.submit_time <= horizon:
            self._ingest(nxt)
            nxt = next(self._arrivals, None)
        self._next_arrival = nxt

    def _advance(self, t: float) -> None:
        assert t >= self.now - 1e-9
        dt = max(0.0, t - self._last_t)
        self.occupied_integral += self.ledger.occupied * dt
        if self._faults_on:
            self.avail_integral += (self.ledger.total - self.ledger.down
                                    - self.ledger.draining) * dt
        self._last_t = t
        self.now = max(self.now, t)

    def run(self) -> Dict[int, JobRecord]:
        """Drain the event heap (``step_until(inf)`` + :meth:`finalize`).

        Handlers do not re-enter ``_schedule`` per sub-event; they raise
        ``_sched_pending`` and the loop epilogue runs one scheduling pass
        per event (handlers invoked it as their final statement, so the
        hoisted call is behaviorally identical).  With
        ``SimConfig.batch_rounds > 0`` the epilogue pass is instead
        deferred to the next round boundary (od arrivals excepted); the
        drain naturally flushes a trailing deferred pass, which may
        start queued jobs and extend the run.

        On the streaming path, each iteration first tops the heap up
        with every arrival inside the lookahead window of the next
        event; a newly ingested event earlier than the current top is
        simply popped first.
        """
        self.step_until(math.inf)
        self.finalize()
        return self.records

    def next_event_time(self) -> Optional[float]:
        """Earliest pending event time — including a deferred batch-round
        scheduling pass (``SimConfig.batch_rounds``), which is an event
        for pacing purposes — or None when the simulation is drained.
        Ingests from a streaming arrival iterator as needed to answer
        (ingestion order is the same the run loop would use, so peeking
        never perturbs the event sequence).  This is the pacing signal
        external drivers (``repro_torch.service``) sleep against: in batch
        mode the daemon therefore sleeps to round boundaries and its
        ``step_until(next_event_time())`` cadence runs each deferred
        pass at exactly its boundary."""
        if self._next_arrival is not None:
            self._feed()
        t = self._heap[0][0] if self._heap else None
        rn = self._round_next
        if rn != math.inf:
            return rn if t is None or rn < t else t
        return t

    def step_until(self, t_limit: float) -> Optional[float]:
        """Process every event with time <= ``t_limit`` and stop.

        The incremental face of :meth:`run`: calling ``step_until`` with
        any non-decreasing sequence of limits processes the exact event
        sequence one ``run()`` would (each loop iteration depends only on
        heap state, never on how the limits partition it), which is what
        makes an external replay driver decision-for-decision identical
        to the offline simulator.  A deferred batch-round pass behaves
        like an event here: it runs only once its boundary is <= the
        limit (ties go to heap events — a pass at a boundary runs after
        every event at that time), and a still-pending boundary is
        carried to the next call, so the partitioning property holds in
        batch mode too.  Returns the next pending event (or pending
        round-pass) time > ``t_limit``, or None when drained; callers
        that passed a finite limit must eventually call :meth:`finalize`
        (or :meth:`run`) to flush retained records into a
        ``record_sink``.
        """
        heap = self._heap
        handlers = self._handlers
        batch = self.cfg.batch_rounds
        track = self.cfg.track_decision_time
        check = self.ledger.check if self.cfg.check_invariants else None
        while True:
            if self._next_arrival is not None:
                self._feed()
            if batch:
                rn = self._round_next
                if rn < (heap[0][0] if heap else math.inf):
                    # the deferred pass is due before the next event
                    if rn > t_limit:
                        break
                    self._advance(rn)
                    self._round_next = math.inf
                    if track:
                        t0 = _walltime.perf_counter()
                        self._schedule()
                        self._record_decision(_walltime.perf_counter() - t0)
                    else:
                        self._schedule()
                    if check is not None:
                        check()
                    continue
            if not heap or heap[0][0] > t_limit:
                break
            t, _, kind, data = heapq.heappop(heap)
            self._advance(t)
            h = handlers.get(kind)
            if h is None:
                h = handlers[kind] = getattr(self, f"_on_{kind}")
            h(*data)
            if self._sched_pending:
                self._sched_pending = False
                if batch and not self._sched_now:
                    # defer to the next round boundary (>= now; equal
                    # when the event lands exactly on one).  An earlier
                    # boundary may already be pending — keep it.
                    if self._round_next == math.inf:
                        self._round_next = batch * math.ceil(self.now / batch)
                elif track:
                    self._sched_now = False
                    self._round_next = math.inf  # this pass supersedes it
                    t0 = _walltime.perf_counter()
                    self._schedule()
                    self._record_decision(_walltime.perf_counter() - t0)
                else:
                    self._sched_now = False
                    self._round_next = math.inf  # this pass supersedes it
                    self._schedule()
            if check is not None:
                check()
        nxt = heap[0][0] if heap else math.inf
        if self._round_next < nxt:
            nxt = self._round_next
        return None if nxt == math.inf else nxt

    def finalize(self) -> None:
        """Flush post-run record retention; idempotent."""
        if self.record_sink is not None and self.records:
            # jobs that never reached an END (e.g. unstartable size):
            # the sink must still see every record or its n_jobs and
            # ratio denominators would diverge from collect()'s
            for jid in list(self.records):
                self._retire(jid, self.records[jid])

    # ------------------------------------------------------------- submission
    def _on_submit(self, jid: int) -> None:
        job = self.jobs[jid]
        if job.jtype is JobType.ONDEMAND and self.policies.od_aware:
            self._od_arrival(jid)
        else:
            self.queue.append(jid)
            self._sched_pending = True

    # ---------------------------------------------------------- advance notice
    def _on_notice(self, jid: int) -> None:
        if self.od_status.get(jid) is not None:
            return  # already arrived (defensive)
        self.od_status[jid] = "noticed"
        self.policies.notice.on_notice(self.ops, jid)

    def _on_planned_preempt(self, od_jid: int, victim: int, epoch: int) -> None:
        if self.od_status.get(od_jid) != "noticed":
            return  # arrived or timed out; plan void
        rs = self.running.get(victim)
        if rs is None or rs.epoch != epoch:
            return
        od = self.jobs[od_jid]
        if self.ledger.reserved_of(od_jid) >= od.size:
            return  # demand already met by collected releases
        self._preempt(victim, beneficiary=od_jid)
        self._sched_pending = True

    def _on_od_timeout(self, jid: int) -> None:
        if self.od_status.get(jid) != "noticed":
            return
        self.od_status[jid] = "timeout"
        if jid in self.collecting:
            self.collecting.remove(jid)
        self.ledger.release_reservation(jid)
        self._sched_pending = True

    # ------------------------------------------------------------- od arrival
    def _od_arrival(self, jid: int) -> None:
        job = self.jobs[jid]
        self.od_status[jid] = "arrived"
        if jid in self.collecting:
            self.collecting.remove(jid)
        t0 = _walltime.perf_counter()
        # 1. evict backfilled borrowers of this reservation immediately.
        for rid in [r for r, rs in self.running.items() if rs.borrowed.get(jid)]:
            self._preempt(rid, beneficiary=jid)
        need = job.size - self.ledger.reserved_of(jid) - self.ledger.free
        if need <= 0:
            self._start_od(jid)
            started = True
        else:
            started = self.policies.arrival.acquire(self.ops, jid, need)
        if self.cfg.track_decision_time:
            self._record_decision(_walltime.perf_counter() - t0)
        if started:
            rec = self.records[jid]
            rec.instant = (rec.first_start - job.submit_time) <= self.cfg.instant_eps
        else:
            # cannot start instantly: head of queue + collect every release.
            self.od_front[jid] = True
            self.queue.append(jid)
            if jid not in self.collecting:
                self.collecting.append(jid)
        self._sched_pending = True
        # batch mode: the od arrival's epilogue pass is never deferred to
        # the round boundary — Obs-10 responsiveness survives any round
        # length (no-op flag on the per-event engine).
        self._sched_now = True

    def _record_decision(self, dt: float) -> None:
        """One decision-latency sample: the materialized list, or the P²
        p99 sketch on streaming runs (see ``decision_times``)."""
        sketch = self._decision_sketch
        if sketch is not None:
            sketch.add(dt)
        else:
            self.decision_times.append(dt)

    def _start_od(self, jid: int) -> None:
        job = self.jobs[jid]
        res = self.ledger.reserved_of(jid)
        take_res = min(res, job.size)
        from_free = job.size - take_res
        assert from_free <= self.ledger.free
        self.ledger.allocate(job.size, from_free=from_free,
                             od=jid if take_res else None, from_reserved=take_res)
        self.ledger.release_reservation(jid)  # return any surplus reservation
        if jid in self.collecting:
            self.collecting.remove(jid)
        self._begin_run(jid, job.size)
        self.od_front.pop(jid, None)
        # front-pinning is the one builtin event that changes an order key;
        # callers dequeue before starting, so this is a documented no-op
        # kept as the pattern custom key-changing events must follow
        self.queue.invalidate(jid)

    # -------------------------------------------------- preempt / shrink / expand
    def _preempt(self, jid: int, beneficiary: Optional[int] = None,
                 lost: int = 0) -> None:
        """Vacate a running job; nodes go to `beneficiary`'s reservation.

        ``lost`` nodes (a fault killed them under the job) are not
        routed anywhere — the caller already moved them to the ledger's
        down pool, so only ``cur_size - lost`` nodes are released."""
        rs = self.running.pop(jid)
        self._estend_cache.pop(jid, None)
        if self._fault_shrunk:
            self._fault_shrunk.pop(jid, None)
        job = rs.job
        rec = self.records[jid]
        rec.n_preempted += 1
        if job.jtype is JobType.MALLEABLE:
            done = rs.work_done(self.now)   # 2-min warning checkpoint
            ckpt = done
            self.waste_node_seconds += job.t_setup * job.size
        else:
            done = rs.work_done(self.now)
            ckpt = rs.checkpointed_work(self.now)
            self.waste_node_seconds += (done - ckpt) + job.t_setup * job.size
            done = ckpt                     # recompute from last checkpoint
        self.progress[jid] = {"done_work": done, "ckpt_work": ckpt,
                              "n_starts": rs.n_starts}
        # paper: updated runtime estimate, original submit time kept.
        slack = max(1.0, job.t_estimate / max(job.t_actual, 1.0))
        rem = max(job.work - done, 0.0) / job.size
        if job.jtype is JobType.RIGID and math.isfinite(job.ckpt_interval):
            rem += math.floor(rem / job.ckpt_interval) * job.ckpt_overhead
        self.est_remaining[jid] = job.t_setup + rem * slack + 60.0
        # ---- node routing: borrowed -> owners, rest -> beneficiary/releases
        freed = rs.cur_size - lost
        for od, k in rs.borrowed.items():
            k = min(k, freed)
            if self.od_status.get(od) == "noticed":
                self.ledger.occupied_to_reserved(od, k)
            else:
                self.ledger.free_nodes(k)
            freed -= k
        if beneficiary is not None and freed > 0:
            bj = self.jobs[beneficiary]
            want = max(0, bj.size - self.ledger.reserved_of(beneficiary))
            k = min(want, freed)
            if k > 0:
                self.ledger.occupied_to_reserved(beneficiary, k)
                self._lease(beneficiary, jid, k, "preempt")
                freed -= k
        self._epochs[jid] = self._epochs.get(jid, 0) + 1  # invalidate pending END
        # re-queue before routing: the elasticity policy must see the victim
        # waiting, or absorb_release would hand its nodes to running
        # malleables (FCFS key keeps the original submit time).
        self.queue.append(jid)
        if freed > 0:
            self._route_release(freed)

    def _shrink(self, jid: int, k: int, od: int) -> None:
        rs = self.running[jid]
        assert rs.cur_size - k >= rs.job.n_min
        rs.work_at_resize = rs.work_done(self.now)
        rs.last_resize = max(self.now, rs.last_resize)
        rs.cur_size -= k
        rs.shrunk_by[od] = rs.shrunk_by.get(od, 0) + k
        self.records[jid].n_shrunk += 1
        self.ledger.occupied_to_reserved(od, k)
        self._lease(od, jid, k, "shrink")
        self._reschedule_end(jid)

    def _expand(self, jid: int, k: int) -> None:
        """Give k already-accounted (occupied) nodes back to a shrunk job."""
        rs = self.running[jid]
        grow = min(k, rs.job.n_max - rs.cur_size)
        if grow < k:  # cannot absorb everything; spill to free pool
            self.ledger.free_nodes(k - grow)
        if grow <= 0:
            return
        rs.work_at_resize = rs.work_done(self.now)
        rs.last_resize = max(self.now, rs.last_resize)
        rs.cur_size += grow
        self._reschedule_end(jid)

    def _expand_from_free(self, jid: int, k: int) -> int:
        """Grow a running malleable by up to k free-pool nodes; returns the
        number actually granted (ElasticityPolicy.on_idle uses this)."""
        rs = self.running[jid]
        k = min(k, self.ledger.free, rs.job.n_max - rs.cur_size)
        if k <= 0:
            return 0
        self.ledger.allocate(k, from_free=k)
        self._expand(jid, k)
        return k

    def _lease(self, od: int, lender: int, k: int, kind: str) -> None:
        self.leases.setdefault(od, []).append(Lease(lender, k, kind))

    # ------------------------------------------------------------ node faults
    def _on_node_down(self, node: int) -> None:
        """A node fails (repro.faults).  The count-based ledger has no
        per-node identity, so "which node died" maps to "which pool was
        hit" at the moment of failure: one draw from the fault rng,
        uniform over all in-play nodes, walked through the pools in a
        fixed order (free, od reservations, holds, running occupancy in
        insertion order).  Draws are consumed in event order, so the
        whole run is deterministic per fault spec."""
        if node in self._down_nodes:
            return  # node already out (overlapping trace entries)
        led = self.ledger
        in_play = (led.free + sum(led.od_reserved.values())
                   + sum(led.job_hold.values()) + led.occupied)
        if in_play <= 0:
            return  # machine already fully down/draining
        self._down_nodes.add(node)
        self.fault_downs += 1
        r = int(self._fault_rng.integers(in_play))
        if r < led.free:
            led.fail_free()
        else:
            r -= led.free
            hit_od = None
            for od, k in led.od_reserved.items():
                if r < k:
                    hit_od = od
                    break
                r -= k
            if hit_od is not None:
                # the reservation shrinks; its owner re-collects the
                # shortfall from later releases/repairs
                led.fail_reserved(hit_od)
            else:
                hit_hold = None
                for jid, k in led.job_hold.items():
                    if r < k:
                        hit_hold = jid
                        break
                    r -= k
                if hit_hold is not None:
                    led.fail_hold(hit_hold)
                else:
                    victim = None
                    for jid, rs in self.running.items():
                        if r < rs.cur_size:
                            victim = jid
                            break
                        r -= rs.cur_size
                    assert victim is not None, "pool walk exhausted in-play nodes"
                    self._fault_hit_running(victim)
        self._sched_pending = True

    def _fault_hit_running(self, victim: int) -> None:
        """Apply the paper's per-type semantics to the job that owned the
        failed node: malleable jobs shed it and keep running, rigid jobs
        restart from their last Daly checkpoint (§IV), on-demand jobs are
        re-dispatched with the wait clock still running."""
        rs = self.running[victim]
        job = rs.job
        self.n_interruptions += 1
        if job.jtype is JobType.MALLEABLE and rs.cur_size > max(job.n_min, 1):
            self._fault_shrink(victim)
            return
        # the job dies with the node: account the lost slice, move the
        # node out of occupancy, then route through the normal restart
        # machinery with the downed node excluded from release routing.
        done = rs.work_done(self.now)
        self.ledger.fail_occupied()
        if job.jtype is JobType.ONDEMAND and self.policies.od_aware:
            self._fault_evict_od(victim)
            return
        if job.jtype is JobType.MALLEABLE:
            ckpt = done                     # 2-min-warning checkpoint model
        else:
            ckpt = rs.checkpointed_work(self.now)
        self.fault_lost_node_s += (done - ckpt) + job.t_setup * job.size
        self._preempt(victim, lost=1)

    def _fault_shrink(self, jid: int) -> None:
        """A malleable job sheds the failed node and keeps running; the
        repair hands the node back (expand-back) ahead of the free pool."""
        rs = self.running[jid]
        rs.work_at_resize = rs.work_done(self.now)
        rs.last_resize = max(self.now, rs.last_resize)
        rs.cur_size -= 1
        self.records[jid].n_shrunk += 1
        self.ledger.fail_occupied()
        self._fault_shrunk[jid] = self._fault_shrunk.get(jid, 0) + 1
        self._reschedule_end(jid)

    def _fault_evict_od(self, jid: int) -> None:
        """Re-dispatch a fault-killed on-demand job.  On-demand jobs have
        no checkpoints, so all progress is lost; ``submit_time`` is kept
        so Obs-style responsiveness is measured *through* the failure.
        The surviving nodes become the job's own reservation and the
        arrival policy re-acquires the shortfall exactly as at a fresh
        arrival (caller already moved the downed node out of occupancy)."""
        rs = self.running.pop(jid)
        self._estend_cache.pop(jid, None)
        job = rs.job
        rec = self.records[jid]
        rec.n_preempted += 1
        done = rs.work_done(self.now)
        waste = done + job.t_setup * job.size
        self.waste_node_seconds += waste
        self.fault_lost_node_s += waste
        self.progress[jid] = {"done_work": 0.0, "ckpt_work": 0.0,
                              "n_starts": rs.n_starts}
        slack = max(1.0, job.t_estimate / max(job.t_actual, 1.0))
        self.est_remaining[jid] = job.t_setup + (job.work / job.size) * slack + 60.0
        self._epochs[jid] = self._epochs.get(jid, 0) + 1  # void pending END
        assert not rs.borrowed, "on-demand jobs never borrow"
        freed = rs.cur_size - 1
        if freed > 0:
            self.ledger.occupied_to_reserved(jid, freed)
        need = job.size - self.ledger.reserved_of(jid) - self.ledger.free
        if need <= 0:
            self._start_od(jid)
        elif not self.policies.arrival.acquire(self.ops, jid, need):
            self.od_front[jid] = True
            self.queue.append(jid)
            if jid not in self.collecting:
                self.collecting.append(jid)

    def _on_node_up(self, node: int) -> None:
        """A failed node is repaired: it re-enters service and is routed
        like a release — collecting on-demand reservations first (paper
        od priority), then expand-back for fault-shrunk malleables when
        no queued job could claim it, else the free pool for the
        scheduling pass."""
        if node not in self._down_nodes:
            return  # repair for a node that never went down (trace noise)
        self._down_nodes.remove(node)
        self.fault_ups += 1
        self.ledger.repair()
        for od in list(self.collecting):
            if self.ledger.free == 0:
                break
            job = self.jobs[od]
            want = job.size - self.ledger.reserved_of(od)
            if want > 0:
                self.ledger.reserve_from_free(od, want)
            if self.ledger.reserved_of(od) >= job.size:
                self.collecting.remove(od)
                if self.od_status.get(od) == "arrived":
                    self.queue.remove(od)
                    self._start_od(od)
        if self.ledger.free > 0 and not self.queue and self._fault_shrunk:
            for jid in list(self._fault_shrunk):
                if jid not in self.running:
                    del self._fault_shrunk[jid]
                    continue
                got = self._expand_from_free(jid, self._fault_shrunk[jid])
                if got >= self._fault_shrunk[jid]:
                    del self._fault_shrunk[jid]
                else:
                    self._fault_shrunk[jid] -= got
                if self.ledger.free == 0:
                    break
        self._sched_pending = True

    # --------------------------------------------------------------- run / end
    def _begin_run(self, jid: int, size: int) -> None:
        job = self.jobs[jid]
        carry = self.progress.pop(jid, None)
        rs = RunState(job=job, start_time=self.now, cur_size=size)
        if carry:
            rs.done_work = carry["done_work"]
            rs.ckpt_work = carry["ckpt_work"]
            rs.n_starts = carry["n_starts"] + 1
            rs.work_at_resize = rs.done_work
        self.running[jid] = rs
        rec = self.records[jid]
        if rec.first_start is None:
            rec.first_start = self.now
        self._reschedule_end(jid)

    def _est_end_base(self, rs: RunState) -> float:
        """The un-clamped estimated end; constant between _reschedule_end
        calls (est_remaining, last_resize, and cur_size only change at
        events that reschedule the END), so it is cached per running job
        for the vectorized EASY shadow window."""
        start = rs.last_resize - rs.job.t_setup
        est = self.est_remaining[rs.job.jid]
        if rs.job.jtype is JobType.MALLEABLE:
            est = rs.job.t_setup + (est - rs.job.t_setup) * rs.job.n_max / max(rs.cur_size, 1)
        return start + est

    def _est_end(self, rs: RunState) -> float:
        """Estimated end used by EASY/CUP (user estimate, not actual)."""
        return max(self._est_end_base(rs), self.now)

    def _queue_meta(self, jid: int) -> Tuple[float, float]:
        """The WaitQueue metas the vectorized backfill prefilter scans:
        (minimum nodes to start — inf for on-demand jobs, which never
        backfill —, remaining-runtime estimate).  Both are constant while
        the job waits: est_remaining changes only on preemption, which
        requeues the job and recomputes its metas."""
        job = self.jobs[jid]
        if job.jtype is JobType.ONDEMAND:
            return math.inf, self.est_remaining[jid]
        need = float(job.n_min if job.jtype is JobType.MALLEABLE else job.size)
        return need, self.est_remaining[jid]

    def _reschedule_end(self, jid: int) -> None:
        rs = self.running[jid]
        self._epochs[jid] = self._epochs.get(jid, 0) + 1
        rs.epoch = self._epochs[jid]
        base = self._est_end_base(rs)
        self._estend_cache[jid] = (base, rs.cur_size)
        natural = rs.natural_end(self.now)
        kill = max(base, self.now)
        self._push(min(natural, max(kill, self.now)), "end", (jid, rs.epoch))

    def _on_end(self, jid: int, epoch: int) -> None:
        rs = self.running.get(jid)
        if rs is None or rs.epoch != epoch:
            return
        job = rs.job
        done = rs.work_done(self.now)
        killed = done < job.work - 1e-6
        del self.running[jid]
        self._estend_cache.pop(jid, None)
        if self._fault_shrunk:
            self._fault_shrunk.pop(jid, None)
        rec = self.records[jid]
        rec.completion = self.now
        rec.killed = killed
        # vacate: borrowed -> owners, rest routed to collectors/free
        freed = rs.cur_size
        for od, k in rs.borrowed.items():
            k = min(k, freed)
            if self.od_status.get(od) == "noticed":
                self.ledger.occupied_to_reserved(od, k)
            else:
                self.ledger.free_nodes(k)
            freed -= k
        if job.jtype is JobType.ONDEMAND:
            self.od_status[jid] = "done"
            freed = self._repay_leases(jid, freed)
        if freed > 0:
            self._route_release(freed)
        self._last_completion = max(self._last_completion, self.now)
        if self._faults_on:
            self.avail_at_completion = self.avail_integral
        if self.record_sink is not None:
            self._retire(jid, rec)
        self._sched_pending = True

    def _retire(self, jid: int, rec: JobRecord) -> None:
        """Hand a finished record to the sink and drop every per-job
        structure: with a sink installed the simulator holds O(active)
        job state, not O(total).  Only reached from ``_on_end`` —
        completed jobs are never rescheduled, stale heap events for the
        jid are epoch/status-guarded, and a done/timed-out on-demand
        status reads the same as an absent one everywhere it is
        checked."""
        self.record_sink(rec)
        self.n_retired += 1
        del self.records[jid]
        del self.jobs[jid]
        del self.est_remaining[jid]
        self._epochs.pop(jid, None)
        self.progress.pop(jid, None)
        if rec.job.jtype is JobType.ONDEMAND:
            self.od_status.pop(jid, None)

    def _repay_leases(self, od: int, avail: int) -> int:
        """Return leased nodes to lenders (paper §III-B3)."""
        for lease in self.leases.pop(od, []):
            k = min(lease.nodes, avail)
            if k <= 0:
                break
            lender = lease.lender
            rs = self.running.get(lender)
            if rs is not None and lease.kind == "shrink" and rs.shrunk_by.get(od):
                give = min(k, rs.shrunk_by[od])
                rs.shrunk_by[od] -= give
                self._expand(lender, give)   # stays "occupied"
                avail -= give
                k -= give
            if k > 0 and lender in self.queue:
                self.ledger.occupied_to_hold(lender, k)
                avail -= k
            # lender finished or not expandable: nodes stay in `avail`
        return avail

    def _route_release(self, k: int) -> None:
        """Vacated occupied nodes -> collecting reservations, then the
        elasticity policy, then the free pool."""
        assert k >= 0
        for od in list(self.collecting):
            if k == 0:
                break
            job = self.jobs[od]
            want = job.size - self.ledger.reserved_of(od)
            take = min(want, k)
            if take > 0:
                self.ledger.occupied_to_reserved(od, take)
                k -= take
            if self.ledger.reserved_of(od) >= job.size:
                self.collecting.remove(od)
                if self.od_status.get(od) == "arrived":
                    # arrived od waiting at queue front: launch now
                    self.queue.remove(od)
                    self._start_od(od)
        if k > 0:
            k = self.policies.elasticity.absorb_release(self.ops, k)
        if k > 0:
            self.ledger.free_nodes(k)

    # ------------------------------------------------------------- scheduling
    def _schedule(self) -> None:
        if self._in_schedule:
            return
        self._in_schedule = True
        try:
            changed = True
            while changed:
                changed = False
                self.queue.refresh()   # incremental queues are always sorted
                if not self.queue:
                    break
                head = self.queue[0]
                if self._try_start(head):
                    changed = True
                    continue
                if self._steal_holds(head) and self._try_start(head):
                    changed = True
                    continue
                if (self.cfg.allow_reserved_backfill
                        and self.jobs[head].jtype is not JobType.ONDEMAND
                        and self._try_start_borrowed(head)):
                    changed = True
                    continue
                self.policies.queue.backfill(self.ops, head)
                break
            self.policies.elasticity.on_idle(self.ops)
        finally:
            self._in_schedule = False

    def _avail_for(self, jid: int) -> int:
        job = self.jobs[jid]
        avail = self.ledger.free + self.ledger.hold_of(jid)
        if job.jtype is JobType.ONDEMAND:
            avail += self.ledger.reserved_of(jid)
        return avail

    def _steal_holds(self, head: int) -> int:
        """Deadlock resolution: the queue head outranks returned-lease holds
        of jobs *behind* it.  Transfers just enough held nodes (youngest
        holder first) into the free pool.

        Only the hold book's few entries can contribute, so the legacy
        reversed full-queue walk reduces to sorting the queued holders by
        rank — same nodes moved in the same order, without the O(queue)
        scan per blocked head.  Returns the nodes transferred when they
        cover the shortfall, else 0: an insufficient steal cannot make
        ``_try_start`` succeed, so the caller skips that doomed retry
        (the transfers themselves stand either way, exactly as before).
        """
        job = self.jobs[head]
        need_min = job.n_min if job.jtype is JobType.MALLEABLE else job.size
        short = need_min - self._avail_for(head)
        if short <= 0:
            return 0
        hold_book = self.ledger.job_hold
        if not hold_book:
            return 0
        holders = sorted((self.queue.position(jid), jid) for jid in hold_book
                         if jid != head and jid in self.queue)
        moved = 0
        for _rank, jid in reversed(holders):
            if moved >= short:
                break
            k = min(hold_book[jid], short - moved)
            self.ledger.hold_to_free(jid, k)
            moved += k
        return moved if moved >= short else 0

    def _try_start(self, jid: int) -> bool:
        job = self.jobs[jid]
        need_min = job.n_min if job.jtype is JobType.MALLEABLE else job.size
        if self._avail_for(jid) < need_min:
            return False
        self.queue.remove(jid)
        if job.jtype is JobType.ONDEMAND:
            self._start_od(jid)
            return True
        size = job.size if job.jtype is not JobType.MALLEABLE else \
            min(job.n_max, self._avail_for(jid))
        hold = self.ledger.take_hold(jid)
        from_hold = min(hold, size)
        if from_hold:  # re-insert then consume precisely
            self.ledger.add_hold(jid, from_hold)
        if hold > from_hold:  # excess hold returns to the pool
            self.ledger.free += hold - from_hold
        self.ledger.allocate(size, from_free=size - from_hold,
                             from_hold=from_hold, hold_jid=jid if from_hold else None)
        self._begin_run(jid, size)
        return True

    def _borrow_pool(self) -> Tuple[int, float]:
        """The §III-B1 borrow supply: (idle nodes reserved for
        *not-yet-arrived* on-demand jobs, earliest estimated owner
        arrival).  The backfill pass hoists this to once per pass."""
        pool, deadline = 0, math.inf
        for od, k in self.ledger.od_reserved.items():
            if self.od_status.get(od) == "noticed":
                pool += k
                deadline = min(deadline, self.jobs[od].est_arrival or math.inf)
        return pool, deadline

    def _borrow_eligible(self, jid: int, deadline: float) -> bool:
        """Paper §III-B1 borrower rule: malleable borrowers may run past
        the owner's arrival (the 2-minute-warning preemption only costs
        setup); rigid borrowers must be estimated to finish before it
        (their preemption is expensive)."""
        job = self.jobs[jid]
        return (job.jtype is JobType.MALLEABLE
                or self.now + self.est_remaining[jid] <= deadline)

    def _borrowable(self, jid: int) -> int:
        """Idle reserved nodes this waiting job may borrow (§III-B1)."""
        pool, deadline = self._borrow_pool()
        if pool == 0:
            return 0
        return pool if self._borrow_eligible(jid, deadline) else 0

    def _try_start_borrowed(self, jid: int) -> bool:
        """Start the queue head on idle *reserved* nodes (paper §III-B1):
        such a job is a backfill in the paper's sense and is preempted the
        moment the reservation's on-demand job arrives."""
        job = self.jobs[jid]
        idle_reserved = self._borrowable(jid)
        plain = self.ledger.free + self.ledger.hold_of(jid)
        need_min = job.n_min if job.jtype is JobType.MALLEABLE else job.size
        if idle_reserved == 0 or plain + idle_reserved < need_min:
            return False
        size = job.size if job.jtype is not JobType.MALLEABLE else \
            min(job.n_max, plain + idle_reserved)
        borrow = max(0, size - plain)
        self._start_backfilled(jid, size, borrow)
        return True

    def _start_backfilled(self, jid: int, size: int, borrow: int) -> None:
        self.queue.remove(jid)
        from_hold = min(self.ledger.hold_of(jid), size - borrow)
        from_free = size - borrow - from_hold
        self.ledger.allocate(size - borrow, from_free=from_free,
                             from_hold=from_hold, hold_jid=jid if from_hold else None)
        borrowed: Dict[int, int] = {}
        left = borrow
        for od in list(self.ledger.od_reserved):
            if left == 0:
                break
            if self.od_status.get(od) != "noticed":
                continue  # never borrow from an arrived od still collecting
            k = min(self.ledger.reserved_of(od), left)
            self.ledger.allocate(k, od=od, from_reserved=k)
            borrowed[od] = borrowed.get(od, 0) + k
            left -= k
        assert left == 0
        self._begin_run(jid, size)
        self.running[jid].borrowed = borrowed

    # ---------------------------------------------------------------- results
    def finish_time(self) -> float:
        if not self.records:  # every record retired through the sink
            return self._last_completion
        return max((r.completion or 0.0) for r in self.records.values())
