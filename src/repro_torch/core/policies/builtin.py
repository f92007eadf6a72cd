"""The paper's mechanisms as registry entries (paper §III-B).

Notice axis:   N (nothing) | CUA (collect-until-actual-arrival)
               | CUP (collect-until-predicted-arrival, planned preemption)
Arrival axis:  PAA (preempt ascending overhead) | SPAA (shrink-then-PAA)
Queue:         EASY (FCFS + EASY backfilling) | FCFS (no backfill)
Elasticity:    NONE (lease-repay expansion only — the seed behavior)

Each class is a verbatim port of the corresponding pre-refactor
`Simulator` method; legacy mechanism strings must reproduce seed metrics
bit-for-bit (tests/test_policy_api.py::test_golden_seed_metrics).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..decision import (apportion_shrink, backfill_prefilter,
                        backfill_shadow_filter, easy_shadow,
                        expected_releases_before, select_preemption_victims)
from ..job import JobType
from ..policy import (ArrivalPolicy, ElasticityPolicy, NoticePolicy,
                      PolicyBundle, QueuePolicy, SchedulerOps, SchedulerView,
                      register_mechanism, register_policy)


# ------------------------------------------------------------------- notice
@register_policy("notice", "N")
class NoNotice(NoticePolicy):
    """Ignore advance notice; the job competes only at actual arrival."""

    def on_notice(self, ops: SchedulerOps, jid: int) -> None:
        pass


@register_policy("notice", "CUA")
class CollectUntilArrival(NoticePolicy):
    """Reserve idle nodes at notice; collect releases until arrival."""

    def on_notice(self, ops: SchedulerOps, jid: int) -> None:
        job = ops.jobs[jid]
        got = ops.reserve_from_free(jid, job.size)
        if got < job.size:
            ops.collect(jid)
            self.plan(ops, jid)

    def plan(self, ops: SchedulerOps, jid: int) -> None:
        """CUA never plans preemptions; CUP overrides."""


@register_policy("notice", "CUP")
class CollectUntilPredicted(CollectUntilArrival):
    """CUA + planned preemptions so demand is met by est_arrival."""

    def plan(self, ops: SchedulerOps, jid: int) -> None:
        job = ops.jobs[jid]
        need = job.size - ops.reserved_of(jid)
        ends, sizes = [], []
        for rs in ops.running.values():
            ends.append(ops.est_end(rs))
            sizes.append(rs.cur_size)
        need -= expected_releases_before(ends, sizes, job.est_arrival)
        if need <= 0:
            return
        # candidates: rigid right after an upcoming checkpoint (cheap), then
        # malleables at est_arrival - warning, then any rigid at est_arrival.
        cand: List[Tuple[float, float, int]] = []  # (overhead, preempt_t, jid)
        for rid, rs in ops.running.items():
            j = rs.job
            if j.jtype is JobType.ONDEMAND:
                continue
            if j.jtype is JobType.MALLEABLE:
                t_p = max(ops.now, job.est_arrival - ops.cfg.malleable_warning)
                cand.append((j.t_setup * j.size, t_p, rid))
            else:
                nc = rs.next_ckpt_completion(ops.now)
                if nc is not None and nc <= job.est_arrival:
                    cand.append((j.t_setup * j.size, nc, rid))
                else:
                    t_p = max(ops.now, job.est_arrival - 1.0)
                    lost = rs.work_done(t_p) - rs.checkpointed_work(t_p)
                    cand.append((j.t_setup * j.size + max(lost, 0.0), t_p, rid))
        cand.sort()
        for overhead, t_p, rid in cand:
            if need <= 0:
                break
            rs = ops.running.get(rid)
            if rs is None:
                continue
            ops.push_event(t_p, "planned_preempt", (jid, rid, rs.epoch))
            need -= rs.cur_size


# ------------------------------------------------------------------ arrival
@register_policy("arrival", "PAA")
class PreemptAscendingOverhead(ArrivalPolicy):
    """PAA: preempt running jobs in ascending preemption-overhead order."""

    def acquire(self, ops: SchedulerOps, jid: int, need: int) -> bool:
        return self._paa(ops, jid, need)

    def _paa(self, ops: SchedulerOps, jid: int, need: int) -> bool:
        cand = [(rid, rs) for rid, rs in ops.running.items()
                if rs.job.jtype is not JobType.ONDEMAND]
        # nodes borrowed from other reservations return to their owners, not
        # to this job: only the un-borrowed remainder counts as supply.
        supply = [rs.cur_size - sum(rs.borrowed.values()) for _, rs in cand]
        victims, _ = select_preemption_victims(
            supply, [rs.preemption_overhead(ops.now) for _, rs in cand], need)
        if not victims and need > 0:
            return False
        for i in victims:
            ops.preempt(cand[i][0], beneficiary=jid)
        job = ops.jobs[jid]
        if ops.reserved_of(jid) + ops.free < job.size:
            return False  # borrowed-node routing starved us; wait in queue
        ops.start_od(jid)
        return True


@register_policy("arrival", "SPAA")
class ShrinkThenPreempt(PreemptAscendingOverhead):
    """SPAA: shrink running malleables evenly; fall back to PAA."""

    def acquire(self, ops: SchedulerOps, jid: int, need: int) -> bool:
        if self._try_shrink(ops, jid, need):
            return True
        return self._paa(ops, jid, need)

    def _try_shrink(self, ops: SchedulerOps, jid: int, need: int) -> bool:
        mall = [(rid, rs) for rid, rs in ops.running.items()
                if rs.job.jtype is JobType.MALLEABLE
                and rs.cur_size > rs.job.n_min]
        if not mall:
            return False
        sheds = apportion_shrink([rs.cur_size for _, rs in mall],
                                 [rs.job.n_min for _, rs in mall], need)
        if not sheds:
            return False
        for (rid, _), k in zip(mall, sheds):
            if k > 0:
                ops.shrink(rid, k, jid)
        ops.start_od(jid)
        return True


# -------------------------------------------------------------------- queue
def _fcfs_key(front_get, jobs, jid: int):
    """FCFS with arrived on-demand jobs pinned to the queue front; the one
    definition behind both order_key and the specialized closure."""
    return (0 if front_get(jid) else 1, jobs[jid].submit_time, jid)


@register_policy("queue", "EASY")
class FcfsEasyBackfill(QueuePolicy):
    """FCFS order (arrived on-demand jobs pinned to the front) with EASY
    backfilling behind a blocked head, optionally onto idle reservations."""

    def order_key(self, view: SchedulerView, jid: int):
        return _fcfs_key(view.od_front_map.get, view.jobs, jid)

    def make_order_key(self, view: SchedulerView):
        if type(self).order_key is not FcfsEasyBackfill.order_key:
            # subclass customized the ordering: use the generic wrapper so
            # the override actually takes effect
            return super().make_order_key(view)
        front_get, jobs = view.od_front_map.get, view.jobs
        return lambda jid: _fcfs_key(front_get, jobs, jid)

    def _shadow(self, view: SchedulerView, head: int) -> Tuple[float, int]:
        """EASY reservation for the queue head over estimated releases
        (the vectorized kernel over the incrementally maintained est-end
        arrays — see decision.easy_shadow)."""
        job = view.jobs[head]
        need = job.n_min if job.jtype is JobType.MALLEABLE else job.size
        avail = view.avail_for(head)
        if avail >= need:
            return view.now, avail - need
        bases, sizes = view.est_end_arrays()
        return easy_shadow(avail, need, bases, sizes, view.now)

    def backfill(self, ops: SchedulerOps, head: int) -> None:
        queue = ops.queue
        qlen = len(queue)
        if qlen <= 1:
            return
        allow_borrow = ops.cfg.allow_reserved_backfill
        pool, deadline = ops.borrow_pool() if allow_borrow else (0, math.inf)
        ledger, now = ops.ledger, ops.now
        lo, hi = 1, min(qlen, 1 + ops.cfg.backfill_depth)
        needs_l, ests_l = queue.meta_window(lo, hi)
        bound = ledger.free + pool
        needs = np.asarray(needs_l, dtype=np.float64)
        stage1 = backfill_prefilter(needs, bound)
        hold_book = ledger.job_hold
        if stage1.size == 0 and not hold_book:
            return  # nothing can start: skip the shadow computation too
        t_shadow, extra = self._shadow(ops, head)
        if pool > 0:
            keep = set(map(int, stage1))
        else:
            ests = np.asarray(ests_l, dtype=np.float64)
            keep = set(map(int, backfill_shadow_filter(
                needs, ests, stage1, extra, now, t_shadow)))
        # returned-lease holders see more supply than either bound
        for jid, hold in hold_book.items():
            if jid in queue:
                i = queue.position(jid) - lo
                if 0 <= i < hi - lo and i not in keep \
                        and needs_l[i] <= bound + hold:
                    keep.add(i)
        if not keep:
            return
        cand = [queue[lo + i] for i in sorted(keep)]
        jobs, hold_of = ops.jobs, ops.hold_of
        est_remaining = ops.est_remaining
        for jid in cand:
            job = jobs[jid]
            if job.jtype is JobType.ONDEMAND:
                continue  # arrived ods start only via their own path
            need_min = job.n_min if job.jtype is JobType.MALLEABLE else job.size
            est_run = est_remaining[jid]
            # == borrowable(jid) with the pool scan hoisted out of the loop
            idle_reserved = pool if pool > 0 \
                and ops.borrow_eligible(jid, deadline) else 0
            plain = ledger.free + hold_of(jid)
            total = plain + idle_reserved
            if total < need_min:
                continue
            size = job.size if job.jtype is not JobType.MALLEABLE else \
                min(job.n_max, total)
            from_plain = min(size, plain)
            borrow = size - from_plain
            if job.jtype is JobType.MALLEABLE:
                est_run = job.t_setup + (est_run - job.t_setup) * job.n_max / size
            fits_hole = now + est_run <= t_shadow
            uses_free = max(0, from_plain - hold_of(jid))
            if not fits_hole and uses_free > extra:
                continue
            if not fits_hole:
                extra -= uses_free
            ops.start_backfilled(jid, size, borrow)
            if borrow > 0:  # reservations shrank; re-derive the pool view
                pool, deadline = ops.borrow_pool()


@register_policy("queue", "FCFS")
class FcfsNoBackfill(FcfsEasyBackfill):
    """Strict FCFS: nothing jumps a blocked queue head."""

    def backfill(self, ops: SchedulerOps, head: int) -> None:
        pass


@register_policy("queue", "XFACTOR")
class XFactorEasyBackfill(FcfsEasyBackfill):
    """Expansion-factor aging priority (Maui/Moab XFactor) with EASY
    backfill: rank by (wait + estimate) / estimate, largest first, so
    short jobs age fast and nothing starves.  Arrived on-demand jobs
    stay pinned to the front exactly as under FCFS.

    The key reads the clock, so keys are declared unstable and the
    queue re-sorts with fresh keys every scheduling pass — the
    documented O(n log n)-per-pass regime (docs/performance.md) that
    batched scheduling rounds (``SimConfig.batch_rounds``) exist to
    amortize."""

    order_keys_stable = False

    def order_key(self, view: SchedulerView, jid: int):
        job = view.jobs[jid]
        est = max(job.t_estimate, 1.0)
        xfactor = (view.now - job.submit_time + est) / est
        return (0 if view.od_front_map.get(jid) else 1,
                -xfactor, job.submit_time, jid)


# --------------------------------------------------------------- elasticity
@register_policy("elasticity", "NONE")
class LeaseRepayOnly(ElasticityPolicy):
    """Seed behavior: malleables expand only when a lease is repaid."""


# --------------------------------------------------------------- mechanisms
def _base_bundle(queue: QueuePolicy) -> PolicyBundle:
    """BASE (paper Table II): every job is a plain batch job; the notice
    and arrival policies are inert placeholders."""
    return PolicyBundle(notice=NoNotice(), arrival=PreemptAscendingOverhead(),
                        queue=queue, elasticity=LeaseRepayOnly(),
                        od_aware=False)


register_mechanism("BASE", _base_bundle)
