"""Malleable-scheduling algorithms ported from the Wagomu project
(projectwagomu/MalleableJobScheduling, ElastiSim algorithms; EPL-2.0),
adapted to this repo's event-driven hybrid-workload simulator.

Both are :class:`ArrivalPolicy` alternatives to the paper's SPAA: they
decide *which* running malleables shed nodes for an arrived on-demand
job, and pair with the BALANCE elasticity policy so shrunk jobs expand
back into idle nodes — completing the malleability incentive loop.

    STEAL   average-steal agreement: shed one node at a time from the
            malleable with the highest fractional allocation
            (cur - n_min) / (n_max - n_min), driving all malleables
            toward the same average fill level.
    POOL    common-pool preference: each malleable has a preferred size
            halfway between n_min and n_max; jobs furthest above their
            preference shed first, down to pref, then down to n_min.

Unmeetable demand falls back to PAA preemption so on-demand jobs keep
their instant-start guarantee (paper Obs 9).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from ..job import JobSpec, JobType, RunState
from ..policy import (ElasticityPolicy, SchedulerOps, register_policy)
from .builtin import PreemptAscendingOverhead


def fill_fraction(rs: RunState, delta: int = 0) -> float:
    """Fractional allocation of a malleable in [0, 1] after `delta` nodes."""
    span = rs.job.n_max - rs.job.n_min
    if span <= 0:
        return 1.0
    return (rs.cur_size + delta - rs.job.n_min) / span


def preferred_size(job: JobSpec) -> int:
    """POOL's per-job preference: halfway between n_min and n_max."""
    return min(job.n_max, max(job.n_min, (job.n_min + job.n_max + 1) // 2))


def _running_malleables(ops: SchedulerOps) -> List[Tuple[int, RunState]]:
    return [(rid, rs) for rid, rs in ops.running.items()
            if rs.job.jtype is JobType.MALLEABLE]


# ------------------------------------------------------------------ arrival
@register_policy("arrival", "STEAL")
class AverageStealAgreement(PreemptAscendingOverhead):
    """Wagomu average_steal_agreement: steal from the fullest malleable."""

    preferred_elasticity = "BALANCE"

    def acquire(self, ops: SchedulerOps, jid: int, need: int) -> bool:
        sheds = self._select_sheds(ops, need)
        if sheds is None:
            return self._paa(ops, jid, need)
        for rid, k in sheds:
            ops.shrink(rid, k, jid)
        ops.start_od(jid)
        return True

    def _select_sheds(self, ops: SchedulerOps,
                      need: int) -> Optional[List[Tuple[int, int]]]:
        """One node per round from the malleable with the highest fill
        fraction; None if the combined slack cannot cover `need`.

        Heap keyed on (-fill, arrival order) so each round is O(log m)
        with the same winner (ties to the first malleable) as a full
        max() scan."""
        mall = [(rid, rs) for rid, rs in _running_malleables(ops)
                if rs.cur_size > rs.job.n_min]
        if sum(rs.cur_size - rs.job.n_min for _, rs in mall) < need:
            return None
        shed: Dict[int, int] = {rid: 0 for rid, _ in mall}
        heap = [(-fill_fraction(rs), i) for i, (_, rs) in enumerate(mall)]
        heapq.heapify(heap)
        for _ in range(need):
            _, i = heapq.heappop(heap)
            rid, rs = mall[i]
            shed[rid] += 1
            if rs.cur_size - shed[rid] > rs.job.n_min:
                heapq.heappush(heap, (-fill_fraction(rs, -shed[rid]), i))
        return [(rid, k) for rid, k in shed.items() if k > 0]


@register_policy("arrival", "POOL")
class CommonPoolPreference(PreemptAscendingOverhead):
    """Wagomu pref_common_pool: shed above-preference allocations first."""

    preferred_elasticity = "BALANCE"

    def acquire(self, ops: SchedulerOps, jid: int, need: int) -> bool:
        sheds = (self._select_sheds(ops, need,
                                    lambda j: preferred_size(j))
                 or self._select_sheds(ops, need, lambda j: j.n_min))
        if not sheds:
            return self._paa(ops, jid, need)
        for rid, k in sheds:
            ops.shrink(rid, k, jid)
        ops.start_od(jid)
        return True

    def _select_sheds(self, ops: SchedulerOps, need: int,
                      floor) -> Optional[List[Tuple[int, int]]]:
        """Take nodes above `floor(job)` from the jobs furthest above
        their preferred size; None unless `need` is covered exactly."""
        mall = _running_malleables(ops)
        mall.sort(key=lambda it: it[1].cur_size - preferred_size(it[1].job),
                  reverse=True)
        sheds: List[Tuple[int, int]] = []
        left = need
        for rid, rs in mall:
            if left <= 0:
                break
            k = min(left, rs.cur_size - floor(rs.job))
            if k > 0:
                sheds.append((rid, k))
                left -= k
        return sheds if left <= 0 else None


# --------------------------------------------------------------- elasticity
@register_policy("elasticity", "BALANCE")
class AverageBalance(ElasticityPolicy):
    """Expand the emptiest malleables back toward n_max whenever nodes go
    spare and nothing is waiting (Wagomu expand_running_malleable_jobs)."""

    def absorb_release(self, ops: SchedulerOps, k: int) -> int:
        if ops.queue:  # never hoard nodes while jobs wait
            return k
        for rid, grow in self._apportion(ops, k):
            ops.expand_occupied(rid, grow)
            k -= grow
        return k

    def on_idle(self, ops: SchedulerOps) -> None:
        if ops.queue or ops.free <= 0:
            return
        for rid, grow in self._apportion(ops, ops.free):
            ops.expand_from_free(rid, grow)

    def _apportion(self, ops: SchedulerOps,
                   k: int) -> List[Tuple[int, int]]:
        """Hand nodes one at a time to the malleable with the lowest fill
        fraction until supply or expandability runs out.

        Heap keyed on (fill, arrival order): O(log m) per node with the
        same winner (ties to the first malleable) as a full min() scan."""
        mall = [(rid, rs) for rid, rs in _running_malleables(ops)
                if rs.cur_size < rs.job.n_max]
        grow: Dict[int, int] = {rid: 0 for rid, _ in mall}
        heap = [(fill_fraction(rs), i) for i, (_, rs) in enumerate(mall)]
        heapq.heapify(heap)
        while k > 0 and heap:
            _, i = heapq.heappop(heap)
            rid, rs = mall[i]
            grow[rid] += 1
            k -= 1
            if rs.cur_size + grow[rid] < rs.job.n_max:
                heapq.heappush(heap, (fill_fraction(rs, grow[rid]), i))
        return [(rid, g) for rid, g in grow.items() if g > 0]
