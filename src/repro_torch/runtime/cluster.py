"""LiveCluster: the paper's mechanisms driving REAL PyTorch jobs.

A copy of `repro.runtime.cluster`; only the imports point into the port.

Where `repro_torch.core.Simulator` advances a clock over a trace, LiveCluster
applies the same *registered* policies to actual ElasticJobs training on
actual devices, and serves actual on-demand inference on the nodes it
vacates.  This is the integration point that makes the paper's scheduler
a first-class feature of the framework rather than a standalone
simulator.

Policies are resolved from the `repro_torch.core.policy` registry by name —
any registered :class:`~repro_torch.core.policy.ArrivalPolicy` (SPAA, PAA,
STEAL, POOL, or a user-registered one) decides which running jobs shed
nodes when on-demand demand arrives, and any
:class:`~repro_torch.core.policy.ElasticityPolicy` (NONE, BALANCE) decides how
malleables expand back into spare nodes.  The policies act through a
duck-typed adapter (:class:`_LiveOps`) exposing the SchedulerOps subset
they consult, so the identical policy code drives both the simulator's
node ledger and this cluster's real device lists.  An unknown name
raises :class:`~repro_torch.core.policy.UnknownPolicyError` at construction.

Node = one device slot (`torch.device`; the slots may all name one card,
or all the CPU in the tests; on a real cluster a node is a chip group and
the device lists come from the launcher).  Event-log timestamps are monotonic seconds since cluster
construction (never wall clock — they feed latency summaries);
``started_wall`` keeps the single wall-clock anchor for humans.

This module imports no torch: `ElasticJob` is a type-only import, so
shadow-mode tests can drive LiveCluster with duck-typed fakes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from repro_torch.core.job import JobType
from repro_torch.core.policy import ArrivalPolicy, ElasticityPolicy, get_policy

if TYPE_CHECKING:  # torch-free at runtime
    from .elastic import ElasticJob

_KIND_TO_JTYPE = {"rigid": JobType.RIGID, "malleable": JobType.MALLEABLE}


@dataclass
class LiveJobInfo:
    job: "ElasticJob"
    min_nodes: int
    max_nodes: int
    node_ids: List[int] = field(default_factory=list)
    status: str = "waiting"       # waiting|running|preempted|done
    steps_done: int = 0
    target_steps: int = 100
    preempt_count: int = 0
    shrink_count: int = 0


class _LiveSpec:
    """The JobSpec fields policies consult, projected from live state."""

    __slots__ = ("jid", "jtype", "n_min", "n_max", "size", "t_setup")

    def __init__(self, jid: int, jtype: JobType, n_min: int, n_max: int,
                 t_setup: float = 0.0):
        self.jid = jid
        self.jtype = jtype
        self.n_min = n_min
        self.n_max = n_max
        self.size = n_max
        self.t_setup = t_setup


class _LiveRunState:
    """RunState facade over a running :class:`LiveJobInfo`."""

    __slots__ = ("info", "job", "borrowed")

    def __init__(self, info: LiveJobInfo):
        self.info = info
        self.job = _LiveSpec(info.job.jid, _KIND_TO_JTYPE[info.job.kind],
                             info.min_nodes, info.max_nodes)
        self.borrowed: Dict[int, int] = {}   # live jobs never backfill

    @property
    def cur_size(self) -> int:
        return len(self.info.node_ids)

    def preemption_overhead(self, now: float) -> float:
        """Steps lost since the last periodic checkpoint, node-weighted
        (rigid), plus the restart cost proxy — the live analogue of the
        simulator's node-second overhead that PAA sorts victims by."""
        info = self.info
        n = len(info.node_ids)
        lost = (info.steps_done % info.job.ckpt_every) \
            if info.job.kind == "rigid" else 0
        return lost * n + n


class _LiveOps:
    """Duck-typed SchedulerOps subset adapting registered arrival and
    elasticity policies onto LiveCluster state.

    The mutators move *real node ids*: ``preempt``/``shrink`` push the
    vacated ids into the pending on-demand reservation, ``start_od``
    hands the reservation (topped up from the free pool) to the
    acquisition in progress, and the expand hooks grow running jobs out
    of a released-node pool or the free pool.  One adapter is built per
    policy invocation — live clusters run tens of jobs, not thousands.
    """

    def __init__(self, cluster: "LiveCluster", od_jid: int = -1,
                 od_size: int = 0, pool: Optional[List[int]] = None):
        self.cluster = cluster
        self._od_jid = od_jid
        self._pool = pool if pool is not None else []
        self._reserved: List[int] = []
        self.acquired: Optional[List[int]] = None
        self.jobs: Dict[int, _LiveSpec] = {
            od_jid: _LiveSpec(od_jid, JobType.ONDEMAND, od_size, od_size)}
        self.running: Dict[int, _LiveRunState] = {}
        for jid, info in cluster.jobs.items():
            if info.status == "running":
                rs = _LiveRunState(info)
                self.running[jid] = rs
                self.jobs[jid] = rs.job

    # ------------------------------------------------------------------ views
    @property
    def now(self) -> float:
        return self.cluster.elapsed()

    @property
    def free(self) -> int:
        return len(self.cluster.free)

    @property
    def queue(self) -> List[int]:
        return [jid for jid, info in self.cluster.jobs.items()
                if info.status in ("waiting", "preempted")]

    def reserved_of(self, jid: int) -> int:
        return len(self._reserved) if jid == self._od_jid else 0

    # --------------------------------------------------------------- mutators
    def preempt(self, rid: int, beneficiary: Optional[int] = None) -> None:
        self._reserved += self.cluster._preempt(rid)

    def shrink(self, rid: int, k: int, od: int) -> None:
        self._reserved += self.cluster._shrink(rid, k)

    def start_od(self, jid: int) -> None:
        total = self.jobs[jid].size
        take = min(len(self._reserved), total)
        ids, surplus = self._reserved[:take], self._reserved[take:]
        self.cluster.free.extend(surplus)     # over-vacated: back to the pool
        self._reserved = []
        ids += [self.cluster.free.pop() for _ in range(total - take)]
        self.acquired = ids

    def expand_occupied(self, rid: int, k: int) -> None:
        k = min(k, len(self._pool))
        if k > 0:
            self.cluster._expand(rid, [self._pool.pop() for _ in range(k)])

    def expand_from_free(self, rid: int, k: int) -> int:
        info = self.cluster.jobs[rid]
        k = min(k, len(self.cluster.free),
                info.max_nodes - len(info.node_ids))
        if k <= 0:
            return 0
        self.cluster._expand(rid, [self.cluster.free.pop()
                                   for _ in range(k)])
        return k


class LiveCluster:
    """A pool of device-backed nodes scheduled by registry policies.

    ``arrival_policy`` / ``elasticity_policy`` name registered policies;
    ``elasticity_policy=None`` pairs the arrival policy's preferred
    elasticity exactly as ``resolve_mechanism`` does (SPAA/PAA -> NONE,
    STEAL/POOL -> BALANCE), so the demo default (SPAA) behaves as it
    always has.
    """

    def __init__(self, devices: Sequence, arrival_policy: str = "SPAA",
                 elasticity_policy: Optional[str] = None):
        self.devices = list(devices)
        self.free: List[int] = list(range(len(self.devices)))
        self.jobs: Dict[int, LiveJobInfo] = {}
        arrival = get_policy("arrival", arrival_policy)
        assert isinstance(arrival, ArrivalPolicy)
        if elasticity_policy is None:
            elasticity_policy = arrival.preferred_elasticity
        elasticity = get_policy("elasticity", elasticity_policy)
        assert isinstance(elasticity, ElasticityPolicy)
        self.arrival = arrival
        self.elasticity = elasticity
        self._lease_book: Dict[int, int] = {}   # lender jid -> nodes owed
        self._od_count = 0
        self.log: List[dict] = []
        self.started_wall = time.time()         # the one wall-clock anchor
        self._t0 = time.monotonic()

    @property
    def arrival_policy(self) -> str:
        return self.arrival.name

    @property
    def elasticity_policy(self) -> str:
        return self.elasticity.name

    def elapsed(self) -> float:
        """Monotonic seconds since construction (the event-log clock)."""
        return time.monotonic() - self._t0

    # ------------------------------------------------------------- lifecycle
    def submit(self, job: "ElasticJob", *, min_nodes: int, max_nodes: int,
               target_steps: int = 100) -> LiveJobInfo:
        info = LiveJobInfo(job=job, min_nodes=min_nodes, max_nodes=max_nodes,
                           target_steps=target_steps)
        self.jobs[job.jid] = info
        self._try_start(info)
        return info

    def _try_start(self, info: LiveJobInfo) -> bool:
        want = min(info.max_nodes, len(self.free))
        if want < info.min_nodes or \
                (info.job.kind == "rigid" and want < info.max_nodes):
            return False
        ids = [self.free.pop() for _ in range(
            info.max_nodes if info.job.kind == "rigid" else want)]
        info.node_ids = ids
        devs = [self.devices[i] for i in ids]
        if info.job.state is None and info.job.step_idx == 0:
            info.job.start(devs)
        elif info.status == "preempted" and info.job.ckpt_dir:
            info.job.resume(devs)
        else:
            info.job.start(devs)
        info.status = "running"
        self._log("start", info.job.jid, nodes=len(ids))
        return True

    def step_all(self, n: int = 1) -> None:
        """Round-robin n train steps on every running job."""
        for _ in range(n):
            for info in self.jobs.values():
                if info.status == "running":
                    info.job.step()
                    info.steps_done += 1
                    if info.steps_done >= info.target_steps:
                        self._finish(info)

    def _finish(self, info: LiveJobInfo) -> None:
        info.status = "done"
        self.free.extend(info.node_ids)
        info.node_ids = []
        self._lease_book.pop(info.job.jid, None)
        self._log("finish", info.job.jid)
        self._restart_waiting()

    def _restart_waiting(self) -> None:
        for info in self.jobs.values():
            if info.status in ("waiting", "preempted"):
                self._try_start(info)
        self._on_idle()

    # ------------------------------------------- policy-facing primitives
    def _preempt(self, jid: int) -> List[int]:
        info = self.jobs[jid]
        info.job.preempt(warning=info.job.kind == "malleable")
        info.status = "preempted"
        info.preempt_count += 1
        ids, info.node_ids = info.node_ids, []
        self._log("preempt", jid)
        return ids

    def _shrink(self, jid: int, k: int) -> List[int]:
        info = self.jobs[jid]
        keep, shed = info.node_ids[:-k], info.node_ids[-k:]
        info.node_ids = keep
        info.shrink_count += 1
        cost = info.job.resize([self.devices[i] for i in keep])
        self._lease_book[jid] = self._lease_book.get(jid, 0) + k
        self._log("shrink", jid, shed=k, reshard_s=round(cost, 3))
        return shed

    def _expand(self, jid: int, ids: List[int]) -> None:
        info = self.jobs[jid]
        info.node_ids = info.node_ids + ids
        cost = info.job.resize([self.devices[i] for i in info.node_ids])
        self._log("expand", jid, grow=len(ids), reshard_s=round(cost, 3))

    # ---------------------------------------------------- on-demand arrival
    def acquire_for_ondemand(self, need: int) -> List[int]:
        """Vacate `need` nodes via the configured arrival policy (paper
        §III-B2) and return their ids.  Raises RuntimeError when the
        policy cannot meet the demand (nothing is mutated in that case:
        a failed acquire found no victims to touch)."""
        if not (0 < need <= len(self.devices)):
            raise ValueError(f"cannot acquire {need} of "
                             f"{len(self.devices)} nodes")
        self._od_count += 1
        od_jid = -self._od_count          # below any real jid
        if need <= len(self.free):
            got = [self.free.pop() for _ in range(need)]
            self._log("od_acquire", od_jid, source="free", nodes=need)
            return got
        ops = _LiveOps(self, od_jid, need)
        if not self.arrival.acquire(ops, od_jid, need - len(self.free)) \
                or ops.acquired is None:
            raise RuntimeError(
                f"cannot vacate {need} nodes "
                f"(arrival policy {self.arrival.name})")
        self._log("od_acquire", od_jid, source=self.arrival.name, nodes=need)
        return ops.acquired

    def release_ondemand(self, node_ids: List[int]) -> None:
        """On-demand completion: lease repayment first (shrunk lenders
        reclaim their nodes, paper §III-B3 — core mechanics, independent
        of policy), then the elasticity policy absorbs the remainder,
        then the free pool / waiting jobs."""
        pool = list(node_ids)
        for jid in list(self._lease_book):
            if not pool:
                break
            info = self.jobs.get(jid)
            if info is None or info.status != "running":
                del self._lease_book[jid]
                continue
            grow = min(self._lease_book[jid], len(pool),
                       info.max_nodes - len(info.node_ids))
            if grow > 0:
                self._expand(jid, [pool.pop() for _ in range(grow)])
            if self._lease_book[jid] - grow > 0:
                self._lease_book[jid] -= grow
            else:
                del self._lease_book[jid]
        if pool:
            ops = _LiveOps(self, pool=pool)
            self.elasticity.absorb_release(ops, len(pool))
            self.free.extend(pool)        # whatever absorb left behind
            pool = []
        self._restart_waiting()

    def _on_idle(self) -> None:
        """Post-scheduling elasticity hook: BALANCE-style policies grow
        running malleables into genuinely spare nodes."""
        if self.free:
            self.elasticity.on_idle(_LiveOps(self))

    def _log(self, event: str, jid: int, **kw) -> None:
        self.log.append({"t": round(self.elapsed(), 6),
                         "event": event, "jid": jid, **kw})

    def utilization(self) -> float:
        used = sum(len(i.node_ids) for i in self.jobs.values()
                   if i.status == "running")
        return used / len(self.devices)
