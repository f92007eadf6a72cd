"""Pluggable scheduling-policy API (paper §III-B, generalized).

The paper's six mechanisms are {notice} x {arrival} strategy pairs; this
module turns each axis into a small protocol class so new strategies are
*data* (registry entries) rather than forks of the event loop:

    NoticePolicy      what happens when an on-demand job sends advance
                      notice: reserve idle nodes, collect releases, plan
                      preemptions against the estimated arrival (N/CUA/CUP)
    ArrivalPolicy     how an *arrived* on-demand job acquires the nodes it
                      is short of: preemption orderings, shrink apportioning
                      (PAA/SPAA, plus third-party algorithms such as
                      STEAL/POOL from the Wagomu malleable-scheduling work)
    QueuePolicy       ordering of the wait queue and the backfill pass
                      (FCFS + EASY backfilling by default)
    ElasticityPolicy  when running malleable jobs absorb vacated or idle
                      nodes and expand back toward n_max (the paper's
                      malleability incentive); the seed behavior expands
                      only via lease repayment

Policies act through two layered handles:

    SchedulerView     read-only window onto simulator state (clock, ledger
                      pools, queue, running set, estimates)
    SchedulerOps      the view plus the small set of mutation primitives a
                      policy may invoke (preempt, shrink, expand, start,
                      reserve, push_event)

A string-keyed registry maps policy names and mechanism strings to policy
objects.  Legacy strings ("BASE", "CUA&SPAA", ...) resolve to bundles that
reproduce the pre-refactor simulator bit-for-bit; any "<notice>&<arrival>"
combination of registered policies (e.g. "CUA&STEAL") resolves without
touching the core.

Registering a custom policy::

    from repro_torch.core.job import JobType
    from repro_torch.core.policy import ArrivalPolicy, register_policy

    @register_policy("arrival", "GREEDY")
    class GreedyArrival(ArrivalPolicy):
        def acquire(self, ops, jid, need):
            for rid, rs in list(ops.running.items()):
                if need <= 0:
                    break
                if rs.job.jtype is JobType.ONDEMAND:
                    continue        # on-demand jobs are never preempted
                need -= rs.cur_size
                ops.preempt(rid, beneficiary=jid)
            if ops.reserved_of(jid) + ops.free < ops.jobs[jid].size:
                return False        # demand unmet: job queues at the front
            ops.start_od(jid)
            return True

    # SimConfig(mechanism="CUA&GREEDY") now works everywhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import numpy as np

from .job import JobType

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .structures import OrderedSet, WaitQueue

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from .job import JobSpec, RunState
    from .simulator import Simulator

# Legacy mechanism axes (paper §III-B); kept as public constants.
NOTICE_POLICIES = ("N", "CUA", "CUP")
ARRIVAL_POLICIES = ("PAA", "SPAA")
MECHANISMS = tuple(f"{n}&{a}" for n in NOTICE_POLICIES for a in ARRIVAL_POLICIES)


# --------------------------------------------------------------- state views
class SchedulerView:
    """Read-only window onto a running :class:`Simulator`.

    Exposes exactly the state a scheduling decision may consult; mutating
    the returned containers is not supported.  Stable containers and query
    methods are bound once at construction (the simulator mutates them in
    place), so policy hot loops pay no delegation frames:

        jobs           jid -> JobSpec for every job in the trace
        running        jid -> RunState of running jobs
        queue          waiting jids (a WaitQueue, kept in order-key order;
                       supports the legacy list surface: indexing, slices,
                       iteration, ``in``, ``len``)
        collecting     od jids collecting node releases, notice order
        od_status      od jid -> "noticed"|"arrived"|"timeout"|"done"
        est_remaining  jid -> current user-estimate of remaining runtime
        od_front_map   od jid -> True while pinned to the queue front
        ledger         the NodeLedger (read-only: never call its mutators)
        cfg            the SimConfig
        reserved_of(od) / hold_of(jid)    idle-pool sizes per job
        avail_for(jid)    nodes the job could start on now (free+hold+own)
        borrowable(jid)   idle reserved nodes the job may borrow (§III-B1)
        borrow_pool()     the borrow supply as (pool, earliest owner
                          arrival); borrow_eligible(jid, deadline) is the
                          per-job §III-B1 rule — together they are
                          borrowable(), hoistable to once per pass
        est_end(rs)       estimated end used by EASY/CUP (user estimate)
        est_end_arrays()  (est-end bases, sizes) numpy arrays over the
                          running set, maintained incrementally — feed
                          them to decision.easy_shadow

    `now` and `free` change every event and are properties, as are the
    fault-axis counters `down` / `draining` and the active `fault_model`
    name (repro.faults; all zero/"none" on a perfect machine).

    **Round-awareness contract** (``SimConfig.batch_rounds``, exposed as
    :attr:`batch_rounds`): with batch scheduling rounds enabled the
    simulator calls queue/elasticity hooks once per round boundary, not
    once per event — everything that arrived, completed, or sent notice
    since the previous pass is visible *at once*.  Policies that honor
    the contract need no changes; concretely they must

    * read the clock from ``view.now`` at the pass (it is the round
      boundary, by construction >= every batched event's time), never
      cache it across passes;
    * treat the queue as a set that may have grown by many jobs since
      the last pass (the builtin EASY backfill already scans a
      ``backfill_depth`` window per pass, so its per-pass cost was
      always O(window), not O(events));
    * accept that ``order_keys_stable`` caching spans rounds exactly as
      it spans events — invalidation points are unchanged;
    * never assume a pass follows each arrival: only *on-demand*
      arrivals force an immediate pass (the Obs-10 path); batch-job
      starts may be up to one round stale.  Notice/arrival policies are
      NOT round-deferred — ``on_notice`` and ``acquire`` stay per-event.
    """

    def __init__(self, sim: "Simulator"):
        self._sim = sim
        self.cfg = sim.cfg
        self.jobs: Dict[int, "JobSpec"] = sim.jobs
        self.running: Dict[int, "RunState"] = sim.running
        self.queue: "WaitQueue" = sim.queue
        self.collecting: "OrderedSet" = sim.collecting
        self.od_status: Dict[int, str] = sim.od_status
        self.est_remaining: Dict[int, float] = sim.est_remaining
        self.od_front_map: Dict[int, bool] = sim.od_front
        self.ledger = sim.ledger             # read-only by convention
        self.reserved_of = sim.ledger.reserved_of
        self.hold_of = sim.ledger.hold_of
        self.avail_for = sim._avail_for
        self.borrowable = sim._borrowable
        self.borrow_pool = sim._borrow_pool
        self.borrow_eligible = sim._borrow_eligible
        self.est_end = sim._est_end

    @property
    def now(self) -> float:
        return self._sim.now

    @property
    def free(self) -> int:
        return self._sim.ledger.free

    @property
    def down(self) -> int:
        """Failed nodes awaiting repair (repro.faults)."""
        return self._sim.ledger.down

    @property
    def draining(self) -> int:
        """Quarantined nodes (service launch-failure handling)."""
        return self._sim.ledger.draining

    @property
    def fault_model(self) -> str:
        """Active fault-model name; "none" on a perfect machine."""
        return self._sim.fault_model_name

    @property
    def batch_rounds(self) -> float:
        """Scheduling-round interval in seconds; 0 on the per-event
        engine.  A policy may use it as its staleness bound: queue state
        observed during a pass is at most this many sim-seconds old
        (see the round-awareness contract in the class docstring)."""
        return self._sim.cfg.batch_rounds

    def od_front(self, jid: int) -> bool:
        return bool(self.od_front_map.get(jid))

    def est_end_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-running-job (est-end base, cur_size) arrays for the EASY
        shadow kernel.  The bases are the un-clamped ``est_end`` values
        (clamp to ``now`` is part of :func:`~repro_torch.core.decision.easy_shadow`),
        cached by the simulator at the END-reschedule events where they
        can change, so no per-job ``est_end()`` recomputation happens
        here — only an O(running) materialization of the cache into the
        two arrays (the running set is machine-bounded and small)."""
        cache = self._sim._estend_cache
        if not cache:
            return (np.empty(0, dtype=np.float64),
                    np.empty(0, dtype=np.int64))
        bases, sizes = zip(*cache.values())
        return (np.asarray(bases, dtype=np.float64),
                np.asarray(sizes, dtype=np.int64))


class SchedulerOps(SchedulerView):
    """A :class:`SchedulerView` plus the mutation primitives policies use.

    Every mutator is a simulator primitive that keeps the node ledger,
    lease book, and event heap consistent — policies decide *what* to do,
    never touch accounting directly:

        push_event(t, kind, data)      schedule a simulator event
        invalidate_order_key(jid)      recompute a queued job's cached
                                       order key (incremental queues;
                                       no-op for non-members)
        reserve_from_free(od, want)    move free nodes into od's reservation
        collect(od)                    enroll od to collect future releases
        preempt(jid, beneficiary=od)   vacate a running job; nodes route to
                                       the beneficiary's reservation
        shrink(jid, k, od)             shed k malleable nodes into od's
                                       reservation (creates a lease)
        expand_occupied(jid, k)        grow a malleable by k vacated nodes
        expand_from_free(jid, k)       grow a malleable from the free pool
        start_od(jid)                  launch an arrived on-demand job
        start_backfilled(jid, size, borrow)
                                       launch a batch job out of FCFS order,
                                       `borrow` of it on idle reservations
    """

    def __init__(self, sim: "Simulator"):
        super().__init__(sim)
        self.push_event = sim._push
        self.invalidate_order_key = sim.queue.invalidate
        self.reserve_from_free = sim.ledger.reserve_from_free
        self.expand_occupied = sim._expand
        self.expand_from_free = sim._expand_from_free
        self.start_od = sim._start_od
        self.start_backfilled = sim._start_backfilled

    def collect(self, od: int) -> None:
        """Enroll an on-demand job to collect future node releases."""
        if od not in self.collecting:
            self.collecting.append(od)

    def preempt(self, jid: int, beneficiary: Optional[int] = None) -> None:
        """Vacate a running batch job.  On-demand jobs are never preempted
        (paper §III-B): the ledger mechanics assume an od restarts from its
        reservation + free pool only, so this guard turns a policy bug that
        would corrupt accounting much later into an immediate error."""
        if self.jobs[jid].jtype is JobType.ONDEMAND:
            raise ValueError(f"policy tried to preempt on-demand job {jid}; "
                             "on-demand jobs are never preempted")
        self._sim._preempt(jid, beneficiary=beneficiary)

    def shrink(self, jid: int, k: int, od: int) -> None:
        """Shed k nodes from a running *malleable* into od's reservation."""
        if self.jobs[jid].jtype is not JobType.MALLEABLE:
            raise ValueError(f"policy tried to shrink non-malleable job {jid}")
        self._sim._shrink(jid, k, od)


# ------------------------------------------------------------ policy protocols
class Policy:
    """Base for all policy kinds; `kind`/`name` are set by the registry."""

    kind: str = "?"
    name: str = "?"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.kind}:{self.name}>"


class NoticePolicy(Policy):
    """Reaction to an on-demand job's advance notice (paper §III-B2)."""

    kind = "notice"

    def on_notice(self, ops: SchedulerOps, jid: int) -> None:
        raise NotImplementedError


class ArrivalPolicy(Policy):
    """Node acquisition for an arrived on-demand job that is `need` short.

    `acquire` must either start the job (via `ops.start_od`) and return
    True, or return False — the simulator then queues the job at the front
    where it collects every release until its demand is met.
    """

    kind = "arrival"
    #: elasticity policy a "<notice>&<arrival>" mechanism string pairs with
    preferred_elasticity: str = "NONE"

    def acquire(self, ops: SchedulerOps, jid: int, need: int) -> bool:
        raise NotImplementedError


class QueuePolicy(Policy):
    """Wait-queue ordering and the backfill pass behind a blocked head."""

    kind = "queue"

    #: Incremental-queue contract (docs/performance.md): True promises a
    #: queued job's order key is constant except at requeue and at the
    #: explicitly announced invalidation points (the simulator's od-front
    #: pinning; a custom policy's ``ops.invalidate_order_key`` calls), so
    #: the simulator may cache keys and keep the queue sorted in O(log n)
    #: per operation.  Set False for keys that read clock- or load-
    #: dependent state — the queue then re-sorts with fresh keys every
    #: scheduling pass (the legacy O(n log n) behavior).
    order_keys_stable: bool = True

    def order_key(self, view: SchedulerView, jid: int):
        raise NotImplementedError

    def make_order_key(self, view: SchedulerView) -> Callable[[int], tuple]:
        """Build the order-key callable the wait queue caches per member
        (or, for ``order_keys_stable = False`` policies, calls afresh on
        every pass).

        The default wraps :meth:`order_key`; hot-path policies may return
        a specialized closure instead.
        """
        return lambda jid: self.order_key(view, jid)

    def backfill(self, ops: SchedulerOps, head: int) -> None:
        raise NotImplementedError


class ElasticityPolicy(Policy):
    """When running malleable jobs expand back toward n_max.

    Lease repayment (a shrunk lender reclaiming its nodes when the
    on-demand borrower completes, paper §III-B3) is core mechanics and
    always happens; these hooks add *extra* expansion opportunities.
    """

    kind = "elasticity"

    def absorb_release(self, ops: SchedulerOps, k: int) -> int:
        """Offered k vacated nodes nobody is waiting for; expand running
        malleables into them and return the leftover count."""
        return k

    def on_idle(self, ops: SchedulerOps) -> None:
        """Called after a scheduling pass; may expand malleables into the
        free pool when no job is waiting."""


# ------------------------------------------------------------------ registry
class UnknownPolicyError(ValueError):
    """A mechanism or policy name that is not in the registry.

    ValueError subclass for backward compatibility; Experiment relies on
    the distinct type to tell registry misses in spawn-start workers apart
    from genuine simulation errors."""


_REGISTRY: Dict[str, Dict[str, type]] = {
    "notice": {}, "arrival": {}, "queue": {}, "elasticity": {},
}
_MECHANISM_FACTORIES: Dict[str, Callable[[QueuePolicy], "PolicyBundle"]] = {}


def register_policy(kind: str, name: str):
    """Class decorator: `@register_policy("arrival", "STEAL")`."""
    if kind not in _REGISTRY:
        raise ValueError(f"unknown policy kind {kind!r}; "
                         f"one of {sorted(_REGISTRY)}")

    def deco(cls):
        cls.kind, cls.name = kind, name
        _REGISTRY[kind][name] = cls
        return cls
    return deco


def get_policy(kind: str, name: str) -> Policy:
    """Instantiate a registered policy by kind and name."""
    _ensure_builtins()
    try:
        return _REGISTRY[kind][name]()
    except KeyError:
        raise UnknownPolicyError(
            f"unknown {kind} policy {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY[kind]))}") from None


def registered_policies(kind: str) -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY[kind]))


def register_mechanism(name: str,
                       factory: Callable[[QueuePolicy], "PolicyBundle"]):
    """Map a mechanism string to a bundle factory (takes the queue policy)."""
    _MECHANISM_FACTORIES[name] = factory
    return factory


def registered_mechanisms() -> Tuple[str, ...]:
    """Every resolvable mechanism string: explicit registrations plus all
    <notice>&<arrival> combinations of registered policies."""
    _ensure_builtins()
    combos = {f"{n}&{a}" for n in _REGISTRY["notice"]
              for a in _REGISTRY["arrival"]}
    return tuple(sorted(combos | set(_MECHANISM_FACTORIES)))


@dataclass
class PolicyBundle:
    """The four policies one simulation runs with."""

    notice: NoticePolicy
    arrival: ArrivalPolicy
    queue: QueuePolicy
    elasticity: ElasticityPolicy
    #: False for "BASE": on-demand jobs are plain batch jobs (no notice
    #: handling, no instant-start arrival path).
    od_aware: bool = True


def resolve_mechanism(name: str, queue_policy: str = "EASY") -> PolicyBundle:
    """Resolve a mechanism string to a :class:`PolicyBundle`.

    Explicit registrations ("BASE") win; otherwise "<notice>&<arrival>"
    is parsed against the policy registry, pairing the arrival policy's
    preferred elasticity.  Raises ValueError naming every registered
    mechanism when the string resolves to nothing.
    """
    _ensure_builtins()
    queue = get_policy("queue", queue_policy)
    factory = _MECHANISM_FACTORIES.get(name)
    if factory is not None:
        return factory(queue)
    if "&" in name:
        n_name, a_name = name.split("&", 1)
        if n_name in _REGISTRY["notice"] and a_name in _REGISTRY["arrival"]:
            arrival = _REGISTRY["arrival"][a_name]()
            elasticity = get_policy("elasticity", arrival.preferred_elasticity)
            return PolicyBundle(notice=_REGISTRY["notice"][n_name](),
                                arrival=arrival, queue=queue,
                                elasticity=elasticity)
    raise UnknownPolicyError(
        f"unknown mechanism {name!r}; registered mechanisms: "
        f"{', '.join(registered_mechanisms())}")


def _ensure_builtins() -> None:
    """Import the builtin policy package exactly once (registration side
    effect); deferred to avoid a circular import at module load."""
    from . import policies  # noqa: F401
