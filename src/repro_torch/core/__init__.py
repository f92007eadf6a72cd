"""The scheduler of the PyTorch port: a copy of `repro.core`'s numpy engine.

The modules here are copies of the reference's jax-free scheduler, with
only their imports pointing into `repro_torch`:

    job / cluster / decision     job model, node ledger, vectorized kernels
    structures / sketches        the incremental queue, streaming quantiles
    policy + policies/           pluggable scheduling policies + registry
    simulator                    event loop + mechanics (leases, lifecycle)

The policy registry is the port's own: a policy registered with
`repro.core.policy.register_policy` is not seen here, and one registered
with `repro_torch.core.policy.register_policy` is not seen by `repro`.
The fault models a `SimConfig` may name are the port's copy of
`repro.faults`, `repro_torch.faults`.  The workload registry, the metrics
and the experiment sweeps come with a later slice (ROADMAP queue 1).

Public API:
    JobSpec / JobType / NoticeKind / RunState   job model (paper §III-A)
    NodeLedger / Lease                          node accounting
    SimConfig / Simulator / JobRecord           event-driven scheduler (§III-B)
    MECHANISMS                                  the six legacy mechanisms
    register_policy / get_policy / resolve_mechanism / ...
                                                the string-keyed policy registry
"""
from .job import JobSpec, JobType, NoticeKind, RunState
from .cluster import Lease, NodeLedger
from .policy import (ARRIVAL_POLICIES, MECHANISMS, NOTICE_POLICIES,
                     ArrivalPolicy, ElasticityPolicy, NoticePolicy,
                     PolicyBundle, QueuePolicy, SchedulerOps, SchedulerView,
                     UnknownPolicyError, get_policy, register_mechanism,
                     register_policy, registered_mechanisms,
                     registered_policies, resolve_mechanism)
from .simulator import JobRecord, SimConfig, Simulator

__all__ = [
    "JobSpec", "JobType", "NoticeKind", "RunState", "Lease", "NodeLedger",
    "MECHANISMS", "NOTICE_POLICIES", "ARRIVAL_POLICIES",
    "NoticePolicy", "ArrivalPolicy", "QueuePolicy", "ElasticityPolicy",
    "PolicyBundle", "SchedulerView", "SchedulerOps",
    "get_policy", "register_policy", "register_mechanism",
    "registered_policies", "registered_mechanisms", "resolve_mechanism",
    "UnknownPolicyError",
    "JobRecord", "SimConfig", "Simulator",
]
