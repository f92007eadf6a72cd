"""The scheduler of the PyTorch port: a copy of `repro.core`'s numpy engine.

The modules here are copies of the reference's jax-free scheduler, with
only their imports pointing into `repro_torch`:

    job / cluster / decision     job model, node ledger, vectorized kernels
    structures / sketches        the incremental queue, streaming quantiles
    policy + policies/           pluggable scheduling policies + registry
    simulator                    event loop + mechanics (leases, lifecycle)
    workloads/                   pluggable workload sources, SWF replay,
                                 scenario transforms + registry
    metrics                      evaluation metrics
    experiment                   mechanisms x scenarios x seeds sweeps

One module is ported rather than copied: `decision_torch`, the batched
torch replay of a sweep's captured decisions (the reference's
`decision_jax`), which `Experiment(device="torch")` runs on
`sweep_device` (the card unless the caller asks for "cpu").

The registries are the port's own: a policy, workload source, transform
or scenario registered with `repro.core` is not seen here, and one
registered with `repro_torch.core` is not seen by `repro`.  The fault
models a `SimConfig` may name are the port's copy of `repro.faults`,
`repro_torch.faults`.

Public API:
    JobSpec / JobType / NoticeKind / RunState   job model (paper §III-A)
    NodeLedger / Lease                          node accounting
    SimConfig / Simulator / JobRecord           event-driven scheduler (§III-B)
    MECHANISMS                                  the six legacy mechanisms
    register_policy / get_policy / resolve_mechanism / ...
                                                the string-keyed policy registry
    Experiment / ExperimentResult               sweep runner with process fan-out
    WorkloadConfig / generate                   Theta-like trace synthesis (§IV-A)
    WorkloadSource / ScenarioTransform / Scenario
                                                workload protocols
    register_source / register_transform / get_scenario
                                                the string-keyed workload registry
    SwfTrace                                    SWF trace replay with annotation
    Metrics / collect                           evaluation metrics (§IV-D)
    run_mechanism                               one-call simulation entry point
"""
from .job import JobSpec, JobType, NoticeKind, RunState
from .cluster import Lease, NodeLedger
from .decision import (DecisionTrace, apportion_shrink,
                       backfill_prefilter, backfill_shadow_filter,
                       capture, easy_shadow, expected_releases_before,
                       select_preemption_victims)
from .structures import OrderedSet, WaitQueue
from .policy import (ARRIVAL_POLICIES, MECHANISMS, NOTICE_POLICIES,
                     ArrivalPolicy, ElasticityPolicy, NoticePolicy,
                     PolicyBundle, QueuePolicy, SchedulerOps, SchedulerView,
                     UnknownPolicyError, get_policy, register_policy,
                     register_mechanism, registered_mechanisms,
                     registered_policies, resolve_mechanism)
from .simulator import JobRecord, SimConfig, Simulator
from .workloads import (NOTICE_MIXES, Scenario, ScenarioTransform,
                        SwfTrace, ThetaGenerator, TraceStats,
                        UnknownWorkloadError, WorkloadConfig,
                        WorkloadDataError, WorkloadSource, daly_interval,
                        generate, get_scenario, get_source, get_transform,
                        notice_mix, register_scenario, register_source,
                        register_transform, registered_scenarios,
                        registered_sources, registered_transforms,
                        trace_sha256)
from .metrics import (Metrics, StreamingMetrics, collect,
                      summarize_records)
from .experiment import Experiment, ExperimentResult, RunResult, RunSpec


def run_mechanism(mechanism: str, jobs, n_nodes: int, **cfg_kw) -> "Metrics":
    """Simulate `jobs` under one mechanism and return its metrics."""
    sim = Simulator(SimConfig(n_nodes=n_nodes, mechanism=mechanism, **cfg_kw),
                    [j for j in jobs])
    sim.run()
    return collect(sim)


__all__ = [
    "JobSpec", "JobType", "NoticeKind", "RunState", "Lease", "NodeLedger",
    "DecisionTrace", "apportion_shrink", "backfill_prefilter",
    "backfill_shadow_filter", "capture", "easy_shadow",
    "expected_releases_before", "select_preemption_victims",
    "OrderedSet", "WaitQueue",
    "MECHANISMS", "NOTICE_POLICIES", "ARRIVAL_POLICIES",
    "NoticePolicy", "ArrivalPolicy", "QueuePolicy", "ElasticityPolicy",
    "PolicyBundle", "SchedulerView", "SchedulerOps",
    "get_policy", "register_policy", "register_mechanism",
    "registered_policies", "registered_mechanisms", "resolve_mechanism",
    "UnknownPolicyError",
    "JobRecord", "SimConfig", "Simulator",
    "NOTICE_MIXES", "WorkloadConfig", "daly_interval", "generate",
    "notice_mix",
    "WorkloadSource", "ScenarioTransform", "Scenario", "SwfTrace",
    "ThetaGenerator", "TraceStats", "UnknownWorkloadError",
    "WorkloadDataError", "trace_sha256",
    "get_source", "get_transform", "get_scenario",
    "register_source", "register_transform", "register_scenario",
    "registered_sources", "registered_transforms", "registered_scenarios",
    "Metrics", "StreamingMetrics", "collect", "summarize_records",
    "run_mechanism",
    "Experiment", "ExperimentResult", "RunResult", "RunSpec",
]
