"""Composable workload/scenario API (mirrors the policy architecture).

    base         WorkloadSource / ScenarioTransform protocols, Scenario,
                 string-keyed source+transform registries
    synthetic    the decomposed Theta-like generator ("theta" source)
    swf          Standard Workload Format trace replay ("swf" source)
    transforms   load_scale / burst_inject / diurnal / notice_mix / type_mix
    presets      named Scenario presets (W1-W5, bursty-od, trace-replay)

See docs/workloads.md for the source/transform contract and a 10-line
custom-source example.
"""
from .base import (Scenario, ScenarioTransform, TraceStats,
                   UnknownWorkloadError, WorkloadDataError, WorkloadSource,
                   canonicalize, get_source, get_transform, register_source,
                   register_transform, registered_sources,
                   registered_transforms, trace_sha256, trace_stats_of)
from .synthetic import (NOTICE_KINDS, NOTICE_MIXES, SIZE_BUCKETS,
                        SIZE_WEIGHTS, ArrivalModel, NoticeModel,
                        ProjectModel, RuntimeModel, SizeModel,
                        ThetaGenerator, WorkloadConfig,
                        assign_project_types, daly_interval, generate,
                        notice_mix, rigid_ckpt_params)
from .swf import SWF_FIELDS, SwfTrace, iter_swf, parse_swf
from .transforms import (BurstInject, DiurnalModulation, LoadScale,
                         NoticeMixOverride, TypeMixReassign)
from .presets import get_scenario, register_scenario, registered_scenarios

__all__ = [
    "Scenario", "ScenarioTransform", "TraceStats", "WorkloadSource",
    "UnknownWorkloadError", "WorkloadDataError",
    "canonicalize", "get_source", "get_transform", "register_source",
    "register_transform", "registered_sources", "registered_transforms",
    "trace_sha256", "trace_stats_of", "iter_swf",
    "NOTICE_KINDS", "NOTICE_MIXES", "SIZE_BUCKETS", "SIZE_WEIGHTS",
    "ArrivalModel", "NoticeModel", "ProjectModel", "RuntimeModel",
    "SizeModel", "ThetaGenerator", "WorkloadConfig",
    "assign_project_types", "daly_interval", "generate", "notice_mix",
    "rigid_ckpt_params",
    "SWF_FIELDS", "SwfTrace", "parse_swf",
    "BurstInject", "DiurnalModulation", "LoadScale", "NoticeMixOverride",
    "TypeMixReassign",
    "get_scenario", "register_scenario", "registered_scenarios",
]
