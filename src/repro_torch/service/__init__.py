"""repro_torch.service — the scheduler daemon over the policy engine.

A copy of `repro.service` (all but `__main__`, which needs the workload
registry); only the imports point into the port.

A live, policy-driven control plane: the same registered Notice /
Arrival / Queue / Elasticity policies that drive offline simulations
(``repro_torch.core.policy``) schedule real workloads here — on-demand jobs
are inference demand, malleable jobs are elastic training runs — with
decisions appended to a structured JSONL log whose digest must match an
offline Simulator run on the same trace (the shadow-mode contract;
docs/service.md).

Deliberately torch-free at import: shadow mode (ReplayClock +
DryrunLauncher) runs on CPU-only CI; only LiveClusterLauncher touches
the elastic runtime, and only through the cluster object handed to it.
"""
from .admission import (BACKPRESSURE_POLICIES, AdmissionQueue,
                        AdmissionRejected)
from .clock import ReplayClock
from .core import ServiceCore
from .daemon import (FidelityReport, RecoveryReport, SchedulerService,
                     ServiceConfig, ShadowReport, shadow_fidelity)
from .decisionlog import (DIGEST_EXEMPT_EVENTS, MEASUREMENT_KEYS,
                          DecisionLog, TornLogError, decision_digest,
                          log_segments, read_decision_log)
from .launchers import (DryrunLauncher, Launcher, LiveClusterLauncher,
                        NullLauncher, RetryPolicy, RetryingLauncher,
                        ShadowLaunchError, TransientLaunchError,
                        plan_requests)
from .slo import SloMonitor, SloPolicy, SloReport

__all__ = [
    "AdmissionQueue", "AdmissionRejected", "BACKPRESSURE_POLICIES",
    "ReplayClock", "ServiceCore",
    "FidelityReport", "RecoveryReport", "SchedulerService", "ServiceConfig",
    "ShadowReport", "shadow_fidelity",
    "DIGEST_EXEMPT_EVENTS", "MEASUREMENT_KEYS", "DecisionLog",
    "TornLogError", "decision_digest", "log_segments", "read_decision_log",
    "DryrunLauncher", "Launcher", "LiveClusterLauncher", "NullLauncher",
    "RetryPolicy", "RetryingLauncher", "ShadowLaunchError",
    "TransientLaunchError", "plan_requests",
    "SloMonitor", "SloPolicy", "SloReport",
]
