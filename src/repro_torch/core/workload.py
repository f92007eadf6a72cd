"""Backward-compat shim: the workload layer is now the
``repro_torch.core.workloads`` package (sources, transforms, scenarios behind a
registry — see docs/workloads.md).  Every name that used to live here
re-exports unchanged; ``generate(cfg)`` still reproduces the pre-split
traces bit-for-bit (golden-tested)."""
from .workloads.synthetic import (NOTICE_KINDS, NOTICE_MIXES, SIZE_BUCKETS,
                                  SIZE_WEIGHTS, ThetaGenerator,
                                  WorkloadConfig, daly_interval, generate,
                                  notice_mix)

__all__ = [
    "NOTICE_KINDS", "NOTICE_MIXES", "SIZE_BUCKETS", "SIZE_WEIGHTS",
    "ThetaGenerator", "WorkloadConfig", "daly_interval", "generate",
    "notice_mix",
]
