"""Cross-trace robustness campaigns (docs/campaigns.md).

The subsystem that answers "which mechanism wins under which regime"
over *real* traces, end to end and offline-first:

  * :mod:`repro_torch.campaign.zoo` — named traces with provenance (checked-in
    fixtures + Parallel Workloads Archive entries), sha256-verified,
    cached locally;
  * :mod:`repro_torch.campaign.calibrate` — per-trace knobs (target offered
    load, type fractions, notice mix) expressed through the existing
    registered sources/transforms so every cell replays through the
    unchanged streaming Scenario path;
  * :mod:`repro_torch.campaign.spec` — declarative TOML/JSON campaign specs
    that validate up front and expand into an
    ``Experiment(stream=True)`` grid with checkpoint/resume;
  * :mod:`repro_torch.campaign.report` — per-regime winner tables with
    bootstrap CIs, rendered byte-deterministically as markdown + JSON;
  * ``python -m repro_torch.campaign`` — the ``list`` / ``fetch`` / ``run`` /
    ``report`` CLI.

The PyTorch port's copy of the reference's jax-free ``repro.campaign``,
with its imports pointed into the port (the campaigns run on the port's
scheduler copy in :mod:`repro_torch.core`) and the three fixtures copied
byte for byte.  One difference is meant: :func:`default_output_dir` is
``results/torch/campaigns/<name>``, so the port never writes over the
reference's artifacts under ``results/campaigns/``.
"""
from .calibrate import TraceProfile, calibrated_scenario, profile_trace
from .report import aggregate, winners, write_report
from .runner import run_campaign
from .spec import CampaignSpec, CampaignSpecError, default_output_dir
from .zoo import (TraceSpec, fetch, file_sha256, get_trace, is_cached,
                  register_trace, registered_traces, trace_path)

__all__ = [
    "CampaignSpec", "CampaignSpecError", "TraceProfile", "TraceSpec",
    "aggregate", "calibrated_scenario", "default_output_dir", "fetch",
    "file_sha256", "get_trace", "is_cached", "profile_trace",
    "register_trace", "registered_traces", "run_campaign", "trace_path",
    "winners", "write_report",
]
