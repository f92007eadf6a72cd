"""Campaign execution: spec -> streamed grid -> report artifacts.

Thin glue over the pieces that already exist: the spec expands to an
``Experiment(stream=True)``, cells run through
``run_stream(checkpoint=)`` (so a killed campaign resumes instead of
restarting), and the completed rows go through the regime report
writer.  Rows are re-sorted into deterministic grid order before
writing — process-pool completion order varies run to run, the
artifacts must not.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Optional

from repro_torch.core.experiment import RunResult

from .report import regime_key, write_report
from .spec import CampaignSpec, default_output_dir
from .zoo import file_sha256, get_trace

#: checkpoint filename inside the campaign output directory
CHECKPOINT = "checkpoint.json"


def campaign_provenance(spec: CampaignSpec, grid_key: str,
                        trace_paths: Mapping[str, str]) -> Dict[str, object]:
    """Stable identifiers only (no timestamps): what ran, on which
    trace bytes, over which grid — reports must be byte-reproducible."""
    return {
        "campaign": spec.name,
        "grid_key": grid_key,
        "n_cells": spec.n_cells,
        "mechanisms": ",".join(spec.mechanisms),
        "seeds": ",".join(str(s) for s in spec.seeds),
        "traces": ";".join(
            f"{name}:{file_sha256(path)[:12]}"
            for name, path in sorted(trace_paths.items())),
    }


def run_campaign(spec: CampaignSpec, out_dir: Optional[str] = None,
                 offline: Optional[bool] = None, resume: bool = True,
                 processes: Optional[int] = None,
                 progress: Optional[Callable[[int, int, RunResult],
                                             None]] = None
                 ) -> Dict[str, str]:
    """Run every cell of ``spec`` and write the report artifacts.

    Returns the artifact paths (see :func:`report.write_report`).
    ``resume=True`` keeps a grid-keyed checkpoint in ``out_dir`` —
    completed cells are never re-simulated after a crash/kill;
    ``resume=False`` ignores and overwrites any existing checkpoint.
    ``progress`` (done_count, total, result) fires per completed cell.
    """
    out_dir = out_dir or default_output_dir(spec)
    os.makedirs(out_dir, exist_ok=True)
    exp, regimes = spec.to_experiment(offline=offline, processes=processes)
    # regimes are index-aligned with exp.workloads; scenario labels are
    # unique (validated spec: no duplicate trace/grid points), so label
    # -> regime is a total, unambiguous mapping for result rows
    regime_of = {wl.label: reg
                 for wl, reg in zip(exp.workloads, regimes)}
    assert len(regime_of) == len(regimes), "duplicate scenario labels"
    checkpoint = os.path.join(out_dir, CHECKPOINT)
    if not resume and os.path.exists(checkpoint):
        os.unlink(checkpoint)
    grid_key = exp.grid_key()
    total = spec.n_cells
    rows: List[dict] = []
    for done, result in enumerate(exp.run_stream(checkpoint=checkpoint), 1):
        wl = result.spec.workload
        rows.append({"regime": regime_of[wl.label],
                     "mechanism": result.spec.mechanism,
                     "seed": result.spec.seed,
                     "metrics": result.metrics.as_dict()})
        if progress is not None:
            progress(done, total, result)
    # completion order is pool-dependent; artifacts must not be
    rows.sort(key=lambda r: (repr(regime_key(r["regime"])),
                             r["mechanism"], r["seed"]))
    trace_paths = {t.name: spec_path for t in spec.traces
                   for spec_path in
                   [_resolved_path(t.name, exp)]}
    prov = campaign_provenance(spec, grid_key, trace_paths)
    return write_report(out_dir, spec.name, rows, prov)


def _resolved_path(trace_name: str, exp) -> str:
    """The local file a trace resolved to (for the provenance digest).
    Every scenario of that trace shares the path; read it off the
    first matching workload instead of re-fetching."""
    get_trace(trace_name)  # keep zoo errors uniform
    for wl in exp.workloads:
        if wl.label.split("/")[0] == trace_name:
            return str(wl.params["path"])
    raise KeyError(trace_name)
