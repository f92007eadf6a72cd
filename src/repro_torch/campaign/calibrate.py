"""Per-trace calibration: measured trace profile -> scenario knobs.

Real traces differ wildly in offered load, so comparing mechanisms
"at 0.8 load" across traces needs a per-trace correction.  This module
keeps the correction *inside the existing workload algebra*: a
:class:`TraceProfile` is measured in one bounded-memory pass
(:func:`profile_trace`, built on the streaming SWF reader), and
:func:`calibrated_scenario` expresses every knob through already
registered pieces so the calibrated trace replays through the
unchanged streaming ``Scenario`` path:

  * **target_load** -> a ``load_scale`` transform with
    ``factor = target_load / offered_load`` (compressing or stretching
    the arrival span; work content untouched);
  * **malleable_frac / od_frac** -> the ``swf`` source's per-project
    type fractions (type assignment must happen at annotation time to
    keep the stack streamable — the ``type_mix`` transform re-draws
    content-dependently and would force the materialized fallback);
  * **notice** -> a ``notice_mix`` transform (streamable re-draw).

Offered load is the standard trace measure:
``sum(size * runtime) / (n_nodes * submit_span)``.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.workloads import Scenario
from repro_torch.core.workloads.base import WorkloadDataError
from repro_torch.core.workloads.swf import iter_swf

from .zoo import TraceSpec, fetch, get_trace

#: profiles are deterministic per file: cache one pass per (path, mtime)
_PROFILE_CACHE: Dict[tuple, "TraceProfile"] = {}


@dataclass(frozen=True)
class TraceProfile:
    """Cheap whole-trace aggregates from one streaming pass."""

    name: str
    path: str
    n_jobs: int
    n_nodes: int
    span_s: float
    #: sum(size * runtime) / (n_nodes * span): the dimensionless offered
    #: load the raw trace would put on its own machine
    offered_load: float
    mean_size: float
    mean_runtime_s: float

    def load_factor(self, target_load: float) -> float:
        """The ``load_scale`` factor that rescales this trace's offered
        load to ``target_load`` (factor > 1 compresses arrivals)."""
        if target_load <= 0:
            raise ValueError(f"target_load must be > 0, got {target_load}")
        if self.offered_load <= 0 or self.span_s <= 0:
            raise WorkloadDataError(
                f"trace {self.name!r}: cannot calibrate load (offered "
                f"load {self.offered_load}, span {self.span_s}s)")
        return target_load / self.offered_load


def profile_trace(name: str, path: Optional[str] = None,
                  offline: Optional[bool] = None) -> TraceProfile:
    """Measure a zoo trace (or an explicit SWF ``path``) in one
    bounded-memory streaming pass, applying the same usability filter
    the ``swf`` source applies (drop cancelled / unsized / zero-runtime
    records) so the measured load matches what is replayed."""
    spec = get_trace(name) if path is None else None
    if path is None:
        path = fetch(name, offline=offline)
    try:
        key = (os.path.abspath(path), os.stat(path).st_mtime_ns)
    except OSError:
        key = None
    if key is not None and key in _PROFILE_CACHE:
        return _PROFILE_CACHE[key]
    drop_cancelled = True
    if spec is not None:
        drop_cancelled = bool(spec.swf_params.get("drop_cancelled", True))
    header: Dict[str, str] = {}
    n = 0
    t_min = float("inf")
    t_max = float("-inf")
    node_seconds = 0.0
    size_sum = 0.0
    run_sum = 0.0
    largest = 0
    for rec in iter_swf(path, header=header):
        alloc = int(rec["allocated_procs"])
        size = alloc if alloc > 0 else int(rec["req_procs"])
        largest = max(largest, size)
        if drop_cancelled and rec["status"] == 5:
            continue
        if size <= 0 or rec["run_time"] <= 0:
            continue
        n += 1
        t_min = min(t_min, rec["submit_time"])
        t_max = max(t_max, rec["submit_time"])
        node_seconds += size * rec["run_time"]
        size_sum += size
        run_sum += rec["run_time"]
    if n == 0:
        raise WorkloadDataError(
            f"trace {name!r} ({path}): no usable jobs to profile")
    n_nodes = _system_size(header, largest, path)
    span = t_max - t_min
    profile = TraceProfile(
        name=name, path=path, n_jobs=n, n_nodes=n_nodes, span_s=span,
        offered_load=(node_seconds / (n_nodes * span) if span > 0
                      else float("inf")),
        mean_size=size_sum / n, mean_runtime_s=run_sum / n)
    if key is not None:
        _PROFILE_CACHE[key] = profile
    return profile


def _system_size(header: Dict[str, str], largest: int, path: str) -> int:
    for k in ("MaxNodes", "MaxProcs"):
        raw = header.get(k)
        if raw:
            m = re.match(r"\d+", raw.replace(",", ""))
            if m:
                return int(m.group())
    if largest <= 0:
        raise WorkloadDataError(
            f"{path}: cannot infer system size (no MaxNodes/MaxProcs "
            "header and no sized jobs)")
    return largest


def calibrated_scenario(name: str,
                        target_load: Optional[float] = None,
                        malleable_frac: Optional[float] = None,
                        od_frac: Optional[float] = None,
                        notice: Optional[str] = None,
                        max_jobs: Optional[int] = None,
                        label: Optional[str] = None,
                        offline: Optional[bool] = None,
                        extra_transforms: Tuple[Tuple[str, dict], ...] = (),
                        ) -> Scenario:
    """Build a streaming-ready Scenario for a zoo trace.

    Every knob maps onto registered source params / streamable
    transforms (module docstring); the returned Scenario's stack is
    fully streamable unless ``extra_transforms`` adds a transform that
    is not.  ``label`` defaults to a regime-describing name used by the
    campaign report's grouping columns.
    """
    spec: TraceSpec = get_trace(name)
    path = fetch(name, offline=offline)
    params: Dict[str, object] = dict(spec.swf_params)
    params["path"] = path
    params["stream"] = True
    if max_jobs is not None:
        params["max_jobs"] = max_jobs
    if malleable_frac is not None or od_frac is not None:
        od = 0.10 if od_frac is None else od_frac
        mall = (1.0 - od - 0.60) if malleable_frac is None else malleable_frac
        if od < 0 or mall < 0 or od + mall > 1.0:
            raise ValueError(
                f"trace {name!r}: od_frac={od} + malleable_frac={mall} "
                "must be >= 0 and sum <= 1")
        params["frac_od_projects"] = od
        params["frac_rigid_projects"] = 1.0 - od - mall
    transforms = []
    if target_load is not None:
        prof = profile_trace(name, offline=offline)
        transforms.append(("load_scale",
                           {"factor": prof.load_factor(target_load)}))
    if notice is not None:
        transforms.append(("notice_mix", {"mix": notice}))
    transforms.extend(extra_transforms)
    if label is None:
        bits = [name]
        if target_load is not None:
            bits.append(f"load{target_load:g}")
        if malleable_frac is not None:
            bits.append(f"mall{malleable_frac:g}")
        if notice is not None:
            bits.append(notice)
        label = "/".join(bits)
    return Scenario("swf", params=params, transforms=tuple(transforms),
                    name=label)
