"""Declarative campaign specs: traces x mechanisms x regimes x seeds.

A campaign is a TOML (or JSON) file that expands into an
``Experiment(stream=True)`` grid — every knob validated *before* any
simulation starts, so a typo fails in milliseconds, not after an hour
of replay.  Schema (see docs/campaigns.md for the full reference)::

    [campaign]
    name = "mini"                      # -> results/torch/campaigns/<name>/
    mechanisms = ["BASE", "CUA&SPAA"]  # registered mechanism names
    seeds = [0, 1]
    max_jobs = 300                     # optional per-trace job cap
    # scale = 1.0                      # optional Experiment.scale
    # [campaign.sim]                   # optional SimConfig overrides
    # queue_policy = "EASY"

    [grid]                             # regime axes (cross product)
    target_load = [0.7, 0.9]           # calibrated per trace
    malleable_frac = [0.2]             # per-project type fractions
    notice = ["W2", "W5"]              # Table III notice mixes

    [[trace]]
    name = "mini-steady"               # a trace-zoo entry
    # target_load = [0.8]              # per-trace axis override

Each ``[[trace]]`` entry may override any ``[grid]`` axis; every
(trace x grid-point) pair becomes one calibrated streaming Scenario
(repro_torch.campaign.calibrate), and the experiment sweeps those against
mechanisms x seeds with checkpoint/resume via
``Experiment.run_stream(checkpoint=...)``.
"""
from __future__ import annotations

import itertools
import json
import os
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.core.experiment import Experiment
from repro_torch.core.policy import resolve_mechanism
from repro_torch.core.workloads import Scenario
from repro_torch.core.workloads.synthetic import notice_mix as _notice_mix

from . import _toml
from .calibrate import calibrated_scenario
from .zoo import get_trace

#: the regime axes a [grid] (or [[trace]]) table may sweep, with their
#: validators (value -> error string or None).  ``faults`` values are
#: compact repro_torch.faults spec strings ("none", "exp-mtbf:mtbf_h=168");
#: they thread into Scenario.faults -> SimConfig.faults per cell.
#: ``batch_rounds`` values are scheduling-round intervals in seconds
#: (0 = per-event engine); they thread into Scenario.batch_rounds ->
#: SimConfig.batch_rounds per cell, so one campaign can sweep the
#: fidelity-vs-speed knob alongside the regime axes.
GRID_AXES = ("target_load", "malleable_frac", "od_frac", "notice", "faults",
             "batch_rounds")


class CampaignSpecError(ValueError):
    """A campaign spec fails validation; message names the field."""


@dataclass(frozen=True)
class TraceEntry:
    """One [[trace]] table: a zoo name plus per-trace axis overrides."""

    name: str
    axes: Mapping[str, tuple] = field(default_factory=dict)


@dataclass(frozen=True)
class CampaignSpec:
    """A validated campaign definition."""

    name: str
    mechanisms: Tuple[str, ...]
    seeds: Tuple[int, ...]
    traces: Tuple[TraceEntry, ...]
    grid: Mapping[str, tuple] = field(default_factory=dict)
    sim: Mapping[str, object] = field(default_factory=dict)
    scale: float = 1.0
    max_jobs: Optional[int] = None

    # ------------------------------------------------------------- loading
    @classmethod
    def load(cls, path: str) -> "CampaignSpec":
        """Load and validate a spec from ``.toml`` or ``.json``."""
        if path.endswith(".json"):
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        else:
            try:
                data = _toml.load(path)
            except _toml.TomlError as e:
                raise CampaignSpecError(f"{path}: {e}") from None
        return cls.from_dict(data, origin=path)

    @classmethod
    def from_dict(cls, data: Mapping, origin: str = "<dict>"
                  ) -> "CampaignSpec":
        def fail(msg: str) -> CampaignSpecError:
            return CampaignSpecError(f"{origin}: {msg}")

        if not isinstance(data, Mapping):
            raise fail("top level must be a table")
        unknown = set(data) - {"campaign", "grid", "trace"}
        if unknown:
            raise fail(f"unknown top-level table(s): {sorted(unknown)}")
        camp = data.get("campaign")
        if not isinstance(camp, Mapping):
            raise fail("missing [campaign] table")
        known = {"name", "mechanisms", "seeds", "sim", "scale", "max_jobs"}
        extra = set(camp) - known
        if extra:
            raise fail(f"[campaign]: unknown key(s) {sorted(extra)}; "
                       f"known: {sorted(known)}")
        name = camp.get("name")
        if not isinstance(name, str) or not name \
                or any(c in name for c in "/\\ "):
            raise fail("[campaign].name must be a non-empty string "
                       "without spaces or path separators")
        mechanisms = camp.get("mechanisms")
        if not isinstance(mechanisms, list) or not mechanisms \
                or not all(isinstance(m, str) for m in mechanisms):
            raise fail("[campaign].mechanisms must be a non-empty "
                       "list of strings")
        seeds = camp.get("seeds", [0])
        if not isinstance(seeds, list) or not seeds \
                or not all(isinstance(s, int) and not isinstance(s, bool)
                           for s in seeds):
            raise fail("[campaign].seeds must be a non-empty list of ints")
        sim = camp.get("sim", {})
        if not isinstance(sim, Mapping):
            raise fail("[campaign.sim] must be a table")
        scale = camp.get("scale", 1.0)
        if not isinstance(scale, (int, float)) or isinstance(scale, bool) \
                or scale <= 0:
            raise fail("[campaign].scale must be a positive number")
        max_jobs = camp.get("max_jobs")
        if max_jobs is not None and (not isinstance(max_jobs, int)
                                     or isinstance(max_jobs, bool)
                                     or max_jobs <= 0):
            raise fail("[campaign].max_jobs must be a positive int")

        grid = _axes_of(data.get("grid", {}), "[grid]", fail)
        traces_raw = data.get("trace")
        if not isinstance(traces_raw, list) or not traces_raw:
            raise fail("need at least one [[trace]] entry")
        traces: List[TraceEntry] = []
        for k, t in enumerate(traces_raw):
            where = f"[[trace]] #{k + 1}"
            if not isinstance(t, Mapping):
                raise fail(f"{where} must be a table")
            tname = t.get("name")
            if not isinstance(tname, str) or not tname:
                raise fail(f"{where}: missing trace name")
            axes = _axes_of({a: v for a, v in t.items() if a != "name"},
                            where, fail)
            traces.append(TraceEntry(tname, axes))

        spec = cls(name=name, mechanisms=tuple(mechanisms),
                   seeds=tuple(seeds), traces=tuple(traces), grid=grid,
                   sim=dict(sim), scale=float(scale), max_jobs=max_jobs)
        spec.validate(origin)
        return spec

    # ---------------------------------------------------------- validation
    def validate(self, origin: str = "<spec>") -> None:
        """Fail fast on every statically checkable error: registry
        names, axis value ranges, duplicate cells."""
        def fail(msg: str) -> CampaignSpecError:
            return CampaignSpecError(f"{origin}: {msg}")

        queue_policy = dict(self.sim).get("queue_policy", "EASY")
        for m in dict.fromkeys(self.mechanisms):
            try:
                resolve_mechanism(m, queue_policy)
            except ValueError as e:
                raise fail(f"mechanism {m!r}: {e}") from None
        if len(set(self.mechanisms)) != len(self.mechanisms):
            raise fail("duplicate mechanisms in [campaign].mechanisms")
        if len(set(self.seeds)) != len(self.seeds):
            raise fail("duplicate seeds in [campaign].seeds")
        seen = set()
        for t in self.traces:
            try:
                get_trace(t.name)
            except ValueError as e:  # re-raise with the zoo listing
                raise fail(str(e)) from None
            key = (t.name, tuple(sorted(t.axes.items())))
            if key in seen:
                raise fail(f"duplicate [[trace]] entry for {t.name!r}")
            seen.add(key)
            for axis, values in self._axes_for(t).items():
                for v in values:
                    if v is None:  # axis not swept for this trace
                        continue
                    err = _validate_axis(axis, v)
                    if err:
                        raise fail(f"trace {t.name!r}: {err}")
            # a bad od/malleable combination should fail here, not when
            # cells() builds scenarios mid-run-setup
            axes = self._axes_for(t)
            for od in axes["od_frac"]:
                for mall in axes["malleable_frac"]:
                    if od is None and mall is None:
                        continue
                    # same defaulting as calibrated_scenario: missing
                    # od -> 0.10; missing malleable -> keep rigid at 0.60
                    o = 0.10 if od is None else od
                    m = (1.0 - o - 0.60) if mall is None else mall
                    if o < 0 or m < 0 or o + m > 1.0:
                        raise fail(f"trace {t.name!r}: od_frac={o:g} and "
                                   f"malleable_frac={m:g} leave no valid "
                                   "rigid fraction (need >= 0, sum <= 1)")

    def _axes_for(self, t: TraceEntry) -> Dict[str, tuple]:
        """Effective regime axes for one trace: [grid] with per-trace
        overrides; absent axes default to a single None (uncalibrated)."""
        axes = dict(self.grid)
        axes.update(t.axes)
        return {a: tuple(axes.get(a) or (None,)) for a in GRID_AXES}

    # ----------------------------------------------------------- expansion
    def cells(self, offline: Optional[bool] = None
              ) -> List[Tuple[Dict[str, object], Scenario]]:
        """Expand traces x grid into ``(regime, scenario)`` pairs.

        ``regime`` is the flat dict of grouping keys the report
        aggregates on (trace name + every non-None axis value); the
        scenario is calibrated and streaming-ready.  Deterministic
        order: traces in spec order, axes in GRID_AXES order.
        """
        out: List[Tuple[Dict[str, object], Scenario]] = []
        for t in self.traces:
            axes = self._axes_for(t)
            for combo in itertools.product(*(axes[a] for a in GRID_AXES)):
                point = dict(zip(GRID_AXES, combo))
                regime: Dict[str, object] = {"trace": t.name}
                regime.update({a: v for a, v in point.items()
                               if v is not None})
                scenario = calibrated_scenario(
                    t.name,
                    target_load=point["target_load"],
                    malleable_frac=point["malleable_frac"],
                    od_frac=point["od_frac"],
                    notice=point["notice"],
                    max_jobs=self.max_jobs,
                    offline=offline)
                faults = point["faults"]
                if faults is not None:
                    # suffix keeps scenario labels (the runner's
                    # regime-mapping key) unique across fault cells
                    scenario = replace(
                        scenario, faults=faults,
                        name=f"{scenario.label}/f:{faults}")
                batch = point["batch_rounds"]
                if batch is not None:
                    scenario = replace(
                        scenario, batch_rounds=float(batch),
                        name=f"{scenario.label}/b:{batch:g}")
                out.append((regime, scenario))
        return out

    def to_experiment(self, offline: Optional[bool] = None,
                      processes: Optional[int] = None
                      ) -> Tuple[Experiment,
                                 List[Dict[str, object]]]:
        """Build the streaming Experiment plus the per-workload regime
        dicts (index-aligned with the experiment's workload list)."""
        pairs = self.cells(offline=offline)
        exp = Experiment(mechanisms=self.mechanisms,
                         workloads=[s for _r, s in pairs],
                         seeds=self.seeds, sim_kw=dict(self.sim),
                         scale=self.scale, processes=processes,
                         stream=True)
        return exp, [r for r, _s in pairs]

    @property
    def n_cells(self) -> int:
        total = 0
        for t in self.traces:
            axes = self._axes_for(t)
            point = 1
            for a in GRID_AXES:
                point *= len(axes[a])
            total += point
        return total * len(self.mechanisms) * len(self.seeds)


def _axes_of(table: Mapping, where: str, fail) -> Dict[str, tuple]:
    if not isinstance(table, Mapping):
        raise fail(f"{where} must be a table")
    unknown = set(table) - set(GRID_AXES)
    if unknown:
        raise fail(f"{where}: unknown axis(es) {sorted(unknown)}; "
                   f"known: {list(GRID_AXES)}")
    axes: Dict[str, tuple] = {}
    for a, v in table.items():
        if not isinstance(v, list) or not v:
            raise fail(f"{where}.{a} must be a non-empty list")
        if len(set(map(repr, v))) != len(v):
            raise fail(f"{where}.{a} has duplicate values")
        axes[a] = tuple(v)
    return axes


def _validate_axis(axis: str, v: object) -> Optional[str]:
    if axis == "faults":
        if not isinstance(v, str):
            return f"faults value {v!r} must be a fault-spec string"
        from repro_torch.faults import resolve_faults
        try:
            resolve_faults(v)
        except ValueError as e:
            return str(e)
        return None
    if axis == "notice":
        if not isinstance(v, str):
            return f"notice value {v!r} must be a mix name string"
        try:
            _notice_mix(v)
        except ValueError as e:
            return str(e)
        return None
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return f"{axis} value {v!r} must be a number"
    if axis == "target_load" and not 0.0 < v <= 2.0:
        return f"target_load {v} outside (0, 2]"
    if axis in ("malleable_frac", "od_frac") and not 0.0 <= v <= 1.0:
        return f"{axis} {v} outside [0, 1]"
    if axis == "batch_rounds" and v < 0:
        return f"batch_rounds {v} must be >= 0 seconds"
    return None


def spec_fingerprint(path: str) -> str:
    """sha256 of the spec file bytes (campaign provenance stamp)."""
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def default_output_dir(spec: CampaignSpec) -> str:
    """``results/torch/campaigns/<name>``: the reference writes
    ``results/campaigns/<name>``, whose checked-in artifacts the port
    must never overwrite."""
    return os.path.join("results", "torch", "campaigns", spec.name)
