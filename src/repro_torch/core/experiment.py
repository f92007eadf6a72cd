"""Experiment runner: mechanisms x workloads x seeds with process fan-out.

Replaces the copy-pasted sweep loops that used to live in
benchmarks/bench_scheduler.py and examples/mechanism_sweep.py::

    from repro_torch.core.experiment import Experiment

    exp = Experiment(mechanisms=("BASE", "CUA&SPAA", "CUA&STEAL"),
                     workloads=[WorkloadConfig(notice_mix=m) for m in ("W1", "W5")],
                     seeds=(0, 1, 2))
    result = exp.run()                   # multiprocessing fan-out
    for row in result.mean(("mechanism", "notice_mix")):
        print(row["mechanism"], row["avg_turnaround_h"])

A workload cell is a legacy :class:`WorkloadConfig`, a
:class:`~repro_torch.core.workloads.Scenario` (registry source + params +
transform stack), or a preset name string resolved through the scenario
registry — so sweeps span mechanisms x scenarios x seeds::

    Experiment(mechanisms=("BASE", "CUA&SPAA"),
               workloads=("W2", "bursty-od",
                          Scenario("swf", params={"path": "trace.swf"})),
               seeds=range(3))

Each run replaces the workload's seed, builds the trace, simulates one
mechanism, and collects :class:`Metrics`.  Fan-out uses a process pool
(simulations are CPU-bound pure Python); environments that forbid
subprocesses fall back to serial execution with a logged warning naming
the triggering exception.

Aggregation is *streaming*: workers return compact per-run metric rows
(plus an optional down-sampled record summary — ``record_summary``), so
month-scale runs never pipe full JobRecord sets back to the parent;
:meth:`Experiment.run_stream` yields results in completion order for
callers that aggregate on the fly, and the ``scale`` knob multiplies
every synthetic workload's ``n_jobs``/``horizon_days`` so one sweep
definition serves 600-job CI smokes and 50k-job scale runs alike
(benchmarks/bench_scheduler.bench_scale).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from dataclasses import dataclass, field, fields as dataclass_fields, replace
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, \
    Union

import numpy as np

from .metrics import Metrics, StreamingMetrics, collect, summarize_records
from .policy import UnknownPolicyError, resolve_mechanism
from .simulator import SimConfig, Simulator
from .workloads import Scenario, ThetaGenerator, UnknownWorkloadError, \
    WorkloadConfig, generate, get_scenario, notice_mix

log = logging.getLogger(__name__)

#: what Experiment accepts per workload cell
WorkloadLike = Union[WorkloadConfig, Scenario, str]


@dataclass(frozen=True)
class RunSpec:
    """One (mechanism, workload, seed) cell of the sweep grid."""

    mechanism: str
    workload: Union[WorkloadConfig, Scenario]
    seed: int
    sim_kw: Tuple[Tuple[str, object], ...] = ()  # frozen SimConfig overrides
    #: max records in the worker's down-sampled summary (0 = no summary)
    summary_records: int = 0
    #: bounded-memory run: lazy trace (Scenario.iter_realize / theta
    #: iter_jobs), arrivals fed to the simulator incrementally, records
    #: retired through a StreamingMetrics sink
    stream: bool = False
    #: > 0: record the first N calls per decision kernel into a
    #: DecisionTrace shipped back on RunResult.decision_trace (the
    #: device replay's per-cell input; see repro_torch.core.decision_torch)
    capture_decisions: int = 0

    def key(self, names: Sequence[str]) -> tuple:
        """Group key: each name is a RunSpec field, a workload field, or —
        for Scenario cells — "scenario" / a source param name."""
        out = []
        for n in names:
            if hasattr(self, n):
                out.append(getattr(self, n))
            elif isinstance(self.workload, Scenario):
                if n == "scenario":
                    out.append(self.workload.label)
                else:
                    out.append(self.workload.params.get(n))
            elif n == "scenario":
                out.append(None)  # legacy WorkloadConfig cell
            else:
                out.append(getattr(self.workload, n))
        return tuple(out)


@dataclass(frozen=True)
class RunResult:
    """One run's compact result row: metrics, wall time, and (when
    ``Experiment.record_summary`` asks for one) a down-sampled record
    summary — never the full JobRecord set."""

    spec: RunSpec
    metrics: Metrics
    elapsed_s: float = 0.0
    summary: Optional[dict] = None
    #: DecisionTrace when the spec asked for capture (picklable, so it
    #: survives process fan-out); None otherwise
    decision_trace: Optional[object] = None


def _sim_kw(spec: RunSpec) -> dict:
    """RunSpec sim overrides + the scenario's per-cell SimConfig axes
    (fault spec, batch-round interval); an explicit sim_kw entry wins
    over the Scenario field."""
    kw = dict(spec.sim_kw)
    faults = getattr(spec.workload, "faults", None)
    if faults is not None and "faults" not in kw:
        kw["faults"] = faults
    batch = getattr(spec.workload, "batch_rounds", None)
    if batch is not None and "batch_rounds" not in kw:
        kw["batch_rounds"] = batch
    return kw


def _execute(spec: RunSpec) -> RunResult:
    """Top-level so process pools can pickle it."""
    from contextlib import nullcontext

    from . import decision

    t0 = time.perf_counter()
    wl = spec.workload
    cap = (decision.capture(spec.capture_decisions)
           if spec.capture_decisions > 0 else nullcontext())
    if spec.stream:
        if isinstance(wl, Scenario):
            jobs, n_nodes = wl.iter_realize(seed=spec.seed)
        else:
            wcfg = replace(wl, seed=spec.seed)
            jobs = ThetaGenerator(wcfg).iter_jobs()
            n_nodes = wcfg.n_nodes
        cfg = SimConfig(n_nodes=n_nodes, mechanism=spec.mechanism,
                        **_sim_kw(spec))
        sink = StreamingMetrics(instant_eps=cfg.instant_eps)
        sim = Simulator(cfg, jobs, record_sink=sink)
        with cap as trace:
            sim.run()
        summary = sink.summary() if spec.summary_records else None
        return RunResult(spec, sink.result(sim),
                         elapsed_s=time.perf_counter() - t0, summary=summary,
                         decision_trace=trace)
    if isinstance(wl, Scenario):
        jobs, n_nodes = wl.realize(seed=spec.seed)
    else:
        wcfg = replace(wl, seed=spec.seed)
        jobs = generate(wcfg)
        n_nodes = wcfg.n_nodes
    cfg = SimConfig(n_nodes=n_nodes, mechanism=spec.mechanism,
                    **_sim_kw(spec))
    sim = Simulator(cfg, jobs)
    with cap as trace:
        sim.run()
    summary = (summarize_records(sim.records, spec.summary_records)
               if spec.summary_records else None)
    return RunResult(spec, collect(sim),
                     elapsed_s=time.perf_counter() - t0, summary=summary,
                     decision_trace=trace)


@dataclass
class Experiment:
    """A mechanisms x workloads x seeds sweep with streaming aggregation."""

    mechanisms: Sequence[str]
    workloads: Sequence[WorkloadLike]
    seeds: Sequence[int] = (0,)
    sim_kw: Mapping[str, object] = field(default_factory=dict)
    #: None -> one process per CPU (capped at the number of runs);
    #: 0 or 1 -> serial in-process execution.
    processes: Optional[int] = None
    #: multiplies every synthetic workload's n_jobs AND horizon_days
    #: (offered load is preserved), so one sweep definition spans CI
    #: smokes to 50k-job scale runs.  Trace-replay Scenarios without
    #: those params are left untouched.
    scale: float = 1.0
    #: > 0: each worker also returns metrics.summarize_records(...) with
    #: at most this many sampled per-job tuples (RunResult.summary)
    record_summary: int = 0
    #: run every cell in bounded memory: lazy traces, incremental
    #: arrival feed, StreamingMetrics record sink (year-scale replays).
    #: Identical job-for-job simulation; metric means match to float
    #: accumulation order, record summaries become sketch-backed.
    stream: bool = False
    #: "torch": capture each cell's decision stream and replay the whole
    #: grid as ONE batched torch program on ``sweep_device`` after the
    #: sweep, parity-checked per cell against the numpy engine (the
    #: identity baseline — the metrics always come from the numpy
    #: simulation).  The DeviceSweepReport lands on
    #: ExperimentResult.device_report.
    #: None (default): plain process fan-out, no capture.
    device: Optional[str] = None
    #: calls captured per kernel per cell when device dispatch is on
    device_capture: int = 256
    #: device replay precision: "float64" (exact parity gate) or
    #: "float32" (documented-tolerance fallback; see decision_torch)
    device_dtype: str = "float64"
    #: the torch device of the replay; "cuda" raises on a host without a
    #: card (no fallback), so CPU runs ask for "cpu"
    sweep_device: str = "cuda"

    def _scaled(self, wl: Union[WorkloadConfig, Scenario]
                ) -> Union[WorkloadConfig, Scenario]:
        if self.scale == 1.0:
            return wl
        if isinstance(wl, WorkloadConfig):
            return replace(wl, n_jobs=max(1, round(wl.n_jobs * self.scale)),
                           horizon_days=wl.horizon_days * self.scale)
        params = dict(wl.params)
        if "n_jobs" in params:
            params["n_jobs"] = max(1, round(params["n_jobs"] * self.scale))
        if "horizon_days" in params:
            params["horizon_days"] = params["horizon_days"] * self.scale
        return replace(wl, params=params) if params != wl.params else wl

    def specs(self) -> Iterator[RunSpec]:
        if self.device not in (None, "torch"):
            raise ValueError(
                f"device must be None or 'torch', got {self.device!r}")
        frozen_kw = tuple(sorted(self.sim_kw.items()))
        capture = self.device_capture if self.device else 0
        for wl in self.workloads:
            if isinstance(wl, str):  # preset name -> Scenario
                wl = get_scenario(wl)
            wl = self._scaled(wl)
            for mech in self.mechanisms:
                for seed in self.seeds:
                    yield RunSpec(mech, wl, seed, frozen_kw,
                                  self.record_summary, self.stream,
                                  capture)

    def _validated_specs(self) -> List[RunSpec]:
        # fail fast on typos with the registry-listing ValueError (worker
        # tracebacks are much harder to read)
        queue_policy = dict(self.sim_kw).get("queue_policy", "EASY")
        for mech in dict.fromkeys(self.mechanisms):
            resolve_mechanism(mech, queue_policy)
        specs = list(self.specs())  # also resolves preset-name workloads
        for spec in specs:
            if isinstance(spec.workload, Scenario):
                spec.workload.validate()
            else:
                # a bad mix raised in a worker would read as a registry
                # miss below and trigger a pointless serial re-run
                notice_mix(spec.workload.notice_mix)
        return specs

    def _stream(self, skip: Sequence[int] = (),
                specs: Optional[List[RunSpec]] = None
                ) -> Iterator[Tuple[int, RunResult]]:
        """Yield (grid index, RunResult) as runs complete; grid indices
        in ``skip`` (checkpoint-restored) are not executed.  ``specs``
        lets callers that already validated the grid skip a re-pass."""
        if specs is None:
            specs = self._validated_specs()
        n = self.processes
        if n is None:
            n = min(len(specs), os.cpu_count() or 1)
        pending = {i: s for i, s in enumerate(specs) if i not in set(skip)}
        if not pending:
            return
        if n > 1 and len(pending) > 1:
            try:
                from concurrent.futures import ProcessPoolExecutor, \
                    as_completed
                from concurrent.futures.process import BrokenProcessPool
                pool = ProcessPoolExecutor(max_workers=n)
                try:
                    futs = {pool.submit(_execute, s): i
                            for i, s in pending.items()}
                    for fut in as_completed(futs):
                        i = futs[fut]
                        result = fut.result()
                        del pending[i]
                        yield i, result
                finally:
                    # a consumer that stops early (break / raise) closes
                    # this generator: drop the queued runs instead of
                    # blocking until the whole discarded sweep finishes
                    pool.shutdown(wait=False, cancel_futures=True)
                return
            except (ImportError, NotImplementedError, OSError,
                    PermissionError, BrokenProcessPool) as exc:
                # no usable subprocess support: degrade to serial, loudly
                log.warning(
                    "Experiment: process fan-out unavailable (%r); "
                    "falling back to serial execution of %d remaining "
                    "run(s)", exc, len(pending))
            except (UnknownPolicyError, UnknownWorkloadError) as exc:
                # mechanisms and scenarios resolved in-process above, so a
                # registry miss can only be spawn-start workers lacking
                # the parent-registered custom policies/sources: degrade
                # to serial.  Genuine simulation errors propagate
                log.warning(
                    "Experiment: spawn-start workers miss a registry "
                    "entry (%r); falling back to serial execution of %d "
                    "remaining run(s)", exc, len(pending))
        for i, s in sorted(pending.items()):
            yield i, _execute(s)

    @staticmethod
    def _grid_key(specs: List[RunSpec]) -> str:
        """Fingerprint of the sweep definition, stored in checkpoints so
        a progress file is never resumed against a different grid."""
        parts = [repr(s) for s in specs]
        return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]

    def grid_key(self) -> str:
        """Public fingerprint of this sweep's validated grid (the value
        ``run_stream(checkpoint=...)`` stores in progress files)."""
        return self._grid_key(self._validated_specs())

    def run_stream(self, checkpoint: Optional[str] = None
                   ) -> Iterator[RunResult]:
        """Yield each RunResult as it completes (streaming aggregation:
        nothing is retained for finished runs).

        ``checkpoint`` names a JSON progress file for long replays: each
        completed run is recorded (atomically rewritten) as it finishes,
        and a re-run with the same sweep definition yields the recorded
        results immediately — restored RunResults carry their saved
        metrics/elapsed but no record summary — then executes only the
        missing cells.  A checkpoint written by a *different* grid is
        refused (ValueError) rather than silently misapplied.
        """
        if checkpoint is None:
            for _i, result in self._stream():
                yield result
            return
        specs = self._validated_specs()  # validated once, reused throughout
        key = self._grid_key(specs)
        done: Dict[int, dict] = {}
        if os.path.exists(checkpoint):
            with open(checkpoint) as f:
                saved = json.load(f)
            if saved.get("grid_key") != key:
                raise ValueError(
                    f"checkpoint {checkpoint!r} belongs to a different "
                    f"sweep (grid_key {saved.get('grid_key')!r} != {key!r}); "
                    "delete it or point elsewhere")
            done = {int(i): row for i, row in saved.get("runs", {}).items()}
        for i, row in sorted(done.items()):
            yield RunResult(specs[i], Metrics(**row["metrics"]),
                            elapsed_s=row.get("elapsed_s", 0.0))
        for i, result in self._stream(skip=tuple(done), specs=specs):
            done[i] = {"metrics": result.metrics.as_dict(),
                       "elapsed_s": result.elapsed_s}
            tmp = checkpoint + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"grid_key": key,
                           "n_specs": len(specs),
                           "runs": {str(k): v for k, v in done.items()}},
                          f, indent=1)
            os.replace(tmp, checkpoint)
            yield result

    def run(self) -> "ExperimentResult":
        """Run the sweep and collect the compact rows in grid order.

        With ``device="torch"`` the captured decision streams are then
        replayed as one batched torch program on ``sweep_device`` (after
        the process pool is gone: the workers never touch CUDA) and the
        resulting
        :class:`~repro_torch.core.decision_torch.DeviceSweepReport` is
        attached as ``result.device_report`` (metrics are untouched — the
        numpy engine stays the identity baseline).
        """
        if self.device == "torch":
            # fail on a missing torch or card before paying for the sweep
            from . import decision_torch
            decision_torch.check_device(self.sweep_device)
        indexed = sorted(self._stream(), key=lambda it: it[0])
        result = ExperimentResult([r for _i, r in indexed])
        if self.device == "torch":
            cells = [(f"{r.spec.mechanism}/{r.spec.key(('scenario',))[0]}"
                      f"/s{r.spec.seed}", r.decision_trace)
                     for r in result.runs if r.decision_trace is not None]
            result.device_report = decision_torch.run_device_sweep(
                cells, dtype=self.device_dtype, device=self.sweep_device)
        return result


class ExperimentResult:
    """The collected runs plus grouping/averaging helpers."""

    def __init__(self, runs: List[RunResult]):
        self.runs = runs
        #: DeviceSweepReport when the sweep ran with device dispatch
        self.device_report = None

    def __iter__(self) -> Iterator[RunResult]:
        return iter(self.runs)

    def __len__(self) -> int:
        return len(self.runs)

    def rows(self) -> List[dict]:
        """One flat dict per run: mechanism/seed plus, for legacy
        WorkloadConfig cells, notice_mix and every workload field that
        varies across the sweep; Scenario cells emit their preset label
        as "scenario" (plus notice_mix when it is a source param).  The
        metrics follow."""
        varying: List[str] = []
        wcs = [r.spec.workload for r in self.runs
               if isinstance(r.spec.workload, WorkloadConfig)]
        if wcs:
            for f in dataclass_fields(wcs[0]):
                if f.name == "notice_mix":
                    continue  # always emitted
                if f.name == "seed":
                    continue  # template seed is replaced by RunSpec.seed
                if len({getattr(w, f.name) for w in wcs}) > 1:
                    varying.append(f.name)
        out = []
        for r in self.runs:
            row = {"mechanism": r.spec.mechanism, "seed": r.spec.seed}
            wl = r.spec.workload
            if isinstance(wl, WorkloadConfig):
                row["notice_mix"] = wl.notice_mix
                for name in varying:
                    row[name] = getattr(wl, name)
            else:
                row["scenario"] = wl.label
                if "notice_mix" in wl.params:
                    row["notice_mix"] = wl.params["notice_mix"]
            row.update(r.metrics.as_dict())
            row["elapsed_s"] = r.elapsed_s
            out.append(row)
        return out

    def mean(self, by: Sequence[str] = ("mechanism",)) -> List[dict]:
        """Average finite metric values per group.

        `by` names RunSpec fields ("mechanism", "seed") or WorkloadConfig
        fields ("notice_mix", "ckpt_freq_factor", ...); grid order is
        preserved in the output.
        """
        groups: Dict[tuple, List[RunResult]] = {}
        for r in self.runs:
            groups.setdefault(r.spec.key(by), []).append(r)
        out = []
        for key, runs in groups.items():
            row = dict(zip(by, key))
            dicts = [r.metrics.as_dict() for r in runs]
            metric_keys = [k for k, v in dicts[0].items()
                           if isinstance(v, (int, float))]
            for k in metric_keys:
                vals = [d.get(k) for d in dicts]
                vals = [v for v in vals if v is not None and np.isfinite(v)]
                row[k] = float(np.mean(vals)) if vals else float("nan")
            out.append(row)
        return out
