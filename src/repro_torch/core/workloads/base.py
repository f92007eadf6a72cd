"""Composable workload API: sources, transforms, scenarios (paper §IV-A).

The policy registry makes scheduling *policies* pluggable; this package does the same for
the other evaluation axis — workload composition.  Three small protocols
mirror the policy architecture (`repro_torch.core.policy`):

    WorkloadSource     produces a job trace (a list of JobSpec).  Built-in
                       sources: "theta" (the decomposed synthetic Theta-like
                       generator, repro_torch.core.workloads.synthetic) and "swf"
                       (Standard Workload Format trace replay with
                       job-type/malleability annotation,
                       repro_torch.core.workloads.swf).
    ScenarioTransform  rewrites a trace: load scaling, burst injection,
                       diurnal modulation, notice-mix override, type-mix
                       reassignment (repro_torch.core.workloads.transforms).
                       Transforms stack on any source.
    Scenario           a picklable recipe: source name + params + a stack
                       of (transform name, params) — the unit Experiment
                       sweeps alongside mechanisms and seeds.

Both sources and transforms live in string-keyed registries so new
workloads are *data* (registry entries) rather than forks of the
generator, exactly like scheduling policies::

    from repro_torch.core.workloads import WorkloadSource, register_source

    @register_source("replay_csv")
    class CsvReplay(WorkloadSource):
        def __init__(self, path, n_nodes=4392, seed=0):
            self.path, self.n_nodes, self.seed = path, n_nodes, seed

        def jobs(self):
            return [make_jobspec(row) for row in read_csv(self.path)]

    # Scenario("replay_csv", params={"path": "trace.csv"}) now works
    # everywhere — Experiment, benchmarks, examples.

Named presets (paper W1-W5, bursty-OD stress, trace replay) are plain
Scenario factories registered in repro_torch.core.workloads.presets; Experiment
accepts the preset name string directly.
"""
from __future__ import annotations

import hashlib
import logging
import os
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence, Tuple

import numpy as np

from ..job import JobSpec

log = logging.getLogger(__name__)

#: scenario labels already warned about losing the bounded-memory
#: guarantee (one structured warning per scenario per process, so a
#: thousand-cell sweep does not emit a thousand copies)
_WARNED_MATERIALIZED: set = set()


class UnknownWorkloadError(ValueError):
    """A workload source, transform, scenario, or notice-mix name that is
    not in its registry.  ValueError subclass for backward compatibility,
    in the style of :class:`repro_torch.core.policy.UnknownPolicyError`;
    Experiment relies on the distinct type to tell registry misses in
    spawn-start workers apart from genuine simulation errors."""


class WorkloadDataError(ValueError):
    """A workload source's input data is unusable (corrupt trace line, no
    usable jobs, ...).  Deliberately NOT an UnknownWorkloadError: registry
    misses make Experiment retry the sweep serially (spawn-start workers
    may lack parent-registered classes), while data errors are
    deterministic and must propagate immediately."""


# ------------------------------------------------------------------ protocols
@dataclass(frozen=True)
class TraceStats:
    """Cheap global aggregates of a canonical trace, computable without
    materializing it: job/on-demand counts and the submit-time span.
    Streaming transforms pre-draw their RNG from these (a transform's
    randomness may depend on trace *shape*, never on trace *contents*),
    and each transform republishes the stats it hands downstream via
    :meth:`ScenarioTransform.stream_stats`."""

    n_jobs: int
    n_od: int
    t0: float
    t1: float
    #: on-demand job counts per stream-merge rank: rank 0 is the base
    #: trace, rank r >= 1 the jobs a trace-restructuring transform (the
    #: r-th ``burst_inject`` in the stack) merged in.  The *materialized*
    #: pipeline orders od jobs base-first-then-appended when a later
    #: transform assigns per-od draws (NoticeModel.assign walks the list
    #: in that order); a streaming merge interleaves them by submit time,
    #: so downstream per-od transforms recover the materialized
    #: assignment order from each job's rank (:func:`stream_rank`) plus
    #: these per-rank offsets.  Empty means "all rank 0" (n_od jobs).
    od_rank_counts: Tuple[int, ...] = ()

    def od_rank_offsets(self) -> Tuple[int, ...]:
        """Start index of each rank's od block in materialized order."""
        counts = self.od_rank_counts or (self.n_od,)
        offsets = [0]
        for c in counts[:-1]:
            offsets.append(offsets[-1] + c)
        return tuple(offsets)


#: attribute a stream-merging transform sets on the JobSpecs it injects
#: (absent == rank 0, the base trace): a ``(rank, index)`` pair, where
#: index is the job's position within its rank in *materialized*
#: (generation/appended) order — the merge re-orders injected jobs by
#: submit time, so encounter order no longer carries it.  See
#: TraceStats.od_rank_counts.
_STREAM_TAG_ATTR = "_stream_tag"


def stream_rank(j: JobSpec) -> int:
    """The stream-merge rank of a job (0 for base-trace jobs)."""
    return getattr(j, _STREAM_TAG_ATTR, (0, 0))[0]


def stream_index(j: JobSpec) -> int:
    """A tagged job's position within its rank, in materialized order."""
    return getattr(j, _STREAM_TAG_ATTR, (0, 0))[1]


def tag_stream_rank(j: JobSpec, rank: int, index: int) -> None:
    setattr(j, _STREAM_TAG_ATTR, (rank, index))


class WorkloadSource:
    """Produces one job trace.

    Contract:
      * the constructor accepts registry params as keyword arguments and
        MUST accept a ``seed`` keyword (Experiment re-seeds each run);
      * ``jobs()`` returns a canonical trace — submit-time sorted with
        contiguous jids starting at 0 (use :func:`canonicalize`);
      * ``iter_jobs()`` yields the *same* canonical trace lazily — the
        streaming entry point (year-scale replays).  The default
        materializes through ``jobs()``; sources that can stream
        (builtin "theta" and "swf" stage compact numeric columns
        instead of JobSpec objects) override it, and must be
        job-for-job identical to ``jobs()``;
      * ``trace_stats()`` returns the :class:`TraceStats` of the
        canonical trace without yielding it (streaming transforms
        pre-draw from these).  The default materializes; streaming
        sources override it to stay bounded;
      * ``n_nodes`` is the system size the trace targets (SimConfig uses
        it when a Scenario does not override it).
    """

    name: str = "?"
    n_nodes: int = 0

    def jobs(self) -> List[JobSpec]:
        raise NotImplementedError

    def iter_jobs(self) -> Iterator[JobSpec]:
        return iter(self.jobs())

    def trace_stats(self) -> TraceStats:
        return trace_stats_of(self.jobs())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} source:{self.name}>"


def trace_stats_of(jobs: Sequence[JobSpec]) -> TraceStats:
    """TraceStats of a materialized (not necessarily sorted) trace."""
    from ..job import JobType
    if not jobs:
        return TraceStats(0, 0, 0.0, 0.0)
    subs = [j.submit_time for j in jobs]
    return TraceStats(len(jobs),
                      sum(j.jtype is JobType.ONDEMAND for j in jobs),
                      min(subs), max(subs))


class ScenarioTransform:
    """Rewrites a job trace; stateless apart from constructor params.

    ``apply`` receives the trace, a numpy Generator (seeded per run by
    :meth:`Scenario.realize`), and the system size the trace targets —
    so transforms can honor size invariants like the paper's half-system
    on-demand cap — and returns the transformed trace; it may mutate and
    return the input list.  Scenario.realize re-canonicalizes after the
    whole stack, so transforms may leave arrivals unsorted or jids stale
    (new jobs use ``jid=-1``).

    Transforms that can rewrite a trace *one job at a time* additionally
    set ``streamable = True`` and implement ``stream``, which lets
    :meth:`Scenario.iter_realize` run the whole stack in bounded memory.
    The streaming contract (bit-identity with ``apply``):

      * ``stream(jobs, rng, n_nodes, stats)`` is called **eagerly** in
        stack order and must consume ALL the RNG draws ``apply`` would
        make *before returning* its generator (pre-draw from ``stats``
        — a draw may depend on trace shape, never on job contents), so
        the shared per-run stream is consumed in exactly the
        materialized order;
      * the returned iterator must preserve submit-time order (monotone
        arrival maps).  A transform that *adds* jobs (``burst_inject``)
        streams by drawing its bounded injected set eagerly and merging
        it into the flow in submit order with base-first tie-breaks —
        reproducing exactly what ``canonicalize``'s stable sort does to
        the appended materialized list — and tags the injected jobs
        with a stream rank (:func:`tag_stream_rank`) so downstream
        per-od transforms can recover the materialized assignment
        order (see :attr:`TraceStats.od_rank_counts`).  Rewrites that
        reassign *existing* jobs' draws content-dependently
        (``type_mix``) stay ``streamable = False`` and force
        ``iter_realize`` to fall back to the materialized path;
      * ``stream_stats`` republishes the stats the transform hands the
        next stage (e.g. a compressed arrival span, or counts grown by
        injected jobs).  ``iter_realize`` calls it *after* ``stream``,
        so a merging transform may publish exact stats of the set it
        just drew."""

    name: str = "?"
    streamable: bool = False

    def apply(self, jobs: List[JobSpec], rng: np.random.Generator,
              n_nodes: int) -> List[JobSpec]:
        raise NotImplementedError

    def stream(self, jobs: Iterator[JobSpec], rng: np.random.Generator,
               n_nodes: int, stats: TraceStats) -> Iterator[JobSpec]:
        raise NotImplementedError(
            f"transform {self.name!r} is not streamable")

    def stream_stats(self, stats: TraceStats) -> TraceStats:
        return stats

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} transform:{self.name}>"


def canonicalize(jobs: List[JobSpec]) -> List[JobSpec]:
    """Sort by submit time and renumber jids contiguously from 0 (the
    trace invariant every source and Scenario.realize guarantee)."""
    jobs.sort(key=lambda j: j.submit_time)
    for new_id, j in enumerate(jobs):
        j.jid = new_id
    return jobs


# ------------------------------------------------------------------ registries
_SOURCES: Dict[str, type] = {}
_TRANSFORMS: Dict[str, type] = {}


def register_source(name: str) -> Callable[[type], type]:
    """Class decorator: ``@register_source("swf")``."""
    def deco(cls: type) -> type:
        cls.name = name
        _SOURCES[name] = cls
        return cls
    return deco


def register_transform(name: str) -> Callable[[type], type]:
    """Class decorator: ``@register_transform("load_scale")``."""
    def deco(cls: type) -> type:
        cls.name = name
        _TRANSFORMS[name] = cls
        return cls
    return deco


def get_source(name: str, **params) -> WorkloadSource:
    """Instantiate a registered workload source by name."""
    _ensure_builtins()
    try:
        cls = _SOURCES[name]
    except KeyError:
        raise UnknownWorkloadError(
            f"unknown workload source {name!r}; registered: "
            f"{', '.join(sorted(_SOURCES))}") from None
    return cls(**params)


def get_transform(name: str, **params) -> ScenarioTransform:
    """Instantiate a registered scenario transform by name."""
    _ensure_builtins()
    try:
        cls = _TRANSFORMS[name]
    except KeyError:
        raise UnknownWorkloadError(
            f"unknown scenario transform {name!r}; registered: "
            f"{', '.join(sorted(_TRANSFORMS))}") from None
    return cls(**params)


def registered_sources() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_SOURCES))


def registered_transforms() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_TRANSFORMS))


# ------------------------------------------------------------------- scenario
@dataclass
class Scenario:
    """A picklable workload recipe: source + params + transform stack.

    Experiment treats a Scenario exactly like a legacy WorkloadConfig cell:
    one Scenario x mechanism x seed per run, with ``seed`` replaced by the
    RunSpec seed (the template seed is a default for direct use).

        Scenario("swf", params={"path": "theta.swf"},
                 transforms=[("load_scale", {"factor": 1.3})])
    """

    source: str
    params: Dict[str, object] = field(default_factory=dict)
    transforms: Sequence[Tuple[str, Dict[str, object]]] = ()
    #: preset label for reporting (ExperimentResult.rows "scenario" column)
    name: Optional[str] = None
    seed: int = 0
    #: system-size override: forwarded to the source as its ``n_nodes``
    #: param (winning over ``params``) so trace clipping and the
    #: on-demand size cap match the simulated machine
    n_nodes: Optional[int] = None
    #: fault-model spec (repro_torch.faults): None/"none" for the legacy
    #: perfect machine, else a compact string ("exp-mtbf:mtbf_h=168")
    #: or a {"model": ...} dict.  Experiment threads it into
    #: ``SimConfig.faults`` for every run of this scenario (explicit
    #: ``sim_kw["faults"]`` overrides win).
    faults: object = None
    #: batch scheduling-round interval in seconds (see
    #: ``SimConfig.batch_rounds``): None/0 for the per-event engine,
    #: > 0 for one deferred scheduling pass per round.  Experiment
    #: threads it into ``SimConfig.batch_rounds`` for every run of this
    #: scenario (explicit ``sim_kw["batch_rounds"]`` overrides win).
    batch_rounds: Optional[float] = None

    @property
    def label(self) -> str:
        return self.name or self.source

    def with_seed(self, seed: int) -> "Scenario":
        return replace(self, seed=seed)

    def validate(self) -> None:
        """Fail fast — without building the trace — on errors that would
        otherwise surface in pool workers, where Experiment either
        misreads them as spawn registry misses or pays a full serial
        re-run before they propagate: unregistered source/transform
        names (UnknownWorkloadError), unknown notice mixes, and missing
        trace files (WorkloadDataError)."""
        _ensure_builtins()
        if self.source not in _SOURCES:
            get_source(self.source)  # raises with the registry listing
        for tname, _ in self.transforms:
            if tname not in _TRANSFORMS:
                get_transform(tname)  # raises with the registry listing
        from .synthetic import notice_mix
        param_sets = [self.params] + [p for _, p in self.transforms]
        for params in param_sets:
            for key in ("notice_mix", "mix"):
                if params.get(key) is not None:
                    notice_mix(params[key])
            path = params.get("path")
            if path is not None and not os.path.exists(path):
                raise WorkloadDataError(
                    f"scenario {self.label!r}: trace file not found: {path}")
        if self.faults not in (None, "none"):
            from ...faults import resolve_faults
            resolve_faults(self.faults)  # raises on unknown model / bad params
        if self.batch_rounds is not None and (
                not isinstance(self.batch_rounds, (int, float))
                or isinstance(self.batch_rounds, bool)
                or self.batch_rounds < 0
                or not np.isfinite(self.batch_rounds)):
            raise ValueError(
                f"scenario {self.label!r}: batch_rounds must be a finite "
                f"number >= 0, got {self.batch_rounds!r}")

    def realize(self, seed: Optional[int] = None
                ) -> Tuple[List[JobSpec], int]:
        """Build the trace: instantiate the source (re-seeded), run the
        transform stack, canonicalize.  Returns ``(jobs, n_nodes)``."""
        if seed is None:
            seed = self.seed
        params = {k: v for k, v in self.params.items() if k != "seed"}
        if self.n_nodes is not None:
            params["n_nodes"] = self.n_nodes
        src = get_source(self.source, seed=seed, **params)
        jobs = src.jobs()
        n_nodes = src.n_nodes
        # one transform-stack stream, decorrelated from the source's seed
        rng = np.random.default_rng([seed, 0x5CEA])
        for tname, tparams in self.transforms:
            jobs = get_transform(tname, **tparams).apply(jobs, rng, n_nodes)
        return canonicalize(jobs), n_nodes

    @property
    def streamable(self) -> bool:
        """True when the whole transform stack can run lazily (every
        transform is streamable); the source itself always can, via the
        materializing ``iter_jobs`` default at worst."""
        _ensure_builtins()
        return all(getattr(_TRANSFORMS.get(t, ScenarioTransform),
                           "streamable", False)
                   for t, _ in self.transforms)

    def iter_realize(self, seed: Optional[int] = None
                     ) -> Tuple[Iterator[JobSpec], int]:
        """Streaming :meth:`realize`: returns ``(job_iterator, n_nodes)``.

        Job-for-job identical to ``realize`` (same draws from the same
        per-run stream, same canonical order) but lazy: the source
        yields jobs one at a time and streamable transforms rewrite
        them in flight (``burst_inject`` merges its bounded injected
        set in tagged submit order).  A stack containing a
        non-streamable transform (``type_mix`` — it redraws existing
        jobs' assignments content-dependently) falls back to
        materializing internally; the call still returns an iterator,
        just not a bounded-memory one.
        """
        if seed is None:
            seed = self.seed
        if not self.streamable:
            _ensure_builtins()
            blocking = [t for t, _ in self.transforms
                        if not getattr(_TRANSFORMS.get(t, ScenarioTransform),
                                       "streamable", False)]
            key = (self.label, tuple(blocking))
            if key not in _WARNED_MATERIALIZED:
                _WARNED_MATERIALIZED.add(key)
                log.warning(
                    "Scenario %r: transform(s) %s are not streamable; "
                    "iter_realize falls back to materializing the full "
                    "trace internally — this run does NOT have the "
                    "bounded-memory streaming guarantee (see "
                    "docs/workloads.md#streaming-and-the-type_mix-fallback)",
                    self.label, ", ".join(repr(t) for t in blocking))
            jobs, n_nodes = self.realize(seed)
            return iter(jobs), n_nodes
        params = {k: v for k, v in self.params.items() if k != "seed"}
        if self.n_nodes is not None:
            params["n_nodes"] = self.n_nodes
        src = get_source(self.source, seed=seed, **params)
        n_nodes = src.n_nodes
        rng = np.random.default_rng([seed, 0x5CEA])
        stream = src.iter_jobs()
        if self.transforms:
            stats = src.trace_stats()
            for tname, tparams in self.transforms:
                tf = get_transform(tname, **tparams)
                # stream() consumes tf's whole RNG share eagerly, so the
                # shared stream is drawn in materialized stack order
                stream = tf.stream(stream, rng, n_nodes, stats)
                stats = tf.stream_stats(stats)
        return _renumber(stream), n_nodes


def _renumber(stream: Iterator[JobSpec]) -> Iterator[JobSpec]:
    """The streaming half of :func:`canonicalize`: sources yield in
    submit order and streamable transforms preserve it, so only the
    contiguous-jid invariant needs re-asserting."""
    for new_id, job in enumerate(stream):
        job.jid = new_id
        yield job


def trace_sha256(jobs: Iterable[JobSpec]) -> str:
    """Order-sensitive sha256 over every field of every job — the
    job-for-job identity fingerprint the streaming tests and benchmarks
    compare between ``iter_realize`` and ``realize``.  Consumes the
    iterable incrementally (safe on year-scale streams)."""
    h = hashlib.sha256()
    for j in jobs:
        h.update(repr((j.jid, j.jtype.value, j.project, j.submit_time,
                       j.size, j.t_estimate, j.t_actual, j.t_setup,
                       j.n_min, j.notice_kind.value, j.notice_time,
                       j.est_arrival, j.ckpt_overhead,
                       j.ckpt_interval)).encode())
    return h.hexdigest()


def _ensure_builtins() -> None:
    """Import the builtin source/transform modules exactly once
    (registration side effect); deferred to avoid a circular import at
    module load, mirroring repro_torch.core.policy._ensure_builtins."""
    from . import swf, synthetic, transforms  # noqa: F401
