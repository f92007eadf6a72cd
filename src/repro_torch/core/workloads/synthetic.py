"""Theta-like workload synthesis (paper §IV-A, §IV-B), decomposed.

The real one-year Theta trace is not redistributable, so we synthesize
traces that match its published characterization: 4392 nodes, job sizes
dominated by the 128-1024 range (Fig. 3), lognormal runtimes, overestimated
walltimes, project-grouped submissions, and *bursty* on-demand arrivals
(projects submit several on-demand jobs within a short window, Fig. 5).

Job types are assigned per-project (paper default: 10% of projects submit
on-demand jobs, 60% rigid, 30% malleable); on-demand jobs larger than half
the system are reassigned to rigid/malleable (paper §IV-A).

W1-W5 advance-notice mixes (paper Table III) control the split of
on-demand jobs across {no notice, accurate, early, late}.

The monolithic trace generator is now :class:`ThetaGenerator`, a
registered :class:`~repro_torch.core.workloads.base.WorkloadSource` ("theta")
assembled from five pluggable models — ProjectModel (Zipf activity +
per-project types), SizeModel (Fig. 3 buckets), RuntimeModel (lognormal +
estimate inflation), ArrivalModel (load-scaled uniform + od bursts), and
NoticeModel (Table III kinds and lead geometry).  Swapping a model is a
constructor argument; the default models reproduce the pre-split
``generate`` **bit-for-bit** (same RNG, same draw order — golden-tested),
and ``generate(cfg)`` remains the one-call legacy entry point.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..job import JobSpec, JobType, NoticeKind
from .base import UnknownWorkloadError, WorkloadSource, canonicalize, \
    register_source

# paper Table III
NOTICE_MIXES: Dict[str, List[float]] = {
    "W1": [0.70, 0.10, 0.10, 0.10],
    "W2": [0.10, 0.70, 0.10, 0.10],
    "W3": [0.10, 0.10, 0.70, 0.10],
    "W4": [0.10, 0.10, 0.10, 0.70],
    "W5": [0.25, 0.25, 0.25, 0.25],
}
NOTICE_KINDS = [NoticeKind.NONE, NoticeKind.ACCURATE,
                NoticeKind.EARLY, NoticeKind.LATE]

# Theta/ALCF-flavored size mix (paper Fig. 3): most jobs 128-1024 nodes.
SIZE_BUCKETS = [(128, 256), (257, 512), (513, 1024), (1025, 2048), (2049, 4096)]
SIZE_WEIGHTS = [0.46, 0.26, 0.16, 0.08, 0.04]


def notice_mix(name: str) -> List[float]:
    """Look up a Table III notice mix; unknown names raise
    :class:`UnknownWorkloadError` listing the valid mixes."""
    try:
        return NOTICE_MIXES[name]
    except KeyError:
        raise UnknownWorkloadError(
            f"unknown notice mix {name!r}; valid mixes: "
            f"{', '.join(sorted(NOTICE_MIXES))}") from None


@dataclass
class WorkloadConfig:
    n_nodes: int = 4392
    n_jobs: int = 1500
    horizon_days: float = 14.0
    target_load: float = 1.05          # offered load vs capacity
    n_projects: int = 60
    frac_od_projects: float = 0.10     # paper §IV-B
    frac_rigid_projects: float = 0.60
    notice_mix: str = "W5"
    # on-demand burstiness (paper Fig. 5)
    od_burst_size: tuple = (2, 8)
    od_burst_window: float = 1800.0
    # runtime model
    runtime_median_s: float = 7200.0
    runtime_sigma: float = 1.1
    runtime_max_s: float = 86400.0
    runtime_min_s: float = 600.0
    estimate_factor: tuple = (1.0, 3.0)
    # overheads (paper §IV-B)
    rigid_setup_frac: tuple = (0.05, 0.10)
    malleable_setup_frac: tuple = (0.0, 0.05)
    malleable_min_frac: float = 0.20
    ckpt_overhead_small: float = 600.0   # < 1K nodes
    ckpt_overhead_large: float = 1200.0  # >= 1K nodes
    ckpt_freq_factor: float = 1.0        # 0.5 = twice as frequent as Daly
    node_mtbf_hours: float = 20000.0     # per-node MTBF for the Daly interval
    notice_lead: tuple = (900.0, 1800.0)  # 15-30 min
    late_window: float = 1800.0
    seed: int = 0


def daly_interval(delta: float, mtbf_job: float) -> float:
    """Daly's first-order optimal checkpoint interval."""
    if not math.isfinite(mtbf_job):
        return math.inf
    return max(math.sqrt(2.0 * delta * mtbf_job) - delta, delta)


def rigid_ckpt_params(size: int, overhead_small: float = 600.0,
                      overhead_large: float = 1200.0,
                      node_mtbf_hours: float = 20000.0,
                      freq_factor: float = 1.0) -> tuple:
    """``(delta, tau)`` of the rigid Daly checkpoint model (§IV-B).

    The single copy of the parameterization — the generator, the SWF
    annotator, and the type_mix transform all derive through it."""
    delta = overhead_small if size < 1000 else overhead_large
    mtbf_job = node_mtbf_hours * 3600.0 / size
    return delta, daly_interval(delta, mtbf_job) * freq_factor


# -------------------------------------------------------------------- models
def assign_project_types(rng: np.random.Generator, n_projects: int,
                         frac_od: float, frac_rigid: float) -> np.ndarray:
    """Shuffled per-project job types at the paper's §IV-A fractions.

    The single copy of the assignment rule — the generator, the SWF
    annotator, and the type_mix transform all draw through it."""
    proj_type = np.array(
        [JobType.ONDEMAND] * round(n_projects * frac_od)
        + [JobType.RIGID] * round(n_projects * frac_rigid),
        dtype=object)
    proj_type = np.concatenate(
        [proj_type,
         np.array([JobType.MALLEABLE] * (n_projects - len(proj_type)),
                  dtype=object)])
    rng.shuffle(proj_type)
    return proj_type


class ProjectModel:
    """Zipf-ish project activity and per-project job-type assignment."""

    def weights(self, cfg: WorkloadConfig) -> np.ndarray:
        w = 1.0 / np.arange(1, cfg.n_projects + 1) ** 0.8
        return w / w.sum()

    def types(self, rng: np.random.Generator,
              cfg: WorkloadConfig) -> np.ndarray:
        return assign_project_types(rng, cfg.n_projects,
                                    cfg.frac_od_projects,
                                    cfg.frac_rigid_projects)


class SizeModel:
    """Fig. 3 size buckets with log-uniform spread inside each bucket."""

    buckets: Sequence = SIZE_BUCKETS
    bucket_weights: Sequence = SIZE_WEIGHTS

    def sample(self, rng: np.random.Generator, cfg: WorkloadConfig,
               n: int) -> np.ndarray:
        picks = rng.choice(len(self.buckets), size=n, p=self.bucket_weights)
        lo = np.array([self.buckets[b][0] for b in picks])
        hi = np.array([self.buckets[b][1] for b in picks])
        sizes = np.exp(rng.uniform(np.log(lo), np.log(hi))).astype(int)
        return np.clip(sizes, 1, cfg.n_nodes)


class RuntimeModel:
    """Lognormal runtimes plus the user walltime-estimate inflation."""

    def sample(self, rng: np.random.Generator, cfg: WorkloadConfig,
               n: int) -> np.ndarray:
        runtimes = np.exp(rng.normal(np.log(cfg.runtime_median_s),
                                     cfg.runtime_sigma, n))
        return np.clip(runtimes, cfg.runtime_min_s, cfg.runtime_max_s)

    def estimate(self, rng: np.random.Generator, cfg: WorkloadConfig,
                 t_actual: float) -> float:
        t_est = float(t_actual * rng.uniform(*cfg.estimate_factor))
        return min(t_est, cfg.runtime_max_s * 3)


class _SubmitView:
    """Adapter exposing ``jobs[i].submit_time`` through the indexable
    get/set interface :meth:`ArrivalModel.burstify_times` rewrites, so
    the one burst algorithm serves both the materialized JobSpec list
    and the streaming path's numpy submit column."""

    __slots__ = ("jobs",)

    def __init__(self, jobs: List[JobSpec]):
        self.jobs = jobs

    def __getitem__(self, i: int) -> float:
        return self.jobs[i].submit_time

    def __setitem__(self, i: int, t: float) -> None:
        self.jobs[i].submit_time = t


class ArrivalModel:
    """Load-scaled uniform arrivals + bursty on-demand windows (Fig. 5)."""

    def sample(self, rng: np.random.Generator, cfg: WorkloadConfig,
               sizes: np.ndarray, runtimes: np.ndarray) -> np.ndarray:
        # scale arrivals so offered load ~= target_load of capacity
        total_work = float((sizes * runtimes).sum())
        span = total_work / (cfg.n_nodes * cfg.target_load)
        span = min(span, cfg.horizon_days * 86400.0)
        return np.sort(rng.uniform(0.0, span, len(sizes)))

    def burstify(self, rng: np.random.Generator, cfg: WorkloadConfig,
                 jobs: List[JobSpec],
                 od_members: Dict[int, List[int]]) -> None:
        """Cluster each project's on-demand jobs into short windows."""
        self.burstify_times(rng, cfg, _SubmitView(jobs), od_members)

    def burstify_times(self, rng: np.random.Generator, cfg: WorkloadConfig,
                       times, od_members: Dict[int, List[int]]) -> None:
        """The burst algorithm over an indexable submit-time container
        (``times[i]`` get/set) — the single copy both the materialized
        and the streaming (columnar) generator paths draw through."""
        for _p, idxs in od_members.items():
            k = 0
            while k < len(idxs):
                burst = int(rng.integers(*cfg.od_burst_size))
                anchor = times[idxs[k]]
                for j in idxs[k:k + burst]:
                    times[j] = float(
                        anchor + rng.uniform(0.0, cfg.od_burst_window))
                k += burst


class NoticeModel:
    """Table III notice kinds and lead/early/late time geometry.

    Source-agnostic: the SWF annotator and the notice-mix scenario
    transform reuse it on any list of on-demand jobs.  The draws are
    split from the arithmetic (``draw`` / ``apply_one``) because the
    draw *count* depends only on the kind, never on the job — which is
    what lets the streaming paths pre-draw the whole notice share of an
    RNG stream and attach it to jobs as they flow past later.
    ``assign`` is defined in terms of both, so subclasses override
    ``draw``/``apply_one`` (not ``assign``) to stay stream-consistent.
    """

    def draw(self, rng: np.random.Generator, n_od: int,
             mix: Sequence[float], lead: tuple = (900.0, 1800.0),
             late_window: float = 1800.0) -> List[tuple]:
        """All RNG for ``n_od`` on-demand jobs, in assign order:
        one ``(kind, lead_s, extra)`` tuple per job."""
        kinds = rng.choice(4, size=n_od, p=list(mix))
        out = []
        for kidx in kinds:
            kind = NOTICE_KINDS[int(kidx)]
            if kind is NoticeKind.NONE:
                out.append((kind, 0.0, 0.0))
                continue
            lead_s = float(rng.uniform(*lead))
            if kind is NoticeKind.ACCURATE:
                extra = 0.0
            elif kind is NoticeKind.EARLY:
                extra = float(rng.uniform(0.0, lead_s))
            else:  # LATE
                extra = float(rng.uniform(0.0, late_window))
            out.append((kind, lead_s, extra))
        return out

    @staticmethod
    def apply_one(j: JobSpec, drawn: tuple) -> None:
        """Set one job's notice fields from its pre-drawn tuple (pure
        arithmetic on the job's current submit time — no RNG)."""
        kind, lead_s, extra = drawn
        j.notice_kind = kind
        if kind is NoticeKind.NONE:
            j.notice_time = None
            j.est_arrival = None
            return
        arrival = j.submit_time
        if kind is NoticeKind.ACCURATE:
            j.notice_time = arrival - lead_s
            j.est_arrival = arrival
        elif kind is NoticeKind.EARLY:
            # actual arrival uniform in (notice, est_arrival)
            j.notice_time = arrival - extra
            j.est_arrival = j.notice_time + lead_s
        else:  # LATE: arrival within `late_window` after estimate
            j.est_arrival = arrival - extra
            j.notice_time = j.est_arrival - lead_s
        j.notice_time = max(j.notice_time, 0.0)

    def assign(self, rng: np.random.Generator, od_jobs: List[JobSpec],
               mix: Sequence[float], lead: tuple = (900.0, 1800.0),
               late_window: float = 1800.0) -> None:
        for j, drawn in zip(od_jobs, self.draw(rng, len(od_jobs), mix,
                                               lead, late_window)):
            self.apply_one(j, drawn)


# ----------------------------------------------------------------- generator
@register_source("theta")
class ThetaGenerator(WorkloadSource):
    """The synthetic Theta-like source, assembled from pluggable models.

    Registry params are WorkloadConfig fields (``get_source("theta",
    n_jobs=600, notice_mix="W2", seed=1)``); model instances are
    constructor-only (they are code, not data).  The default models
    replay the legacy ``generate`` draw-for-draw.
    """

    def __init__(self, cfg: Optional[WorkloadConfig] = None, *,
                 project_model: Optional[ProjectModel] = None,
                 size_model: Optional[SizeModel] = None,
                 runtime_model: Optional[RuntimeModel] = None,
                 arrival_model: Optional[ArrivalModel] = None,
                 notice_model: Optional[NoticeModel] = None,
                 **cfg_kw):
        if cfg is None:
            cfg = WorkloadConfig(**cfg_kw)
        elif cfg_kw:
            cfg = replace(cfg, **cfg_kw)
        self.cfg = cfg
        self.project_model = project_model or ProjectModel()
        self.size_model = size_model or SizeModel()
        self.runtime_model = runtime_model or RuntimeModel()
        self.arrival_model = arrival_model or ArrivalModel()
        self.notice_model = notice_model or NoticeModel()

    @property
    def n_nodes(self) -> int:
        return self.cfg.n_nodes

    def jobs(self) -> List[JobSpec]:
        cfg = self.cfg
        mix = notice_mix(cfg.notice_mix)  # fail fast, before any sampling
        rng = np.random.default_rng(cfg.seed)

        # ---- project pool with Zipf-ish activity --------------------------
        proj_w = self.project_model.weights(cfg)
        proj_type = self.project_model.types(rng, cfg)

        # ---- raw jobs ------------------------------------------------------
        projects = rng.choice(cfg.n_projects, size=cfg.n_jobs, p=proj_w)
        sizes = self.size_model.sample(rng, cfg, cfg.n_jobs)
        runtimes = self.runtime_model.sample(rng, cfg, cfg.n_jobs)
        arrivals = self.arrival_model.sample(rng, cfg, sizes, runtimes)

        jobs: List[JobSpec] = []
        od_members: Dict[int, List[int]] = {}
        for i in range(cfg.n_jobs):
            p = int(projects[i])
            jt: JobType = proj_type[p]
            size, t_act = int(sizes[i]), float(runtimes[i])
            if jt is JobType.ONDEMAND and size > cfg.n_nodes // 2:
                jt = JobType.RIGID if rng.random() < 0.5 else JobType.MALLEABLE
            t_est = self.runtime_model.estimate(rng, cfg, t_act)
            if jt is JobType.RIGID:
                setup = float(t_act * rng.uniform(*cfg.rigid_setup_frac))
                delta, tau = rigid_ckpt_params(
                    size, cfg.ckpt_overhead_small, cfg.ckpt_overhead_large,
                    cfg.node_mtbf_hours, cfg.ckpt_freq_factor)
                jobs.append(JobSpec(i, jt, f"proj{p}", float(arrivals[i]), size,
                                    t_est, t_act, t_setup=setup,
                                    ckpt_overhead=delta, ckpt_interval=tau))
            elif jt is JobType.MALLEABLE:
                setup = float(t_act * rng.uniform(*cfg.malleable_setup_frac))
                jobs.append(JobSpec(i, jt, f"proj{p}", float(arrivals[i]), size,
                                    t_est, t_act, t_setup=setup,
                                    n_min=max(1, math.ceil(
                                        cfg.malleable_min_frac * size))))
            else:
                setup = float(t_act * rng.uniform(*cfg.rigid_setup_frac))
                jobs.append(JobSpec(i, jt, f"proj{p}", float(arrivals[i]), size,
                                    t_est, t_act, t_setup=setup))
                od_members.setdefault(p, []).append(len(jobs) - 1)

        # ---- bursty on-demand arrivals + notice kinds (Table III) ----------
        self.arrival_model.burstify(rng, cfg, jobs, od_members)
        od_jobs = [j for j in jobs if j.jtype is JobType.ONDEMAND]
        self.notice_model.assign(rng, od_jobs, mix, lead=cfg.notice_lead,
                                 late_window=cfg.late_window)

        return canonicalize(jobs)

    # ------------------------------------------------------------- streaming
    # _columns() MUST stay draw-for-draw in sync with jobs() above — it is
    # the same algorithm with numeric columns in place of JobSpec objects
    # (tests/test_streaming.py pins the two paths sha256-identical).
    def _columns(self) -> dict:
        """Sample the whole trace into compact per-job columns (~100 B/job
        instead of a JobSpec object), deferring JobSpec construction to
        :meth:`iter_jobs` — the bounded-memory half of the generator.
        Memoized: trace_stats() and iter_jobs() share one sampling."""
        cached = getattr(self, "_columns_cache", None)
        if cached is not None:
            return cached
        cfg = self.cfg
        mix = notice_mix(cfg.notice_mix)  # fail fast, before any sampling
        rng = np.random.default_rng(cfg.seed)

        proj_w = self.project_model.weights(cfg)
        proj_type = self.project_model.types(rng, cfg)
        projects = rng.choice(cfg.n_projects, size=cfg.n_jobs, p=proj_w)
        sizes = self.size_model.sample(rng, cfg, cfg.n_jobs)
        runtimes = self.runtime_model.sample(rng, cfg, cfg.n_jobs)
        arrivals = self.arrival_model.sample(rng, cfg, sizes, runtimes)

        n = cfg.n_jobs
        jtype = np.empty(n, dtype=object)       # JobType per job
        submit = np.empty(n, dtype=np.float64)
        t_est = np.empty(n, dtype=np.float64)
        setup = np.empty(n, dtype=np.float64)
        od_members: Dict[int, List[int]] = {}
        od_order: List[int] = []
        for i in range(n):
            p = int(projects[i])
            jt: JobType = proj_type[p]
            size, t_act = int(sizes[i]), float(runtimes[i])
            if jt is JobType.ONDEMAND and size > cfg.n_nodes // 2:
                jt = JobType.RIGID if rng.random() < 0.5 else JobType.MALLEABLE
            t_est[i] = self.runtime_model.estimate(rng, cfg, t_act)
            if jt is JobType.RIGID:
                setup[i] = float(t_act * rng.uniform(*cfg.rigid_setup_frac))
            elif jt is JobType.MALLEABLE:
                setup[i] = float(t_act * rng.uniform(*cfg.malleable_setup_frac))
            else:
                setup[i] = float(t_act * rng.uniform(*cfg.rigid_setup_frac))
                od_members.setdefault(p, []).append(i)
                od_order.append(i)
            jtype[i] = jt
            submit[i] = float(arrivals[i])

        self.arrival_model.burstify_times(rng, cfg, submit, od_members)
        # od_order is jid order == the order jobs() collects od_jobs in
        notice = dict(zip(od_order,
                          self.notice_model.draw(rng, len(od_order), mix,
                                                 lead=cfg.notice_lead,
                                                 late_window=cfg.late_window)))
        order = np.argsort(submit, kind="stable")  # == canonicalize's sort
        self._columns_cache = {
            "jtype": jtype, "submit": submit, "t_est": t_est,
            "setup": setup, "sizes": sizes, "runtimes": runtimes,
            "projects": projects, "notice": notice, "order": order}
        return self._columns_cache

    def iter_jobs(self):
        """Yield the canonical trace lazily — job-for-job identical to
        ``jobs()`` (same RNG stream, same stable submit sort), but only
        one JobSpec is alive per step beyond the numeric columns."""
        cfg = self.cfg
        c = self._columns()
        jtype, submit, t_est, setup = (c["jtype"], c["submit"], c["t_est"],
                                       c["setup"])
        for new_id, i in enumerate(c["order"]):
            i = int(i)
            jt: JobType = jtype[i]
            size = int(c["sizes"][i])
            kw = {}
            if jt is JobType.RIGID:
                kw["ckpt_overhead"], kw["ckpt_interval"] = rigid_ckpt_params(
                    size, cfg.ckpt_overhead_small, cfg.ckpt_overhead_large,
                    cfg.node_mtbf_hours, cfg.ckpt_freq_factor)
            elif jt is JobType.MALLEABLE:
                kw["n_min"] = max(1, math.ceil(cfg.malleable_min_frac * size))
            j = JobSpec(new_id, jt, f"proj{int(c['projects'][i])}",
                        float(submit[i]), size, float(t_est[i]),
                        float(c["runtimes"][i]), t_setup=float(setup[i]),
                        **kw)
            if jt is JobType.ONDEMAND:
                self.notice_model.apply_one(j, c["notice"][i])
            yield j

    def trace_stats(self):
        from .base import TraceStats
        c = self._columns()
        if not len(c["order"]):
            return TraceStats(0, 0, 0.0, 0.0)
        return TraceStats(
            len(c["order"]),
            sum(jt is JobType.ONDEMAND for jt in c["jtype"]),
            float(c["submit"][c["order"][0]]),
            float(c["submit"][c["order"][-1]]))


def generate(cfg: WorkloadConfig) -> List[JobSpec]:
    """Legacy one-call entry point: the default-model "theta" source."""
    return ThetaGenerator(cfg).jobs()
