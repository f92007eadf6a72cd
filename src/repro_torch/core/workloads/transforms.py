"""Composable scenario transforms: trace rewrites that stack on any source.

Each transform is a registered :class:`ScenarioTransform` — pure trace
surgery, source-agnostic, applied by :meth:`Scenario.realize` in stack
order with one shared per-run RNG stream:

    load_scale     compress/stretch inter-arrival gaps (offered load x k)
    burst_inject   add synthetic on-demand bursts (§III-B stress)
    diurnal        warp arrivals onto a day/night intensity profile
    notice_mix     re-draw Table III notice kinds for on-demand jobs
    type_mix       reassign job types per project to new fractions

Transforms may mutate the input list and may leave it unsorted or with
stale/placeholder jids (new jobs use ``jid=-1``): Scenario.realize
re-canonicalizes (sort + renumber) after the whole stack.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Iterator, List, Optional

import numpy as np

from ..job import JobSpec, JobType, NoticeKind
from .base import ScenarioTransform, TraceStats, register_transform, \
    stream_index, stream_rank, tag_stream_rank
from .synthetic import NoticeModel, assign_project_types, notice_mix, \
    rigid_ckpt_params


def _shift_notice(j: JobSpec, delta: float) -> None:
    """Translate a job's notice geometry with its arrival (preserves the
    lead/early/late windows instead of scaling them)."""
    if j.notice_time is not None:
        j.notice_time = max(0.0, j.notice_time + delta)
    if j.est_arrival is not None:
        j.est_arrival = j.est_arrival + delta


@register_transform("load_scale")
class LoadScale(ScenarioTransform):
    """Scale offered load by ``factor`` by compressing the arrival span.

    factor > 1 packs the same work into a shorter span (heavier load);
    factor < 1 stretches it.  Runtimes and sizes are untouched; notice
    windows translate with their jobs.  Streamable: the arrival map is
    monotone and draws no RNG, so jobs rewrite one at a time.
    """

    streamable = True

    def __init__(self, factor: float = 1.0):
        if factor <= 0:
            raise ValueError(f"load_scale factor must be > 0, got {factor}")
        self.factor = factor

    def _move(self, j: JobSpec, t0: float) -> None:
        new_t = t0 + (j.submit_time - t0) / self.factor
        _shift_notice(j, new_t - j.submit_time)
        j.submit_time = new_t

    def apply(self, jobs: List[JobSpec], rng: np.random.Generator,
              n_nodes: int) -> List[JobSpec]:
        if not jobs or self.factor == 1.0:
            return jobs
        t0 = min(j.submit_time for j in jobs)
        for j in jobs:
            self._move(j, t0)
        return jobs

    def stream(self, jobs: Iterator[JobSpec], rng: np.random.Generator,
               n_nodes: int, stats: TraceStats) -> Iterator[JobSpec]:
        if stats.n_jobs == 0 or self.factor == 1.0:
            return jobs

        def gen():
            for j in jobs:
                self._move(j, stats.t0)
                yield j
        return gen()

    def stream_stats(self, stats: TraceStats) -> TraceStats:
        if stats.n_jobs == 0 or self.factor == 1.0:
            return stats
        # same float expression _move applies to the last arrival
        return replace(stats,
                       t1=stats.t0 + (stats.t1 - stats.t0) / self.factor)


@register_transform("burst_inject")
class BurstInject(ScenarioTransform):
    """Inject synthetic on-demand bursts into an existing trace.

    Emulates the paper's Fig. 5 behavior at adversarial intensity: a
    project fires ``burst_size`` on-demand jobs inside ``window`` seconds
    at ``n_bursts`` random anchors across the trace span.  Injected jobs
    draw sizes log-uniform in ``size`` — clipped to the half-system
    on-demand cap (paper §IV-A) — and runtimes log-uniform in
    ``runtime``; a ``mix`` (Table III name) gives them advance notice.

    Streamable via a *tagged merge stage*: every draw depends only on
    the span endpoints and system size, so ``stream`` draws the whole
    injected set eagerly (bounded: at most ``n_bursts x burst_size[1]``
    jobs), tags each injected job with the next stream rank, and merges
    them into the flow in submit order with base-first tie-breaks —
    bit-identical to what ``canonicalize``'s stable sort does to the
    appended materialized list, while the base trace itself never
    materializes.  ``stream_stats`` then republishes exact counts/span
    of the drawn set (it runs after ``stream``, per the contract).
    """

    streamable = True

    def __init__(self, n_bursts: int = 3, burst_size: tuple = (2, 8),
                 window: float = 1800.0, size: tuple = (64, 256),
                 runtime: tuple = (600.0, 7200.0),
                 estimate_factor: tuple = (1.0, 3.0),
                 mix: Optional[str] = None,
                 notice_lead: tuple = (900.0, 1800.0),
                 late_window: float = 1800.0):
        self.n_bursts = n_bursts
        self.burst_size = burst_size
        self.window = window
        self.size = size
        self.runtime = runtime
        self.estimate_factor = estimate_factor
        self.mix = mix
        self.notice_lead = notice_lead
        self.late_window = late_window

    def _draw_injected(self, rng: np.random.Generator, n_nodes: int,
                       t0: float, t1: float) -> List[JobSpec]:
        """The single copy of the injection draw sequence, shared by the
        materialized and streaming paths (same RNG consumption order)."""
        od_cap = max(1, n_nodes // 2)
        injected: List[JobSpec] = []
        for b in range(self.n_bursts):
            anchor = float(rng.uniform(t0, max(t0, t1 - self.window)))
            count = int(rng.integers(self.burst_size[0],
                                     self.burst_size[1] + 1))
            for _ in range(count):
                size = int(np.exp(rng.uniform(math.log(self.size[0]),
                                              math.log(self.size[1]))))
                size = min(max(size, 1), od_cap)
                t_act = float(np.exp(rng.uniform(math.log(self.runtime[0]),
                                                 math.log(self.runtime[1]))))
                t_est = float(t_act * rng.uniform(*self.estimate_factor))
                injected.append(JobSpec(
                    -1, JobType.ONDEMAND, f"odburst{b}",
                    anchor + float(rng.uniform(0.0, self.window)),
                    size, t_est, t_act))
        if self.mix is not None:
            NoticeModel().assign(rng, injected, notice_mix(self.mix),
                                 lead=self.notice_lead,
                                 late_window=self.late_window)
        return injected

    def apply(self, jobs: List[JobSpec], rng: np.random.Generator,
              n_nodes: int) -> List[JobSpec]:
        if not jobs:
            return jobs
        t0 = min(j.submit_time for j in jobs)
        t1 = max(j.submit_time for j in jobs)
        jobs.extend(self._draw_injected(rng, n_nodes, t0, t1))
        return jobs

    def stream(self, jobs: Iterator[JobSpec], rng: np.random.Generator,
               n_nodes: int, stats: TraceStats) -> Iterator[JobSpec]:
        self._injected: List[JobSpec] = []
        if stats.n_jobs == 0:
            return jobs
        injected = self._draw_injected(rng, n_nodes, stats.t0, stats.t1)
        # injected jobs sort AFTER every incoming job on submit-time ties
        # (stable sort over the appended list); their rank lets
        # downstream per-od transforms reconstruct that appended order
        rank = len(stats.od_rank_counts or (stats.n_od,))
        for i, j in enumerate(injected):
            tag_stream_rank(j, rank, i)
        self._injected = injected
        merged = sorted(injected, key=lambda j: j.submit_time)

        def gen():
            it = iter(merged)
            nxt = next(it, None)
            for j in jobs:
                while nxt is not None and nxt.submit_time < j.submit_time:
                    yield nxt
                    nxt = next(it, None)
                yield j
            while nxt is not None:
                yield nxt
                nxt = next(it, None)
        return gen()

    def stream_stats(self, stats: TraceStats) -> TraceStats:
        injected = getattr(self, "_injected", [])
        if not injected:
            return stats
        subs = [j.submit_time for j in injected]
        counts = stats.od_rank_counts or (stats.n_od,)
        return replace(stats,
                       n_jobs=stats.n_jobs + len(injected),
                       n_od=stats.n_od + len(injected),
                       t0=min(stats.t0, min(subs)),
                       t1=max(stats.t1, max(subs)),
                       od_rank_counts=counts + (len(injected),))


@register_transform("diurnal")
class DiurnalModulation(ScenarioTransform):
    """Warp arrival times onto a diurnal intensity profile.

    Remaps the trace span through the inverse cumulative intensity of
    ``lambda(t) = 1 + amplitude * cos(2*pi*(t - peak)/period)``, so
    arrival density concentrates around ``peak`` each ``period`` while
    the span endpoints and the job count are preserved.  ``amplitude``
    must stay below 1 (intensity must remain positive for the warp to be
    monotone).  Streamable: the warp is a monotone per-job map built
    from the span endpoints alone, with no RNG.
    """

    streamable = True

    def __init__(self, amplitude: float = 0.6, period: float = 86400.0,
                 peak: float = 14 * 3600.0, grid: int = 4096):
        if not 0.0 <= amplitude < 1.0:
            raise ValueError(
                f"diurnal amplitude must be in [0, 1), got {amplitude}")
        self.amplitude = amplitude
        self.period = period
        self.peak = peak
        self.grid = grid

    def _cumulative(self, t: np.ndarray, t0: float) -> np.ndarray:
        w = 2.0 * math.pi / self.period
        return ((t - t0)
                + self.amplitude / w * (np.sin(w * (t - self.peak))
                                        - math.sin(w * (t0 - self.peak))))

    def _warp(self, j: JobSpec, t0: float, t1: float, grid: np.ndarray,
              cum: np.ndarray, total: float) -> None:
        # uniform position along the span -> inverse-CDF of lambda
        target = (j.submit_time - t0) / (t1 - t0) * total
        new_t = float(np.interp(target, cum, grid))
        _shift_notice(j, new_t - j.submit_time)
        j.submit_time = new_t

    def apply(self, jobs: List[JobSpec], rng: np.random.Generator,
              n_nodes: int) -> List[JobSpec]:
        if len(jobs) < 2 or self.amplitude == 0.0:
            return jobs
        t0 = min(j.submit_time for j in jobs)
        t1 = max(j.submit_time for j in jobs)
        if t1 <= t0:
            return jobs
        grid = np.linspace(t0, t1, self.grid)
        cum = self._cumulative(grid, t0)  # monotone since amplitude < 1
        total = cum[-1]
        for j in jobs:
            self._warp(j, t0, t1, grid, cum, total)
        return jobs

    def stream(self, jobs: Iterator[JobSpec], rng: np.random.Generator,
               n_nodes: int, stats: TraceStats) -> Iterator[JobSpec]:
        t0, t1 = stats.t0, stats.t1
        if stats.n_jobs < 2 or self.amplitude == 0.0 or t1 <= t0:
            return jobs
        grid = np.linspace(t0, t1, self.grid)
        cum = self._cumulative(grid, t0)
        total = cum[-1]

        def gen():
            for j in jobs:
                self._warp(j, t0, t1, grid, cum, total)
                yield j
        return gen()
        # span endpoints are fixed points of the warp: stats unchanged


@register_transform("notice_mix")
class NoticeMixOverride(ScenarioTransform):
    """Re-draw every on-demand job's notice kind from a Table III mix.

    Turns any source/scenario into its W1-W5 variants without touching
    arrival or size structure — the knob behind the paper-mix presets.
    Streamable: the draw count per on-demand job depends only on its
    drawn kind, so the whole notice share of the RNG stream is
    pre-drawn from ``stats.n_od`` (:meth:`NoticeModel.draw`) and
    attached to on-demand jobs as they flow past, in stream order —
    exactly the order ``apply`` walks the materialized list.
    """

    streamable = True

    def __init__(self, mix: str = "W5", notice_lead: tuple = (900.0, 1800.0),
                 late_window: float = 1800.0):
        self.mix = mix
        self.notice_lead = notice_lead
        self.late_window = late_window

    def apply(self, jobs: List[JobSpec], rng: np.random.Generator,
              n_nodes: int) -> List[JobSpec]:
        od = [j for j in jobs if j.jtype is JobType.ONDEMAND]
        NoticeModel().assign(rng, od, notice_mix(self.mix),
                             lead=self.notice_lead,
                             late_window=self.late_window)
        return jobs

    def stream(self, jobs: Iterator[JobSpec], rng: np.random.Generator,
               n_nodes: int, stats: TraceStats) -> Iterator[JobSpec]:
        # all RNG consumed here, before the first job flows (stack order)
        drawn = NoticeModel().draw(rng, stats.n_od, notice_mix(self.mix),
                                   lead=self.notice_lead,
                                   late_window=self.late_window)
        # materialized assign order is base-od-then-injected (the
        # appended list), while a merged stream interleaves by submit
        # time: each od job's drawn tuple is indexed by its rank's
        # offset plus its position within the rank.  Base (rank-0) jobs
        # keep encounter order (monotone stages preserve it); injected
        # jobs carry their materialized position in their stream tag.
        offsets = stats.od_rank_offsets()

        def gen():
            base_seen = 0
            for j in jobs:
                if j.jtype is JobType.ONDEMAND:
                    r = stream_rank(j)
                    if r == 0:
                        idx, base_seen = base_seen, base_seen + 1
                    else:
                        idx = stream_index(j)
                    NoticeModel.apply_one(j, drawn[offsets[r] + idx])
                yield j
        return gen()


@register_transform("type_mix")
class TypeMixReassign(ScenarioTransform):
    """Reassign job types per project to new od/rigid/malleable fractions.

    Projects are re-labelled wholesale (the paper's per-project rule), so
    submission locality survives; demoted jobs lose their on-demand
    fields, promoted malleables gain ``n_min``, promoted rigids gain a
    Daly checkpoint interval (same §IV-B parameters as the generator),
    and newly on-demand jobs larger than ``od_max_size`` (default: half
    the system, the generator's rule) are bounced back to
    rigid/malleable.  ``mix`` (a Table III name) re-draws notice for the
    resulting on-demand set.
    """

    def __init__(self, frac_od: float = 0.10, frac_rigid: float = 0.60,
                 malleable_min_frac: float = 0.20,
                 od_max_size: Optional[int] = None, mix: str = "W5",
                 notice_lead: tuple = (900.0, 1800.0),
                 late_window: float = 1800.0,
                 ckpt_overhead_small: float = 600.0,
                 ckpt_overhead_large: float = 1200.0,
                 ckpt_freq_factor: float = 1.0,
                 node_mtbf_hours: float = 20000.0):
        if frac_od < 0 or frac_rigid < 0 or frac_od + frac_rigid > 1:
            raise ValueError("type_mix fractions must be >= 0 and sum <= 1")
        self.frac_od = frac_od
        self.frac_rigid = frac_rigid
        self.malleable_min_frac = malleable_min_frac
        self.od_max_size = od_max_size
        self.mix = mix
        self.notice_lead = notice_lead
        self.late_window = late_window
        self.ckpt_overhead_small = ckpt_overhead_small
        self.ckpt_overhead_large = ckpt_overhead_large
        self.ckpt_freq_factor = ckpt_freq_factor
        self.node_mtbf_hours = node_mtbf_hours

    def apply(self, jobs: List[JobSpec], rng: np.random.Generator,
              n_nodes: int) -> List[JobSpec]:
        if not jobs:
            return jobs
        od_cap = (self.od_max_size if self.od_max_size is not None
                  else n_nodes // 2)
        projects = sorted({j.project for j in jobs})
        ptypes = assign_project_types(rng, len(projects), self.frac_od,
                                      self.frac_rigid)
        type_of = dict(zip(projects, ptypes))
        for j in jobs:
            jt: JobType = type_of[j.project]
            if jt is JobType.ONDEMAND and j.size > od_cap:
                jt = JobType.RIGID if rng.random() < 0.5 else JobType.MALLEABLE
            j.jtype = jt
            j.notice_kind = NoticeKind.NONE
            j.notice_time = None
            j.est_arrival = None
            if jt is JobType.MALLEABLE:
                j.n_min = max(1, math.ceil(self.malleable_min_frac * j.size))
            else:
                j.n_min = 0
            if jt is JobType.RIGID:
                if j.ckpt_interval >= math.inf:
                    # promoted rigid: same Daly model the generator applies
                    j.ckpt_overhead, j.ckpt_interval = rigid_ckpt_params(
                        j.size, self.ckpt_overhead_small,
                        self.ckpt_overhead_large, self.node_mtbf_hours,
                        self.ckpt_freq_factor)
            else:
                j.ckpt_overhead = 0.0
                j.ckpt_interval = math.inf
        od = [j for j in jobs if j.jtype is JobType.ONDEMAND]
        NoticeModel().assign(rng, od, notice_mix(self.mix),
                             lead=self.notice_lead,
                             late_window=self.late_window)
        return jobs
