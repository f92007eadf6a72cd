"""Launch backends: how the service's decisions become execution.

The decision core narrates placements (start / resize / preempt /
finish); a :class:`Launcher` turns them into work:

    DryrunLauncher       shadow mode (CPU-only CI): no model runs, but
                         the action stream is *validated* against a node
                         ledger — an illegal sequence (double start,
                         resize of a non-running job, capacity overflow)
                         raises ShadowLaunchError, in the spirit of
                         repro.launch.dryrun proving configs coherent
                         without hardware.  On-demand starts synthesize
                         the deterministic inference-request batch that
                         WOULD be admitted to ServeEngine.
    LiveClusterLauncher  decisions drive a real LiveCluster: batch jobs
                         become ElasticJob training runs, on-demand
                         starts vacate nodes through the cluster's own
                         registry-resolved arrival policy and serve an
                         inference batch, leases return on completion.

A launcher never makes decisions — it executes (or records) them, so a
shadow run and a live run see the identical decision sequence.
"""
from __future__ import annotations

import random
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core.job import JobSpec, JobType
from repro_torch.core.simulator import JobRecord


class ShadowLaunchError(RuntimeError):
    """The decision stream asked the launcher for an impossible action —
    a scheduler-core invariant was violated."""


class TransientLaunchError(RuntimeError):
    """A backend action failed in a way that retrying may fix (node
    momentarily unreachable, RPC timeout, ...).  RetryingLauncher
    retries these; anything else it treats as persistent."""


class Launcher:
    """No-op base; every hook receives already-made decisions."""

    def start_job(self, job: JobSpec, size: int) -> None:
        """Job placed on ``size`` nodes (on-demand included)."""

    def resize(self, job: JobSpec, new_size: int) -> None:
        """Running malleable shrunk/expanded to ``new_size`` nodes."""

    def preempt(self, job: JobSpec) -> None:
        """Running job vacated (will re-queue and start again later)."""

    def finish(self, rec: JobRecord) -> None:
        """Job reached its END event (record carries completion state)."""

    def tick(self) -> None:
        """Called once per daemon loop iteration — live backends use it
        to advance real work (training steps) between decisions."""

    def close(self) -> None:
        """Replay drained; release any live resources."""


class NullLauncher(Launcher):
    """Decisions logged, nothing executed (fidelity reference runs)."""


def plan_requests(job: JobSpec, max_batch: int = 8,
                  vocab: int = 1024) -> List[dict]:
    """The deterministic inference-request batch an on-demand job admits
    to the serving engine: one request per node up to ``max_batch``,
    prompt length and token budget derived from the jid so shadow and
    live runs plan the identical batch."""
    n = max(1, min(int(job.size), max_batch))
    return [{"rid": job.jid * max_batch + i,
             "prompt_len": 8 + (job.jid * 7 + i * 3) % 56,
             "max_new_tokens": 16,
             "vocab": vocab}
            for i in range(n)]


@dataclass
class _ShadowJob:
    size: int
    jtype: str
    n_starts: int = 1
    n_resizes: int = 0
    n_preempts: int = 0


class DryrunLauncher(Launcher):
    """Validating shadow backend.

    Keeps a node-count ledger mirroring what execution would occupy and
    checks every action against it; records a per-job action history and
    aggregate counters (the benchmark/CI artifact).  ``n_nodes=None``
    skips the capacity check (unknown machine size).
    """

    def __init__(self, n_nodes: Optional[int] = None):
        self.n_nodes = n_nodes
        self.active: Dict[int, _ShadowJob] = {}
        self.counts: Dict[str, int] = {
            "start": 0, "od_start": 0, "resize": 0, "preempt": 0,
            "finish": 0, "requests_planned": 0}
        self.request_plans: Dict[int, List[dict]] = {}

    # ------------------------------------------------------------- helpers
    def _occupied(self) -> int:
        return sum(j.size for j in self.active.values())

    def _check_capacity(self) -> None:
        if self.n_nodes is not None and self._occupied() > self.n_nodes:
            raise ShadowLaunchError(
                f"decision stream over-commits the machine: "
                f"{self._occupied()} > {self.n_nodes} nodes occupied")

    # --------------------------------------------------------------- hooks
    def start_job(self, job: JobSpec, size: int) -> None:
        if job.jid in self.active:
            raise ShadowLaunchError(f"job {job.jid} started while running")
        if size <= 0:
            raise ShadowLaunchError(f"job {job.jid} started on {size} nodes")
        self.active[job.jid] = _ShadowJob(size=size, jtype=job.jtype.value)
        self._check_capacity()
        self.counts["start"] += 1
        if job.jtype is JobType.ONDEMAND:
            self.counts["od_start"] += 1
            plan = plan_requests(job)
            self.request_plans[job.jid] = plan
            self.counts["requests_planned"] += len(plan)

    def resize(self, job: JobSpec, new_size: int) -> None:
        sj = self.active.get(job.jid)
        if sj is None:
            raise ShadowLaunchError(f"resize of non-running job {job.jid}")
        if not (0 < new_size <= job.n_max) or \
                (job.jtype is JobType.MALLEABLE and new_size < job.n_min):
            raise ShadowLaunchError(
                f"job {job.jid} resized to {new_size} outside "
                f"[{job.n_min}, {job.n_max}]")
        sj.size = new_size
        sj.n_resizes += 1
        self._check_capacity()
        self.counts["resize"] += 1

    def preempt(self, job: JobSpec) -> None:
        sj = self.active.pop(job.jid, None)
        if sj is None:
            raise ShadowLaunchError(f"preempt of non-running job {job.jid}")
        self.counts["preempt"] += 1

    def finish(self, rec: JobRecord) -> None:
        if self.active.pop(rec.job.jid, None) is None:
            raise ShadowLaunchError(
                f"finish of non-running job {rec.job.jid}")
        self.counts["finish"] += 1

    def close(self) -> None:
        if self.active:
            raise ShadowLaunchError(
                f"replay drained with jobs still marked running: "
                f"{sorted(self.active)}")


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter for flaky backend actions.

    Delay before attempt ``i`` (1-based retries) is drawn uniformly in
    ``[0, min(max_delay_s, base_delay_s * 2**(i-1))]`` — the classic
    full-jitter scheme that decorrelates thundering retries.  The jitter
    stream is its own seeded :class:`random.Random`, so retry timing
    never touches the simulator's RNGs (decision determinism is
    unaffected by how flaky the backend is).
    """

    retries: int = 3              # attempts AFTER the first try
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    timeout_s: Optional[float] = None   # per-attempt wall budget
    jitter: bool = True
    seed: int = 0


class RetryingLauncher(Launcher):
    """Wrap a launcher so transient backend failures do not kill the
    daemon.

    Each hook is tried up to ``1 + policy.retries`` times; only
    :class:`TransientLaunchError` (and, with ``timeout_s``, a transient
    attempt that overran its wall budget) is retried.
    :class:`ShadowLaunchError` is a *scheduler* invariant violation and
    is always re-raised immediately — retrying an illegal decision
    cannot make it legal.  When retries are exhausted (or the error is
    persistent and not a shadow error) the failure goes to
    ``on_give_up(action, job_or_rec, exc)`` if provided — the daemon
    uses this to log a ``launch_failed`` row and quarantine a node —
    else it is swallowed with a warning: the decision stream must keep
    flowing even when the backend cannot keep up.
    """

    def __init__(self, inner: Launcher, policy: Optional[RetryPolicy] = None,
                 on_give_up: Optional[Callable[[str, object, Exception],
                                               None]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self.on_give_up = on_give_up
        self._sleep = sleep
        self._rng = random.Random(self.policy.seed)
        self.launch_retries = 0
        self.launch_failures = 0

    # ------------------------------------------------------------- plumbing
    def _delay(self, attempt: int) -> float:
        cap = min(self.policy.max_delay_s,
                  self.policy.base_delay_s * (2 ** attempt))
        return self._rng.uniform(0.0, cap) if self.policy.jitter else cap

    def _call(self, action: str, subject, fn, *args) -> None:
        p = self.policy
        for attempt in range(1 + p.retries):
            t0 = time.monotonic()
            try:
                fn(*args)
                return
            except ShadowLaunchError:
                raise                     # invariant violation — always fatal
            except TransientLaunchError as exc:
                if p.timeout_s is not None and \
                        time.monotonic() - t0 > p.timeout_s:
                    err: Exception = TimeoutError(
                        f"{action} attempt exceeded {p.timeout_s}s "
                        f"budget ({exc})")
                else:
                    err = exc
                if attempt < p.retries:
                    self.launch_retries += 1
                    self._sleep(self._delay(attempt))
                    continue
                return self._give_up(action, subject, err)
            except Exception as exc:      # persistent — no point retrying
                return self._give_up(action, subject, exc)

    def _give_up(self, action: str, subject, exc: Exception) -> None:
        self.launch_failures += 1
        if self.on_give_up is not None:
            self.on_give_up(action, subject, exc)
        else:
            warnings.warn(f"launcher {action} gave up after retries: {exc}",
                          RuntimeWarning)

    # --------------------------------------------------------------- hooks
    def start_job(self, job: JobSpec, size: int) -> None:
        self._call("start", job, self.inner.start_job, job, size)

    def resize(self, job: JobSpec, new_size: int) -> None:
        self._call("resize", job, self.inner.resize, job, new_size)

    def preempt(self, job: JobSpec) -> None:
        self._call("preempt", job, self.inner.preempt, job)

    def finish(self, rec: JobRecord) -> None:
        self._call("finish", rec, self.inner.finish, rec)

    def tick(self) -> None:
        self.inner.tick()

    def close(self) -> None:
        self.inner.close()

    @property
    def counts(self) -> Dict[str, int]:
        inner = getattr(self.inner, "counts", None)
        out = dict(inner) if inner is not None else {}
        out["launch_retries"] = self.launch_retries
        out["launch_failures"] = self.launch_failures
        return out


class LiveClusterLauncher(Launcher):
    """Execute decisions on a real :class:`repro_torch.runtime.LiveCluster`.

    ``job_factory(job: JobSpec) -> ElasticJob`` builds the training
    payload for rigid/malleable jobs; ``serve_fn(job, node_ids)`` (if
    given) runs the inference batch for an on-demand start on the nodes
    the cluster vacated.  The *cluster's own* registry-resolved arrival
    policy picks shrink/preemption victims when on-demand demand arrives
    — the service's shadow ledger stays authoritative for WHAT starts
    WHEN, the cluster for WHICH physical nodes move (see
    docs/service.md).  Shrink/expand decisions for batch jobs are
    handled by the cluster's own lease mechanics, so :meth:`resize` and
    :meth:`preempt` only track counters here.
    """

    def __init__(self, cluster, job_factory: Callable[[JobSpec], object],
                 serve_fn: Optional[Callable[[JobSpec, List[int]], object]]
                 = None, steps_per_tick: int = 1,
                 target_steps: int = 20):
        self.cluster = cluster
        self.job_factory = job_factory
        self.serve_fn = serve_fn
        self.steps_per_tick = steps_per_tick
        self.target_steps = target_steps
        self.od_nodes: Dict[int, List[int]] = {}
        self.infos: Dict[int, object] = {}
        self.served: List[object] = []

    def start_job(self, job: JobSpec, size: int) -> None:
        if job.jtype is JobType.ONDEMAND:
            nodes = self.cluster.acquire_for_ondemand(size)
            self.od_nodes[job.jid] = nodes
            if self.serve_fn is not None:
                self.served.append(self.serve_fn(job, nodes))
            return
        if job.jid in self.infos:       # restart after preemption
            return                      # cluster resumes it on free nodes
        ej = self.job_factory(job)
        n_min = job.n_min if job.jtype is JobType.MALLEABLE else size
        self.infos[job.jid] = self.cluster.submit(
            ej, min_nodes=max(1, n_min), max_nodes=size,
            target_steps=self.target_steps)

    def finish(self, rec: JobRecord) -> None:
        nodes = self.od_nodes.pop(rec.job.jid, None)
        if nodes is not None:
            self.cluster.release_ondemand(nodes)

    def tick(self) -> None:
        self.cluster.step_all(self.steps_per_tick)

    def close(self) -> None:
        for jid, nodes in list(self.od_nodes.items()):
            self.cluster.release_ondemand(nodes)
            del self.od_nodes[jid]
