"""Admission queue: the live service's front door.

Producers (an API handler, an example script, a test) submit work as
:class:`~repro_torch.core.job.JobSpec`-shaped requests; the daemon drains the
queue between event batches and feeds specs to ``ServiceCore.admit``.
Thread-safe and bounded-free — on-demand inference requests and
malleable training submissions go through the same door, mirroring the
paper's hybrid workload.

Convenience constructors map service-level requests onto the spec
fields the policy stack understands:

* :meth:`AdmissionQueue.submit_inference` — an ONDEMAND job (the node
  demand of a serving burst), with optional advance notice so
  notice-aware mechanisms (CUA/CUP) can pre-vacate;
* :meth:`AdmissionQueue.submit_training` — a MALLEABLE job (an elastic
  training run the cluster may shrink for on-demand traffic);
* :meth:`AdmissionQueue.submit_rigid` — a RIGID batch job.

Bounded capacity (``maxsize``) adds backpressure — what happens when a
producer outruns the daemon is a policy choice (``backpressure``):

* ``"block"`` — the producer waits until the daemon drains (classic
  bounded queue; a slow daemon slows its clients);
* ``"shed-oldest-inference"`` — drop the oldest queued ONDEMAND spec to
  make room (latency-sensitive serving traffic is stale the moment it
  waits; training submissions are never shed).  If nothing is sheddable
  the submission is rejected instead;
* ``"reject"`` — raise :class:`AdmissionRejected` at the producer.

Shed / rejected / blocked events are counted in :attr:`counts` and
surfaced in the ShadowReport for live runs.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Dict, List, Optional

from repro_torch.core.job import JobSpec, JobType, NoticeKind

#: valid values for ``AdmissionQueue(backpressure=...)``
BACKPRESSURE_POLICIES = ("block", "shed-oldest-inference", "reject")


class AdmissionRejected(RuntimeError):
    """A submission was refused: the queue is at capacity and the
    backpressure policy could not make room."""


class AdmissionQueue:
    """Thread-safe FIFO of admitted :class:`JobSpec`.

    ``base_jid`` seeds the jid allocator; keep it above any replayed
    trace's jid range when mixing live admissions into a replay.
    ``maxsize=None`` (default) is unbounded — the legacy behavior.
    """

    def __init__(self, base_jid: int = 1_000_000,
                 maxsize: Optional[int] = None,
                 backpressure: str = "block"):
        if backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(f"unknown backpressure policy "
                             f"{backpressure!r}; pick one of "
                             f"{BACKPRESSURE_POLICIES}")
        if maxsize is not None and maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._jids = itertools.count(base_jid)
        self._closed = False
        self.maxsize = maxsize
        self.backpressure = backpressure
        self.n_submitted = 0
        self.counts: Dict[str, int] = {
            "submitted": 0, "shed": 0, "rejected": 0, "blocked": 0}

    # ------------------------------------------------------------- plumbing
    def _make_room(self) -> bool:
        """At-capacity handling under the non-blocking policies; returns
        True when the caller may enqueue.  Caller holds the lock."""
        if self.backpressure == "shed-oldest-inference":
            for i, spec in enumerate(self._q):
                if spec.jtype is JobType.ONDEMAND:
                    del self._q[i]
                    self.counts["shed"] += 1
                    return True
        self.counts["rejected"] += 1
        return False

    def put(self, spec: JobSpec, timeout: Optional[float] = None) -> JobSpec:
        """Enqueue one spec, honoring the backpressure policy when the
        queue is full.  Under ``"block"``, ``timeout`` bounds the wait
        (then :class:`AdmissionRejected` is raised)."""
        with self._cond:
            if self._closed:
                raise RuntimeError("admission queue is closed")
            if self.maxsize is not None and len(self._q) >= self.maxsize:
                if self.backpressure == "block":
                    self.counts["blocked"] += 1
                    ok = self._cond.wait_for(
                        lambda: self._closed or len(self._q) < self.maxsize,
                        timeout=timeout)
                    if self._closed:
                        raise RuntimeError("admission queue is closed")
                    if not ok:
                        self.counts["rejected"] += 1
                        raise AdmissionRejected(
                            f"queue full ({self.maxsize}) after "
                            f"{timeout}s wait")
                elif not self._make_room():
                    raise AdmissionRejected(
                        f"queue full ({self.maxsize}), policy "
                        f"{self.backpressure!r} could not make room")
            self._q.append(spec)
            self.n_submitted += 1
            self.counts["submitted"] += 1
        return spec

    def drain(self) -> List[JobSpec]:
        """Remove and return every pending spec (daemon-side)."""
        with self._cond:
            out = list(self._q)
            self._q.clear()
            self._cond.notify_all()       # wake blocked producers
        return out

    def close(self) -> None:
        """No further submissions; the daemon drains what remains and
        exits once the core is idle."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()       # unblock waiting producers

    @property
    def closed(self) -> bool:
        return self._closed

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def _next_jid(self, jid: Optional[int]) -> int:
        return next(self._jids) if jid is None else jid

    # ----------------------------------------------------------- front door
    def submit_inference(self, nodes: int, hold_s: float,
                         submit_time: float = 0.0, *,
                         notice_lead_s: Optional[float] = None,
                         project: str = "serve",
                         jid: Optional[int] = None) -> JobSpec:
        """On-demand serving demand: ``nodes`` for ``hold_s`` seconds.
        ``notice_lead_s`` announces it that many seconds ahead (clamped
        by the core if the lead is already in the past)."""
        notice = NoticeKind.NONE if notice_lead_s is None else NoticeKind.ACCURATE
        return self.put(JobSpec(
            jid=self._next_jid(jid), jtype=JobType.ONDEMAND, project=project,
            submit_time=submit_time, size=nodes,
            t_estimate=hold_s, t_actual=hold_s,
            notice_kind=notice,
            notice_time=None if notice_lead_s is None
            else submit_time - notice_lead_s,
            est_arrival=None if notice_lead_s is None else submit_time))

    def submit_training(self, n_max: int, runtime_s: float,
                        submit_time: float = 0.0, *, n_min: int = 0,
                        estimate_s: Optional[float] = None,
                        setup_s: float = 0.0, project: str = "train",
                        jid: Optional[int] = None) -> JobSpec:
        """Elastic (malleable) training run: may run anywhere in
        [n_min, n_max] nodes; ``runtime_s`` is the full-size runtime."""
        return self.put(JobSpec(
            jid=self._next_jid(jid), jtype=JobType.MALLEABLE, project=project,
            submit_time=submit_time, size=n_max,
            t_estimate=estimate_s or runtime_s * 1.5, t_actual=runtime_s,
            t_setup=setup_s, n_min=n_min))

    def submit_rigid(self, nodes: int, runtime_s: float,
                     submit_time: float = 0.0, *,
                     estimate_s: Optional[float] = None,
                     setup_s: float = 0.0, project: str = "batch",
                     jid: Optional[int] = None) -> JobSpec:
        """Fixed-size batch job."""
        return self.put(JobSpec(
            jid=self._next_jid(jid), jtype=JobType.RIGID, project=project,
            submit_time=submit_time, size=nodes,
            t_estimate=estimate_s or runtime_s * 1.5, t_actual=runtime_s,
            t_setup=setup_s))
