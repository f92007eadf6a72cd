"""Job model for hybrid workloads (paper §III-A).

Three job classes share one JobSpec; class-specific fields are optional.
All times are seconds (simulation clock), sizes are node counts.

Work accounting:
  * rigid:     size fixed; trace runtime t_actual already includes setup and
               regular checkpoints (the uninterrupted wall time).  Compute
               structure: [setup][tau work][delta ckpt][tau work]... so an
               uninterrupted run completes at start + t_actual, exactly as
               in the trace (baseline-faithful).
  * malleable: work = (t_actual - setup) * n_max node-seconds; runtime at
               size n is work/n + setup (linear speedup, paper §III-A).
  * on-demand: behaves like rigid w.r.t. execution, but is never preempted
               and must start instantly; may send advance notice.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Optional


class JobType(enum.Enum):
    RIGID = "rigid"
    ONDEMAND = "ondemand"
    MALLEABLE = "malleable"


class NoticeKind(enum.Enum):
    """Four on-demand categories (paper Fig. 1)."""

    NONE = "no_notice"
    ACCURATE = "accurate"
    EARLY = "arrive_early"
    LATE = "arrive_late"


@dataclass
class JobSpec:
    jid: int
    jtype: JobType
    project: str
    submit_time: float          # actual arrival on the system
    size: int                   # rigid/od: fixed n; malleable: n_max
    t_estimate: float           # user walltime estimate (kill limit)
    t_actual: float             # trace runtime at full size (incl. setup)
    t_setup: float = 0.0
    # --- malleable only ---
    n_min: int = 0
    # --- on-demand only ---
    notice_kind: NoticeKind = NoticeKind.NONE
    notice_time: Optional[float] = None      # when advance notice is received
    est_arrival: Optional[float] = None      # arrival estimate in the notice
    # --- rigid only: checkpointing ---
    ckpt_overhead: float = 0.0               # delta, s per checkpoint
    ckpt_interval: float = math.inf          # tau, s of compute per segment

    def __post_init__(self) -> None:
        if self.jtype is JobType.MALLEABLE and self.n_min <= 0:
            self.n_min = max(1, math.ceil(0.2 * self.size))
        self.t_actual = min(self.t_actual, self.t_estimate)

    # -- derived quantities ------------------------------------------------
    @property
    def n_max(self) -> int:
        return self.size

    @property
    def compute_time(self) -> float:
        """Pure compute wall time at full size (excl. setup and ckpts)."""
        t = self.t_actual - self.t_setup
        if self.jtype is JobType.RIGID and self.ckpt_interval < math.inf:
            # t = k segments of (tau + delta) + partial tau  =>  remove deltas
            full, tail = divmod(t, self.ckpt_interval + self.ckpt_overhead)
            t = full * self.ckpt_interval + min(tail, self.ckpt_interval)
        return max(t, 0.0)

    @property
    def work(self) -> float:
        """Total useful work in node-seconds."""
        return self.compute_time * self.size


@dataclass
class RunState:
    """Mutable per-execution state of a running job."""

    job: JobSpec
    start_time: float           # start of *this* execution (after resume)
    cur_size: int
    done_work: float = 0.0      # node-seconds completed before this start
    ckpt_work: float = 0.0      # node-seconds safely checkpointed (rigid)
    epoch: int = 0              # invalidates stale END events
    borrowed: dict = field(default_factory=dict)  # od_jid -> nodes borrowed
    last_resize: float = 0.0    # time of last size change (= start initially)
    work_at_resize: float = 0.0 # done_work as of last_resize
    n_starts: int = 1           # setups paid so far
    shrunk_by: dict = field(default_factory=dict)  # od_jid -> nodes lent

    def __post_init__(self) -> None:
        self.last_resize = self.start_time + self.job.t_setup
        self.work_at_resize = self.done_work

    # -- progress ----------------------------------------------------------
    def compute_elapsed(self, now: float) -> float:
        """Seconds of compute progress in the current execution at `now`."""
        return max(0.0, now - self.last_resize)

    def work_done(self, now: float) -> float:
        """Total useful node-seconds completed by `now` (this run incl.)."""
        j = self.job
        elapsed = self.compute_elapsed(now)
        if j.jtype is JobType.RIGID and j.ckpt_interval < math.inf:
            # subtract checkpoint overheads interleaved with compute
            seg = j.ckpt_interval + j.ckpt_overhead
            full, tail = divmod(elapsed, seg)
            elapsed = full * j.ckpt_interval + min(tail, j.ckpt_interval)
        return min(self.work_at_resize + elapsed * self.cur_size, j.work)

    def remaining_work(self, now: float) -> float:
        return max(0.0, self.job.work - self.work_done(now))

    def natural_end(self, now: float) -> float:
        """Wall time at which remaining work completes at current size."""
        j = self.job
        rem_compute = self.remaining_work(now) / max(self.cur_size, 1)
        if j.jtype is JobType.RIGID and j.ckpt_interval < math.inf:
            # re-add future checkpoint overheads
            done_compute = self.work_done(now) / j.size
            k_before = math.floor(done_compute / j.ckpt_interval)
            k_after = math.floor((done_compute + rem_compute) / j.ckpt_interval)
            # no checkpoint right at completion
            if (done_compute + rem_compute) % j.ckpt_interval == 0 and k_after > 0:
                k_after -= 1
            rem_compute += (k_after - k_before) * j.ckpt_overhead
        setup_left = max(0.0, self.last_resize - now)
        return now + setup_left + rem_compute

    # -- checkpoint bookkeeping (rigid) --------------------------------------
    def checkpointed_work(self, now: float) -> float:
        """Node-seconds protected by the latest completed checkpoint."""
        j = self.job
        if j.jtype is not JobType.RIGID or j.ckpt_interval >= math.inf:
            return self.ckpt_work
        elapsed = self.compute_elapsed(now)
        seg = j.ckpt_interval + j.ckpt_overhead
        k = math.floor(elapsed / seg)
        partial = elapsed - k * seg
        if partial >= j.ckpt_interval + j.ckpt_overhead:  # pragma: no cover
            k += 1
        elif partial >= j.ckpt_interval:
            pass  # checkpoint in progress, not yet complete
        run_ckpt = k * j.ckpt_interval * self.cur_size
        return max(self.ckpt_work, self.work_at_resize + run_ckpt)

    def next_ckpt_completion(self, now: float) -> Optional[float]:
        """Wall time when the next checkpoint finishes (rigid), else None."""
        j = self.job
        if j.jtype is not JobType.RIGID or j.ckpt_interval >= math.inf:
            return None
        base = self.last_resize
        elapsed = max(0.0, now - base)
        seg = j.ckpt_interval + j.ckpt_overhead
        k = math.floor(elapsed / seg)
        t_next = base + k * seg + j.ckpt_interval + j.ckpt_overhead
        if t_next <= now:
            t_next += seg
        # never past natural completion
        if t_next >= self.natural_end(now):
            return None
        return t_next

    # -- preemption cost (paper: ascending preemption overhead) -------------
    def preemption_overhead(self, now: float) -> float:
        """Node-seconds wasted if preempted at `now`.

        malleable: 2-min-warning checkpoint => only a future setup is lost.
        rigid:     future setup + work since the last completed checkpoint.
        """
        j = self.job
        setup_cost = j.t_setup * j.size
        if j.jtype is JobType.MALLEABLE:
            return setup_cost
        lost = self.work_done(now) - self.checkpointed_work(now)
        return setup_cost + max(0.0, lost)
