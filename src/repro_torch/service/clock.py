"""Replay clock: the service's bridge between wall time and trace time.

A :class:`ReplayClock` maps the monotonic wall clock onto the simulated
timeline at a configurable ``speed`` (simulated seconds per wall second).
The scheduler daemon sleeps against it so replayed arrivals hit the
decision core at scaled real-time pace; ``speed=inf`` (the CI/benchmark
mode) never sleeps and replays as fast as the decision core can go —
the *decision sequence* is identical either way, only the wall-clock
spacing of the decisions changes.

All measurements use ``time.monotonic`` (never ``time.time``): the
mapping must survive wall-clock adjustments, and the per-decision
latencies derived from it feed the SLO gate.
"""
from __future__ import annotations

import math
import time


class ReplayClock:
    """Maps wall time onto simulated time at a fixed speed-up factor.

    ``origin`` is the simulated time at which the clock starts, so a
    trace whose first event is at t=86 400 does not force a day of (or
    even a scaled) dead wait.
    """

    def __init__(self, speed: float = math.inf, origin: float = 0.0):
        if not (speed > 0):
            raise ValueError(f"replay speed must be > 0, got {speed!r}")
        self.speed = speed
        self.origin = origin
        self._t0 = time.monotonic()

    @property
    def realtime(self) -> bool:
        """True when the clock actually paces (finite speed)."""
        return math.isfinite(self.speed)

    def wall_elapsed(self) -> float:
        """Wall seconds since the clock started."""
        return time.monotonic() - self._t0

    def now_sim(self) -> float:
        """Current position on the simulated timeline."""
        if not self.realtime:
            return math.inf
        return self.origin + self.wall_elapsed() * self.speed

    def sleep_until(self, t_sim: float, max_sleep: float = 0.25) -> float:
        """Sleep until the simulated clock reaches ``t_sim``; returns the
        wall seconds slept.  Sleeps in ``max_sleep`` chunks so a live
        daemon stays responsive to new admissions; ``speed=inf`` returns
        immediately."""
        if not self.realtime:
            return 0.0
        slept = 0.0
        while True:
            behind = (t_sim - self.now_sim()) / self.speed
            if behind <= 0:
                return slept
            dt = min(behind, max_sleep)
            time.sleep(dt)
            slept += dt
