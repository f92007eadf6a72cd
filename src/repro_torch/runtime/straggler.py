"""Straggler detection (large-scale runnability substrate).

Per-step wall times feed an exponential moving average + deviation; a
step slower than `threshold` x the EMA flags a straggler event.  The
mitigation hook is pluggable: at cluster scale the scheduler treats a
persistent straggler like a failing node (checkpoint + restart elsewhere,
which the ElasticJob ops already implement); in-process we record and
expose the events so the cluster runtime / tests can assert on them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 3.0
    warmup: int = 3
    ema: Optional[float] = None
    n: int = 0
    events: List[dict] = field(default_factory=list)
    on_straggler: Optional[Callable[[dict], None]] = None

    def observe(self, step_time: float) -> bool:
        self.n += 1
        if self.ema is None:
            self.ema = step_time
            return False
        is_straggler = (self.n > self.warmup
                        and step_time > self.threshold * self.ema)
        if is_straggler:
            ev = {"step": self.n, "time": step_time, "ema": self.ema}
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
        else:
            # stragglers do not poison the EMA
            self.ema = (1 - self.alpha) * self.ema + self.alpha * step_time
        return is_straggler
