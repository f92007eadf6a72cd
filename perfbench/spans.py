"""What the readers of the program's spans share.

The program (`repro_torch.tracing`) records a span at each of its layer
boundaries while a profiler session records, which in a run is the traced
stretch; `runtime.step` spans mark its steps, and every span carries the
job and step open when it was opened (two jobs of a cluster may be at the
same step).  Each reader's value is a mean over those steps.  A program
without the module, or a run with no traced step, gives None, as does a
device time where the spans hold none (no CUDA).
"""
from __future__ import annotations

from typing import Callable, List, Optional


def program_spans() -> List[dict]:
    """The spans the program recorded in this process, or [] where the
    program records none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def per_step(spans: List[dict], keep: Callable[[dict], bool],
             value: Callable[[dict], Optional[float]]) -> Optional[float]:
    """The sum of value over the kept spans of the traced steps, over the
    number of those steps; None where there is no traced step or a kept
    span has no value."""
    steps = {(s["jid"], s["step"]) for s in spans if s["name"] == "runtime.step"}
    if not steps:
        return None
    values = [value(s) for s in spans if (s["jid"], s["step"]) in steps and keep(s)]
    if None in values:
        return None
    return sum(values) / len(steps)


def device_ms(spans: List[dict], *names: str, backward_only: bool = False
              ) -> Optional[float]:
    """Device ms a step of the spans named (with backward_only, of those
    opened in a backward pass alone)."""
    def keep(s):
        return s["name"] in names and (s["in_backward"] or not backward_only)
    return per_step(spans, keep, lambda s: s["device_ms"])
