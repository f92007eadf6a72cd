"""Mean of ServeEngine.step_seconds (a decode step from its launch to its
tokens on the host) over every decode step of the batches outside the
traced stretch."""
from perfbench import readers

LAYER = "serving"
UNIT = "ms"
MOVES = "latency_p90_ms"
SOURCE = "program_span"


def read(rec):
    return _mean([1e3 * s for b in readers.untraced(rec, "batches") for s in b["step_s"]])


def _mean(xs):
    return sum(xs) / len(xs) if xs else None
