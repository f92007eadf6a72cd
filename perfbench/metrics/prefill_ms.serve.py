"""Mean time from a serve_batch call to its batch's first tokens on the host
(the engine reads them with .tolist()), over the batches outside the traced
stretch."""
from perfbench import readers

LAYER = "serving"
UNIT = "ms"
MOVES = "ttft_p90_ms"
SOURCE = "host_clock"


def read(rec):
    return _mean([1e3 * b["prefill_s"] for b in readers.untraced(rec, "batches")])


def _mean(xs):
    return sum(xs) / len(xs) if xs else None
