"""`ssd_scan`'s forward (chunk states, state passing, chunk scan)."""
from perfbench.kernels._ssd import cost, shape

COUNTER = "ssd_scan"


def calls(model, unit, launches):
    h, p, n, chunk = shape(model)
    return [(launches, *cost(unit["B"], unit["S"], h, p, n, min(chunk, unit["S"]), 2))]
