"""`ssd_scan`'s backward (six kernels a call)."""
from perfbench.kernels._ssd import cost, shape

COUNTER = "ssd_scan_bwd"


def calls(model, unit, launches):
    h, p, n, chunk = shape(model)
    return [(launches, *cost(unit["B"], unit["S"], h, p, n, min(chunk, unit["S"]), 2,
                             backward=True))]
