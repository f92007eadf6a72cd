"""`causal_conv_silu`'s backward (a pass over the rows, then the sum of its
partials of dw and dbias)."""
from perfbench.kernels import _conv

COUNTER = "causal_conv_bwd"


def calls(model, unit, launches):
    return _conv.calls(model, unit, launches, backward=True)
