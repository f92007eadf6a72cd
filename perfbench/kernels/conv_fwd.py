"""`causal_conv_silu`'s forward (recomputed forwards included: each launch
is counted)."""
from perfbench.kernels import _conv

COUNTER = "causal_conv"


def calls(model, unit, launches):
    return _conv.calls(model, unit, launches)
