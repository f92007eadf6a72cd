"""`flash_attention`'s backward: the dQ and dK / dV kernels of one call."""
from perfbench.kernels._attention import backward, heads

COUNTER = "flash_attention_bwd"


def calls(model, unit, launches):
    H, K, D = heads(model)
    return [(launches, *backward(unit["B"], unit["S"], H, K, D, D, 2))]
