"""`flash_attention`'s forward: the causal self-attention of a prefill or a
training forward (recomputed forwards included: each launch is counted)."""
from perfbench.kernels._attention import forward, heads

COUNTER = "flash_attention"


def calls(model, unit, launches):
    """[(count, FLOPs, bytes)] of the unit's launches; a training unit's
    forward also writes the log-sum-exp."""
    H, K, D = heads(model)
    train = unit.get("steps") is None
    return [(launches, *forward(unit["B"], unit["S"], unit["S"], H, K, D, D, 2, lse=train))]
