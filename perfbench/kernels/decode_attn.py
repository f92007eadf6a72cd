"""`flash_decode`: one new token a row against the cache.  A served batch
of S padded prompt tokens runs `steps` decode steps, step j (1-based)
reading S + j valid rows, with the same number of launches each step."""
from perfbench.kernels._attention import forward, heads

COUNTER = "flash_decode"


def calls(model, unit, launches):
    H, K, D = heads(model)
    steps = unit["steps"]
    if not steps:
        return []
    per_step = launches // steps
    return [(per_step, *forward(unit["B"], 1, unit["S"] + j, H, K, D, D, 2,
                                vlen=unit["S"] + j)) for j in range(1, steps + 1)]
