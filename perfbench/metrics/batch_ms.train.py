"""Host ms a traced step spends making the job's batch: the `runtime.batch`
span (`synthetic_batch`)."""
from perfbench import spans

LAYER = "runtime"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"


def read(rec):
    return value(spans.program_spans())


def value(xs):
    return spans.per_step(xs, lambda s: s["name"] == "runtime.batch", lambda s: s["host_ms"])
