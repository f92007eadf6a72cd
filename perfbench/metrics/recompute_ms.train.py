"""Device ms a traced step spends recomputing checkpointed layers: the
`models.mamba2` and `models.block` spans opened inside the backward pass,
summed."""
from perfbench import spans

LAYER = "models"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"


def read(rec):
    return value(spans.program_spans())


def value(xs):
    return spans.device_ms(xs, "models.mamba2", "models.block", backward_only=True)
