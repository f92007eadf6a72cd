"""Device ms a traced step spends in the forward pass: the `training.forward`
span (the loss function's call), between its two CUDA events."""
from perfbench import spans

LAYER = "training"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"


def read(rec):
    return value(spans.program_spans())


def value(xs):
    return spans.device_ms(xs, "training.forward")
