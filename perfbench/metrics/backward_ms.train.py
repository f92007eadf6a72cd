"""Device ms a traced step spends in the backward pass: the `training.backward`
span (`torch.autograd.grad`, the recomputation of checkpointed layers
included), between its two CUDA events."""
from perfbench import spans

LAYER = "training"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"


def read(rec):
    return value(spans.program_spans())


def value(xs):
    return spans.device_ms(xs, "training.backward")
