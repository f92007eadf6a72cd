"""Times a traced step makes the host wait for the device: the `host_syncs`
counts of its spans (the batch's two blocking copies to the device, the
optimizer's two scalars made on the device, each value `ElasticJob.step`
reads back)."""
from perfbench import spans

LAYER = "runtime"
UNIT = "syncs/step"
MOVES = "train_tok_s"
SOURCE = "program_counter"


def read(rec):
    return value(spans.program_spans())


def value(xs):
    return spans.per_step(xs, lambda s: True, lambda s: s["counts"].get("host_syncs", 0))
