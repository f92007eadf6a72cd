"""The dropless MoE's grouped expert GEMMs in the traced steps (forward,
recomputed forward and backward calls): roofline time over device time, in
percent."""
from perfbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tok_s"
SOURCE = "device_trace"


def read(rec):
    return readers.roofline(rec, "expert_mm")
