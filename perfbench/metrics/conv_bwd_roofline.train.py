"""The causal conv + SiLU backward in the traced steps: roofline time over
device time, in percent."""
from perfbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tok_s"
SOURCE = "device_trace"


def read(rec):
    return readers.roofline(rec, "conv_bwd")
