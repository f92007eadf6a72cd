"""ssd_scan's forward in the traced steps (recomputed forwards included):
roofline time over device time, in percent."""
from perfbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tok_s"
SOURCE = "device_trace"


def read(rec):
    return readers.roofline(rec, "ssd_fwd")
