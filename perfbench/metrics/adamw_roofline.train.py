"""AdamW's clip norm and update kernels in the traced steps: roofline time
(the compulsory bytes of every updated element over the HBM bandwidth) over
the device time of the kernels, in percent."""
from perfbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tok_s"
SOURCE = "device_trace"


def read(rec):
    return readers.roofline(rec, "adamw")
