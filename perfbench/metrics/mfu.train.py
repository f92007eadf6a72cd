"""Training model FLOPs (6 a weight of every product, 3 times attention's and
the SSD scan's forward; recomputation not counted) of the steps outside the
traced stretch over their seconds, against the bf16 peak, in percent."""
from perfbench import readers

LAYER = "models"
UNIT = "%"
MOVES = "train_tok_s"
SOURCE = "host_clock"


def read(rec):
    return readers.mfu_train(rec)
