"""Model FLOPs of the real prompt and served tokens (pads count for nothing)
over the seconds serve_batch ran, against the bf16 peak, in percent;
batches outside the traced stretch."""
from perfbench import readers

LAYER = "models"
UNIT = "%"
MOVES = "ttft_p90_ms"
SOURCE = "host_clock"


def read(rec):
    return readers.mfu_serve(rec)
