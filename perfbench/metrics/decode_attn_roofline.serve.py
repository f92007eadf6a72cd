"""flash_decode's calls in the traced batches: their roofline time over their
kernels' device time, in percent."""
from perfbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "latency_p90_ms"
SOURCE = "device_trace"


def read(rec):
    return readers.roofline(rec, "decode_attn")
