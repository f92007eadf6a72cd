"""Share of the traced stretch in which no operation ran on the card (the
union of their intervals), in percent."""
from perfbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "latency_p90_ms"
SOURCE = "device_trace"


def read(rec):
    return readers.idle_share(rec)
