"""90th percentile, over every request due in the window, of the time from
its due time to its first token on the host; a request never answered
ranks above every answered one."""
from perfbench import readers

LAYER = "end_to_end"
UNIT = "ms"
MOVES = ""
SOURCE = "host_clock"


def read(rec):
    return 1e3 * readers.p90(rec["ttft_s"])
