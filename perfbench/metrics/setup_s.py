"""Seconds from process start to the window's opening: imports, kernel
libraries loaded (built on a checkout's first run), weights made, warm-up
(serving) or the job's first steps (training)."""
LAYER = "end_to_end"
UNIT = "s"
MOVES = ""
SOURCE = "host_clock"


def read(rec):
    return rec["setup_s"]
