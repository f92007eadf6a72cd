"""Tokens of every training step of the window over the window's length (it
ends with the first step that finishes after --seconds)."""
LAYER = "end_to_end"
UNIT = "tokens/s"
MOVES = ""
SOURCE = "host_clock"


def read(rec):
    return len(rec["steps"]) * rec["tokens_per_step"] / rec["window_s"]
