"""One module a kind of traffic, named by a mix's `driver`: each `run(run)`
builds the cell, warms it, measures for the window, checks the outputs and
fills the run's record; it returns (attempted, failed, memory peak)."""
