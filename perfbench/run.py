#!/usr/bin/env python3
"""Run one cell of the benchmark (see BENCHMARK.json and perfbench/README.md):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's result as one JSON object;
the checks behind `correct` are the last lines of standard error.  A
machine without the CUDA cards the cell asks for gets no result and a
non-zero exit code.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
