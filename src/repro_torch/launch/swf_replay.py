"""Replay a Standard Workload Format trace through scheduling mechanisms.

    PYTHONPATH=src python -m repro_torch.launch.swf_replay               # sample trace
    PYTHONPATH=src python -m repro_torch.launch.swf_replay --trace theta.swf --mix W2
    PYTHONPATH=src python -m repro_torch.launch.swf_replay --load-scale 1.3
    PYTHONPATH=src python -m repro_torch.launch.swf_replay --stream --max-rss

The port's counterpart of `examples/swf_replay.py`, over the port's
`Experiment` and workload registry: the same flags and the same table.
The "swf" source annotates the trace with the paper's §IV-A rules
(per-project types, Table III notice mixes); `--load-scale 1.3`
compresses arrivals to 1.3x offered load.  `--stream` replays every cell
in bounded memory with a per-run progress line, which here leaves out
the example's elapsed seconds; `--max-rss` prints the process's peak RSS
at exit.  The default trace is the repository's `tests/data/sample.swf`.
The simulation is numpy on the host; nothing runs on the card.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.core import Experiment, Scenario
from repro_torch.core.experiment import ExperimentResult

SAMPLE = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                      "..", "..", "tests", "data", "sample.swf"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=SAMPLE, help="SWF file to replay")
    ap.add_argument("--mechanisms", default="BASE,CUA&SPAA,CUA&STEAL",
                    help="comma-separated registered mechanism strings")
    ap.add_argument("--mix", default="W5", help="Table III notice mix")
    ap.add_argument("--frac-od", type=float, default=0.25,
                    help="fraction of trace projects marked on-demand")
    ap.add_argument("--load-scale", type=float, default=None,
                    help="compress arrivals to this multiple of the "
                         "trace's offered load")
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of annotation seeds to average")
    ap.add_argument("--serial", action="store_true",
                    help="disable the multiprocessing fan-out")
    ap.add_argument("--stream", action="store_true",
                    help="bounded-memory replay (lazy trace + record "
                         "sink) with a per-run progress line")
    ap.add_argument("--max-rss", action="store_true",
                    help="print the peak RSS at exit (memory smoke check)")
    args = ap.parse_args(argv)

    transforms = []
    if args.load_scale:
        transforms.append(("load_scale", {"factor": args.load_scale}))
    params = {"path": args.trace, "notice_mix": args.mix,
              "frac_od_projects": args.frac_od}
    if args.stream:
        params["stream"] = True  # chunked scan, no record-dict parse
    scenario = Scenario("swf", params=params,
                        transforms=tuple(transforms), name="trace-replay")
    exp = Experiment(mechanisms=args.mechanisms.split(","),
                     workloads=(scenario,), seeds=range(args.seeds),
                     processes=1 if args.serial else None,
                     stream=args.stream)
    if args.stream:
        results, n_runs = [], len(args.mechanisms.split(",")) * args.seeds
        for r in exp.run_stream():
            results.append(r)
            print(f"[{len(results)}/{n_runs}] {r.spec.mechanism} "
                  f"seed={r.spec.seed}: {r.metrics.n_completed}/"
                  f"{r.metrics.n_jobs} jobs", flush=True)
        result = ExperimentResult(results)
    else:
        result = exp.run()
    rows = result.mean(("mechanism",))
    print(f"trace: {args.trace} (mix={args.mix}, frac_od={args.frac_od}"
          + (f", load x{args.load_scale}" if args.load_scale else "") + ")")
    hdr = (f"{'mechanism':10s} {'turn_h':>7s} {'od_h':>7s} {'util':>6s} "
           f"{'instant':>8s} {'done':>5s}")
    print(hdr)
    for row in rows:
        print(f"{row['mechanism']:10s} {row['avg_turnaround_h']:7.1f} "
              f"{row['avg_turnaround_od_h']:7.2f} "
              f"{row['system_utilization']:6.3f} "
              f"{row['od_instant_start_rate']:8.2f} "
              f"{row['n_completed']:5.0f}")
    if args.max_rss:
        import resource
        rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        print(f"peak RSS: {rss_mb:.0f} MB (self"
              + ("" if args.serial else "; worker processes excluded") + ")")


if __name__ == "__main__":
    main()
