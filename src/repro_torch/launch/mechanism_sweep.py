"""Paper Figure 6 in miniature: sweep registered mechanisms over one trace.

    PYTHONPATH=src python -m repro_torch.launch.mechanism_sweep [--jobs 400]
    PYTHONPATH=src python -m repro_torch.launch.mechanism_sweep --mechanisms 'BASE,CUA&STEAL'
    PYTHONPATH=src python -m repro_torch.launch.mechanism_sweep --scenarios 'W1,W5,bursty-od'

The port's counterpart of `examples/mechanism_sweep.py`, over the port's
`Experiment` and workload registry: the same flags and the same table.
Runs the paper's six mechanisms, BASE and the third-party STEAL/POOL
policies through `Experiment` (process fan-out unless `--serial`); with
`--scenarios`, the sweep spans registry-named scenario presets instead of
one WorkloadConfig, and `--trace` (default: the repository's
`tests/data/sample.swf`) feeds the trace-replay preset.  The simulation is
numpy on the host; nothing runs on the card.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.core import MECHANISMS, Experiment, WorkloadConfig, get_scenario

DEFAULT_MECHS = ("BASE",) + MECHANISMS + ("CUA&STEAL", "CUA&POOL")
SAMPLE = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                      "..", "..", "tests", "data", "sample.swf"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=400)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mix", default="W5")
    ap.add_argument("--mechanisms", default=",".join(DEFAULT_MECHS),
                    help="comma-separated registered mechanism strings")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated scenario preset names to sweep "
                         "instead of a single synthetic trace")
    ap.add_argument("--trace", default=SAMPLE,
                    help="SWF file for the trace-replay preset")
    ap.add_argument("--serial", action="store_true",
                    help="disable the multiprocessing fan-out")
    args = ap.parse_args(argv)
    if args.scenarios:
        def preset(name):
            if name == "trace-replay":  # the only preset needing a file
                return get_scenario(name, trace=args.trace)
            sc = get_scenario(name)
            if sc.source != "theta":
                return sc  # non-theta preset: its factory owns the params
            return get_scenario(name, n_nodes=4392, n_jobs=args.jobs,
                                horizon_days=21.0, target_load=1.15)
        workloads = [preset(name) for name in args.scenarios.split(",")]
        label = f"scenarios={args.scenarios}"
    else:
        workloads = [WorkloadConfig(n_nodes=4392, n_jobs=args.jobs,
                                    horizon_days=21.0, target_load=1.15,
                                    notice_mix=args.mix)]
        label = f"mix={args.mix}"
    exp = Experiment(mechanisms=args.mechanisms.split(","),
                     workloads=workloads,
                     seeds=(args.seed,), processes=1 if args.serial else None)
    result = exp.run()
    hdr = (f"{'mechanism':10s} {'workload':>12s} {'turn_h':>7s} "
           f"{'rigid_h':>8s} {'mall_h':>7s} "
           f"{'util':>6s} {'instant':>8s} {'pre_r':>6s} {'pre_m':>6s}")
    print(f"trace: {args.jobs} jobs, {label}\n{hdr}")
    for run in result:
        m = run.metrics
        wl = run.spec.workload
        wname = wl.label if hasattr(wl, "label") else wl.notice_mix
        print(f"{run.spec.mechanism:10s} {wname:>12s} {m.avg_turnaround_h:7.1f} "
              f"{m.avg_turnaround_rigid_h:8.1f} "
              f"{m.avg_turnaround_malleable_h:7.1f} "
              f"{m.system_utilization:6.3f} {m.od_instant_start_rate:8.2f} "
              f"{m.preemption_ratio_rigid:6.2f} "
              f"{m.preemption_ratio_malleable:6.2f}")


if __name__ == "__main__":
    main()
