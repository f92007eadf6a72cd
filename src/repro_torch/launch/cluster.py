"""Hybrid-workload cluster scheduler CLI (trace-based).

    PYTHONPATH=src python -m repro_torch.launch.cluster --mechanism CUA&SPAA \
        --jobs 600 --mix W5 --seed 0

Runs the paper's scheduler over a synthesized Theta-like trace and prints
the §IV-D metrics.  `--mechanism all` compares everything (Figure 6 row).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core import (MECHANISMS, SimConfig, Simulator, WorkloadConfig,
                        collect, generate)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mechanism", default="CUA&SPAA",
                    help="one of %s, BASE, or 'all'" % (MECHANISMS,))
    ap.add_argument("--nodes", type=int, default=4392)
    ap.add_argument("--jobs", type=int, default=600)
    ap.add_argument("--mix", default="W5")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load", type=float, default=1.15)
    ap.add_argument("--ckpt-factor", type=float, default=1.0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    wcfg = WorkloadConfig(n_nodes=args.nodes, n_jobs=args.jobs,
                          horizon_days=21.0, target_load=args.load,
                          notice_mix=args.mix, seed=args.seed,
                          ckpt_freq_factor=args.ckpt_factor)
    jobs = generate(wcfg)
    mechs = ("BASE",) + MECHANISMS if args.mechanism == "all" \
        else (args.mechanism,)
    for mech in mechs:
        sim = Simulator(SimConfig(n_nodes=args.nodes, mechanism=mech),
                        [j for j in jobs])
        sim.run()
        m = collect(sim)
        if args.json:
            print(json.dumps({"mechanism": mech, **m.as_dict()}))
        else:
            print(f"{mech:10s} turnaround={m.avg_turnaround_h:.1f}h "
                  f"util={m.system_utilization:.3f} "
                  f"instant={m.od_instant_start_rate:.2f} "
                  f"preempt(r/m)={m.preemption_ratio_rigid:.2f}/"
                  f"{m.preemption_ratio_malleable:.2f}")


if __name__ == "__main__":
    main()
