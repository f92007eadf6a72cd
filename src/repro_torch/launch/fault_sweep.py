"""Fault injection in miniature: MTBF sweep over a hybrid workload.

    PYTHONPATH=src python -m repro_torch.launch.fault_sweep [--jobs 150]
    PYTHONPATH=src python -m repro_torch.launch.fault_sweep --mtbf 24,168,720
    PYTHONPATH=src python -m repro_torch.launch.fault_sweep --out sweep.json

The port's counterpart of `examples/fault_sweep.py`, over the port's
scheduler copy (`repro_torch.core`, `repro_torch.faults`): the same flags,
the same table and the same JSON.  Sweeps node MTBF (exp-mtbf model, fixed
MTTR) over a bursty on-demand scenario and prints, per point: failures
observed, running-job interruptions, work lost to restarts, goodput and
on-demand turnaround, under a perfect-machine baseline row.  With the
defaults, `--out` writes `results/faults/mtbf_sweep.json` byte for byte
(each row's `records_sha256` included).  The simulation is numpy on the
host; nothing runs on the card.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.core import SimConfig, Simulator
from repro_torch.core.metrics import collect, records_sha256
from repro_torch.core.workloads import get_scenario


def run_cell(jobs, n_nodes, mechanism, faults):
    sim = Simulator(SimConfig(n_nodes=n_nodes, mechanism=mechanism,
                              faults=faults), list(jobs))
    recs = sim.run()
    m = collect(sim)
    return {
        "fault_spec": faults or "none",
        "records_sha256": records_sha256(recs),
        "n_node_failures": m.n_node_failures or 0,
        "n_interruptions": m.n_interruptions or 0,
        "lost_work_node_h": round(m.lost_work_node_h or 0.0, 2),
        "goodput": None if m.goodput is None else round(m.goodput, 4),
        "utilization": round(m.system_utilization, 4),
        "od_turnaround_h": round(m.avg_turnaround_od_h, 4),
        "avg_turnaround_h": round(m.avg_turnaround_h, 4),
    }


def main(argv=None) -> dict:
    """Run the sweep; returns what `--out` writes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--scenario", default="bursty-od")
    ap.add_argument("--mechanism", default="CUA&SPAA")
    ap.add_argument("--mtbf", default="40,160,720",
                    help="comma-separated node MTBF points in hours")
    ap.add_argument("--mttr", type=float, default=2.0)
    ap.add_argument("--horizon-days", type=float, default=5.0)
    ap.add_argument("--out", default=None,
                    help="also write rows to this JSON path")
    args = ap.parse_args(argv)

    jobs, n_nodes = get_scenario(args.scenario,
                                 n_jobs=args.jobs).realize(args.seed)
    print(f"# {args.scenario}: {len(jobs)} jobs on {n_nodes} nodes, "
          f"mechanism {args.mechanism}, mttr={args.mttr}h")
    hdr = (f"{'mtbf_h':>8} {'failures':>9} {'interrupt':>9} "
           f"{'lost_node_h':>12} {'goodput':>8} {'od_turn_h':>10}")
    print(hdr)
    print("-" * len(hdr))

    rows = [dict(run_cell(jobs, n_nodes, args.mechanism, None), mtbf_h=None)]
    r = rows[0]
    print(f"{'inf':>8} {r['n_node_failures']:>9} {r['n_interruptions']:>9} "
          f"{r['lost_work_node_h']:>12} {'1.0000':>8} "
          f"{r['od_turnaround_h']:>10}")
    for mtbf_h in (float(x) for x in args.mtbf.split(",")):
        spec = (f"exp-mtbf:mtbf_h={mtbf_h:g},mttr_h={args.mttr:g},"
                f"horizon_days={args.horizon_days:g}")
        r = dict(run_cell(jobs, n_nodes, args.mechanism, spec), mtbf_h=mtbf_h)
        rows.append(r)
        print(f"{mtbf_h:>8g} {r['n_node_failures']:>9} "
              f"{r['n_interruptions']:>9} {r['lost_work_node_h']:>12} "
              f"{r['goodput']:>8} {r['od_turnaround_h']:>10}")

    result = {"scenario": args.scenario, "n_jobs": len(jobs),
              "n_nodes": n_nodes, "mechanism": args.mechanism,
              "seed": args.seed, "mttr_h": args.mttr,
              "horizon_days": args.horizon_days, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"# wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
