#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's on many seeds, the
control's and the faults' on a few.  Not run by the benchmark's runs.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--seconds 8]

For each seed, in one process: the cell's weights, its program and its
traffic from that seed, as a run builds them.

  serve   a short window at the cell's own load (`--seconds`), then the
          batches a run judges, by the reference (the program's reading:
          the widest gap of a served token) and, on a control seed, by the
          reference in fp8 put in the program's place (the widest gap of
          the fp8 reference's own first choice at the same positions).
  train   the job's first steps and the reference's, compared (the
          program's readings); on a control seed also the fp8 reference
          and the reference on half of each batch's rows (the fault of a
          batch half left out), each compared with the exact reference.

Prints one JSON object a seed, and the largest reading of each kind.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness, traffic  # noqa: E402


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_seed(c, seed, seconds, control, device):
    import torch

    from perfbench.drivers import serve
    from perfbench.reference.common import exact_matmuls
    run = harness.Run(c, seed, seconds, False, device, time.perf_counter(), model=c.model)
    _, params, engine, probe = serve.build(run)
    arrivals = traffic.serve_schedule(c.mix, seed, seconds, c.model["vocab"])
    serve.warm(engine, c.mix, arrivals, c.model["vocab"], seed)
    _, batches, _, _ = serve.serve_window(run, engine, probe, arrivals)
    del engine
    _free()
    exact_matmuls()
    served = [r for b in batches for r in b["reqs"]]
    out = {"seed": seed, "requests": len(served), "batches": len(batches),
           "malformed": serve.malformed(served, c.model["vocab"])}
    with torch.no_grad():
        rs = [serve.judge(run, params, b, control=control)
              for b in serve.pick_batches(batches, seed, c.mix["check_tokens"])]
    out.update(logit_gap_p99=serve.gap_p99(rs), max_logit_gap=max(r["max_gap"] for r in rs),
               tokens=sum(r["tokens"] for r in rs),
               fed_mismatch=sum(r["fed_mismatch"] for r in rs),
               not_best_share=sum(r["not_best"] for r in rs) / sum(r["tokens"] for r in rs))
    if control:
        out["control_max_logit_gap"] = max(r["control_gap"] for r in rs)
        out["control_logit_gap_p99"] = serve.gap_p99([{"gaps": r["control_gaps"]} for r in rs])
        out["control_not_best_share"] = (sum(r["control_not_best"] for r in rs)
                                         / sum(r["tokens"] for r in rs))
    del params, batches, served
    _free()
    return out


def train_seed(c, seed, control, device):
    from perfbench.drivers import train
    from perfbench.reference.common import Matmul, exact_matmuls
    run = harness.Run(c, seed, 0, False, device, time.perf_counter(), model=c.model)
    cluster, job, params = train.build(run)
    got = train.first_steps(run, cluster, job, params)
    del params
    train.free(cluster, job)
    exact_matmuls()
    exact = train.reference_readings(run)
    out = {"seed": seed, **{k: v for k, v in train.compare(got, exact).items()}}
    del got
    if control:
        for tag, kw in (("control", {"mm": Matmul(fp8=True)}),
                        ("half_batch", {"half_batch": True})):
            r = train.compare(train.reference_readings(run, **kw), exact)
            out.update({f"{tag}_{k}": v for k, v in r.items()
                        if k in (*train.CHECKED, "grad_gap", "loss_gap", "grad_worst_leaf_err")})
    _free()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    c = harness.cell(args.workload)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        if c.mix["driver"] == "serve":
            r = serve_seed(c, seed, args.seconds, seed in ctl, torch.device("cuda", 0))
        else:
            r = train_seed(c, seed, seed in ctl, torch.device("cuda", 0))
        r["seconds"] = time.perf_counter() - t
        rows.append(r)
        print(json.dumps(r), flush=True)
    keys = [k for k in rows[0] if isinstance(rows[0][k], float) and k != "seconds"]
    keys += [k for r in rows for k in r if k not in keys and isinstance(r[k], float)
             and k != "seconds"]
    print(json.dumps({"max": {k: max(r[k] for r in rows if k in r) for k in keys},
                      "min": {k: min(r[k] for r in rows if k in r) for k in keys}}))
    harness.assert_no_forbidden("calibrate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
