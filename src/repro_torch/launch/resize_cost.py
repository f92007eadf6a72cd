"""What a malleable job's shrink, expand, preempt and resume cost on ranks.

    PYTHONPATH=src python -m repro_torch.launch.resize_cost --device cpu \
        [--reduced] [--plan 4,2,6]

One llama3-8b `ElasticJob` (12 x 128 tokens a step) on slots that name
distinct devices (`cpu:0` ... `cpu:7`, or `cuda:0` ...), so it runs on
one rank process a device: start on the plan's first count, a step after
each change, resize to each later count, then preempt with warning (the
ranks checkpoint into a temporary directory and stop) and resume on the
last devices the plan names, as many as the first count.  Prints one JSON object: the seconds of each
operation, the parts of each resize (`ElasticJob.resize_parts`: the state
gathered, the world re-formed or new ranks started, the state placed),
the step seconds, and whether the params crossed each resize bit for bit.
A number from `--device cpu` is the CPU's: gloo ranks sharing the host's
cores.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.runtime.elastic import ElasticJob, _state_leaves
from repro_torch.training import AdamW

BATCH, SEQ = 12, 128   # 12 rows: every rank count of the default plan divides them


def _params(job):
    return [t.clone() for t in _state_leaves(job.state.params)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--plan", default="4,2,6", help="rank counts: start, then each resize")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plan = [int(n) for n in args.plan.split(",")]
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    if args.device == "cuda" and max(plan) > torch.cuda.device_count():
        raise ValueError(f"--plan {args.plan} needs {max(plan)} cards, "
                         f"{torch.cuda.device_count()} here")
    slots = [f"{args.device}:{i}" for i in range(max(plan))]
    cfg = get_config("llama3_8b")
    if args.reduced:
        cfg = reduce_config(cfg)
    out = {"arch": cfg.name, "device": args.device, "plan": plan, "batch": BATCH,
           "seq": SEQ, "ops": []}
    with tempfile.TemporaryDirectory() as ckpt:
        job = ElasticJob(1, cfg, batch=BATCH, seq=SEQ, opt=AdamW(),
                         ckpt_dir=ckpt, ckpt_every=10 ** 9)
        try:
            t0 = time.perf_counter()
            job.start(slots[:plan[0]])
            out["ops"].append({"op": f"start {plan[0]}", "s": time.perf_counter() - t0})
            job.step()
            for n in plan[1:]:
                before = _params(job)
                cost = job.resize(slots[:n])
                same = all(torch.equal(a, b) for a, b in zip(before, _params(job)))
                out["ops"].append({"op": f"resize {n}", "s": cost,
                                   "parts": job.resize_parts[-1], "params_bit_equal": same})
                job.step()
            t0 = time.perf_counter()
            job.preempt(warning=True)
            out["ops"].append({"op": "preempt", "s": time.perf_counter() - t0,
                               "checkpoint_s": job.ckpt_seconds[-1]})
            t0 = time.perf_counter()
            job.resume(slots[-plan[0]:])
            out["ops"].append({"op": f"resume {plan[0]}", "s": time.perf_counter() - t0})
            job.step()
        finally:
            job.close()
    out["step_seconds"] = job.step_seconds
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
