"""The scheduler service running real PyTorch jobs on one device.

    PYTHONPATH=src python -m repro_torch.launch.elastic_cluster \
        [--device cpu] [--reduced] [--speed inf]

The port's counterpart of `examples/elastic_cluster_demo.py`.  Eight slots
of one device (the card unless `--device cpu` is given; with the default
device and no CUDA it raises rather than fall back) form the "cluster".
Two malleable training jobs (1 to 3 nodes) and one rigid job (2 nodes) are
admitted through the service's front door (`AdmissionQueue`); an on-demand
inference job of 4 nodes arrives at t = 15 s with 5 s notice.  The
service's policy core (`CUA&SPAA`) decides WHAT starts or shrinks WHEN; the
`LiveClusterLauncher` executes each decision on a `LiveCluster`, whose
arrival policy picks WHICH slots move.  The training payload is
`runtime.ElasticJob` (`--train-arch`, cut to `--train-layers`), the
on-demand payload `serving.ServeEngine` (`--serve-arch`) over the request
batch `plan_requests` plans.  Weights are random, from seeds.

`--speed` is sim-seconds per wall-second (the demo's 40 by default); with
`inf` the service never sleeps, so the decision log and the number of
training ticks do not depend on how fast the device runs.
"""
from __future__ import annotations

import argparse
import shutil
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.core.job import JobType
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import ElasticJob, LiveCluster
from repro_torch.service import (AdmissionQueue, LiveClusterLauncher,
                                 SchedulerService, ServiceConfig,
                                 plan_requests)
from repro_torch.serving import Request, ServeEngine

N_NODES = 8
STEPS_PER_TICK = 2
SERVE_SEED = 9
# the demo's serve cache bound; `plan_requests` plans prompts of 8-63 tokens
# and 16 new ones, so the cache is prompt-long at every d_head of 64 or more
MAX_SEQ = 128


def admit_demo_jobs(queue: AdmissionQueue) -> None:
    """The demo's four jobs, in its order, then close the queue."""
    queue.submit_training(n_max=3, runtime_s=40.0, n_min=1)
    queue.submit_training(n_max=3, runtime_s=40.0, n_min=1)
    queue.submit_rigid(nodes=2, runtime_s=40.0)
    queue.submit_inference(nodes=4, hold_s=8.0, submit_time=15.0, notice_lead_s=5.0)
    queue.close()


def plan_batch(job, vocab: int) -> List[Request]:
    """The on-demand job's request batch (`plan_requests`), with each
    prompt drawn from numpy seeded by its request id, as the demo does."""
    reqs = []
    for p in plan_requests(job, vocab=vocab):
        rng = np.random.default_rng(p["rid"])
        reqs.append(Request(rid=p["rid"],
                            prompt=rng.integers(0, vocab, p["prompt_len"], dtype=np.int32),
                            max_new_tokens=p["max_new_tokens"]))
    return reqs


def _median(xs):
    return statistics.median(xs) if xs else None


def run(train_cfg: ModelConfig, serve_cfg: ModelConfig, *, device="cuda",
        batch: int = 8, seq: int = 64, target_steps: int = 40,
        ckpt_every: int = 10, speed: float = 40.0,
        ckpt_dir: Optional[str] = None, mechanism: str = "CUA&SPAA",
        serve_params=None, on_job: Optional[Callable[[ElasticJob], None]] = None
        ) -> Dict:
    """Run the four jobs under `mechanism` on 8 slots of `device`; returns
    what it printed.  `serve_params` replaces the serve model's random
    weights, and `on_job(job)` sees each ElasticJob before the cluster
    starts it (tests set the initial state there).  Checkpoints go under
    `ckpt_dir`, or a temporary directory that is removed at the end."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the cluster on the CPU")
    arrival = mechanism.split("&")[-1]
    cluster = LiveCluster([device] * N_NODES, arrival_policy=arrival)
    print(f"cluster: {N_NODES} slots of {device}, {mechanism}; train {train_cfg.name} "
          f"({train_cfg.n_layers} layers, {train_cfg.param_dtype}), serve {serve_cfg.name} "
          f"({serve_cfg.n_layers} layers, {serve_cfg.param_dtype})")
    root = ckpt_dir or tempfile.mkdtemp(prefix="elastic_cluster_")
    try:

        def job_factory(spec):
            kind = "malleable" if spec.jtype is JobType.MALLEABLE else "rigid"
            job = ElasticJob(spec.jid, train_cfg, kind=kind, batch=batch, seq=seq,
                             ckpt_dir=f"{root}/j{spec.jid}", ckpt_every=ckpt_every,
                             seed=spec.jid % 97)
            if on_job is not None:
                on_job(job)
            return job

        engine = {}
        served = []

        def serve_fn(job, node_ids):
            """Run the on-demand payload on the slots the cluster vacated."""
            if "engine" not in engine:
                params = serve_params if serve_params is not None else \
                    init_params(serve_cfg, seed=SERVE_SEED, device=device)
                engine["engine"] = ServeEngine(serve_cfg, params, max_seq=MAX_SEQ,
                                               device=device)
            reqs = plan_batch(job, serve_cfg.vocab)
            t0 = time.perf_counter()
            engine["engine"].serve_batch(reqs)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            n = sum(len(r.tokens_out) for r in reqs)
            served.append({"jid": job.jid, "nodes": len(node_ids),
                           "prompt_lens": [len(r.prompt) for r in reqs],
                           "tokens": [r.tokens_out for r in reqs], "seconds": dt,
                           "tok_per_s": n / dt,
                           "ttft_s": max(r.first_token_at - r.submitted_at for r in reqs)})
            print(f"  served {n} tokens for {len(reqs)} requests on {len(node_ids)} "
                  f"vacated slots in {dt:.3f}s (ttft {served[-1]['ttft_s']:.3f}s)")
            return reqs

        launcher = LiveClusterLauncher(cluster, job_factory, serve_fn=serve_fn,
                                       steps_per_tick=STEPS_PER_TICK,
                                       target_steps=target_steps)
        queue = AdmissionQueue()
        admit_demo_jobs(queue)
        svc = SchedulerService(ServiceConfig(n_nodes=N_NODES, mechanism=mechanism,
                                             speed=speed), launcher=launcher)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        rep = svc.run_live(queue)
        decisions = [{k: v for k, v in row.items() if k not in ("wall", "mono", "latency_ms")}
                     for row in svc.log.rows]
        print(f"service drained in {rep.wall_s:.2f}s wall ({rep.n_decisions} decisions, "
              f"digest {rep.digest[:16]})")
        for row in decisions:
            print("  ", row)

        # ---- drain the training tail on the live cluster ----------------------
        infos = launcher.infos
        while any(i.status in ("running", "waiting") for i in infos.values()):
            cluster.step_all(5)
        wall = time.perf_counter() - t0
        log = [{k: v for k, v in e.items() if k != "t"} for e in cluster.log]
        print("cluster event log:")
        for e in log:
            print("  ", e)
        per_job = {}
        for jid, info in sorted(infos.items()):
            job = info.job
            steady = _median(job.step_seconds[1:])
            per_job[jid] = {
                "kind": job.kind, "status": info.status, "steps_done": info.steps_done,
                "step_idx": job.step_idx, "shrink_count": info.shrink_count,
                "preempt_count": info.preempt_count, "losses": job.losses,
                "step_seconds": job.step_seconds, "steady_step_s": steady,
                "tokens_per_s": batch * seq / steady if steady else None,
                "ckpt_seconds": job.ckpt_seconds, "reshard_s": job.resize_costs}
            print(f"  job {jid} ({job.kind}): {info.steps_done} steps, "
                  f"{info.shrink_count} shrinks, {info.preempt_count} preempts, "
                  f"steady step {steady}s, checkpoints {job.ckpt_seconds}, "
                  f"reshard {job.resize_costs}")
        stats = {
            "mechanism": mechanism, "device": str(device), "n_decisions": rep.n_decisions,
            "digest": rep.digest, "decisions": decisions, "cluster_log": log,
            "jobs": per_job, "served": served, "wall_s": wall,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else None),
        }
        return stats
    finally:
        if ckpt_dir is None:
            shutil.rmtree(root, ignore_errors=True)


def main(argv=None, **run_kw) -> dict:
    """Parse the flags and `run`; `run_kw` passes `serve_params` and
    `on_job` through."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train-arch", default="zamba2-1.2b")
    ap.add_argument("--serve-arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="same-family smoke configs (CPU-sized)")
    ap.add_argument("--train-layers", type=int, default=None,
                    help="cut the training model to its first N layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--target-steps", type=int, default=40)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (default: a temporary directory)")
    ap.add_argument("--speed", type=float, default=40.0,
                    help="sim-seconds per wall-second; inf never sleeps")
    args = ap.parse_args(argv)

    def config(arch):
        cfg = get_config(ALIASES.get(arch, arch))
        return reduce_config(cfg) if args.reduced else cfg

    train_cfg, serve_cfg = config(args.train_arch), config(args.serve_arch)
    if args.train_layers:
        train_cfg = train_cfg.with_(n_layers=args.train_layers)
    return run(train_cfg, serve_cfg, device=args.device, batch=args.batch,
               seq=args.seq, target_steps=args.target_steps,
               ckpt_every=args.ckpt_every, speed=args.speed,
               ckpt_dir=args.ckpt_dir, **run_kw)


if __name__ == "__main__":
    main()
