"""On-demand serving through the scheduler service's front door.

    PYTHONPATH=src python -m repro_torch.launch.ondemand_serving [--device cpu]

The port's counterpart of `examples/ondemand_serving.py`: the execution
payload of the paper's *on-demand* job class.  Two bursts of requests are
admitted as ONDEMAND jobs through an `AdmissionQueue` (8 nodes at t = 0; 4
nodes at t = 2 s, announced 2 s ahead); the live scheduler service
(`CUA&SPAA` on 8 nodes) decides when each starts, and a `Launcher` turns
each start decision into a `ServeEngine` batch of the request plan
`plan_requests` makes.  The model is the example's (4 dense layers, d_model
256, 4 heads of 64, 2 kv heads, vocab 4096, f32), random from seed 0 or the
caller's (`run(params=...)`).  A determinism check serves the first batch
again and requires the same greedy tokens.  Runs on CUDA unless `--device
cpu` is given; with the default device and no CUDA it raises rather than
fall back.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

from repro_torch.core.job import JobType
from repro_torch.launch.elastic_cluster import plan_batch
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.service import (AdmissionQueue, Launcher, SchedulerService,
                                 ServiceConfig, SloPolicy)
from repro_torch.serving import Request, ServeEngine

CFG = ModelConfig(name="serve-demo", family="dense", n_layers=4, d_model=256, n_heads=4,
                  n_kv=2, d_ff=1024, vocab=4096, tie_embeddings=True,
                  param_dtype="float32", compute_dtype="float32", attn_block_q=64,
                  attn_block_kv=64)
MAX_SEQ = 256
# the fields of a decision row that read a clock
WALL_FIELDS = ("wall", "mono", "latency_ms")


class ServeLauncher(Launcher):
    """Execute on-demand start decisions as ServeEngine batches."""

    def __init__(self, engine: ServeEngine, vocab: int):
        self.engine = engine
        self.vocab = vocab
        self.batches = []                 # (jid, requests, wall_s)

    def start_job(self, job, size):
        if job.jtype is not JobType.ONDEMAND:
            return
        reqs = plan_batch(job, self.vocab)
        t0 = time.monotonic()
        self.engine.serve_batch(reqs)
        self.batches.append((job.jid, reqs, time.monotonic() - t0))


def admit_bursts(queue: AdmissionQueue) -> None:
    """The example's two bursts, then close the queue: the second is
    announced 2 s ahead, so notice-aware mechanisms (CUA) see it coming."""
    queue.submit_inference(nodes=8, hold_s=5.0)
    queue.submit_inference(nodes=4, hold_s=3.0, submit_time=2.0, notice_lead_s=2.0)
    queue.close()


def run(*, device="cuda", params=None) -> Dict:
    """Serve the two bursts on `device`; returns what the example prints."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to serve on the CPU")
    if params is None:
        params = init_params(CFG, seed=0, device=device)
    engine = ServeEngine(CFG, params, max_seq=MAX_SEQ, device=device)
    launcher = ServeLauncher(engine, CFG.vocab)
    queue = AdmissionQueue()
    admit_bursts(queue)
    # the launcher serves inline, so each event batch's latency includes
    # real model time: the 10 ms decision bound is for shadow mode
    svc = SchedulerService(
        ServiceConfig(n_nodes=8, mechanism="CUA&SPAA",
                      slo=SloPolicy(decision_p99_ms=30_000.0)),
        launcher=launcher)
    rep = svc.run_live(queue)

    batches: List[Dict] = []
    for jid, reqs, wall in launcher.batches:
        print(f"on-demand job {jid}: {len(reqs)} requests "
              f"(prompt lens {[len(r.prompt) for r in reqs]}) served in {wall:.2f}s")
        for r in reqs:
            ttfb = (r.first_token_at - r.submitted_at) * 1e3
            total = (r.done_at - r.submitted_at) * 1e3
            print(f"  req {r.rid}: {len(r.tokens_out)} tokens, ttfb={ttfb:.0f}ms "
                  f"total={total:.0f}ms head={r.tokens_out[:5]}")
        batches.append({
            "jid": jid, "prompt_lens": [len(r.prompt) for r in reqs],
            "tokens": [r.tokens_out for r in reqs], "wall_s": wall,
            "ttfb_ms": [(r.first_token_at - r.submitted_at) * 1e3 for r in reqs],
            "total_ms": [(r.done_at - r.submitted_at) * 1e3 for r in reqs]})
    n_tok = sum(len(t) for b in batches for t in b["tokens"])
    print(f"service drained: {rep.n_jobs} jobs, {rep.n_decisions} decisions, {n_tok} "
          f"tokens, decision p99={rep.latency['p99_ms']:.2f}ms, slo_ok={rep.ok}")
    decisions = [{k: v for k, v in row.items() if k not in WALL_FIELDS}
                 for row in svc.log.rows]
    print("decision log:")
    for row in decisions:
        print("  ", row)

    # determinism check: replaying the same plan gives the same greedy tokens
    _, reqs0, _ = launcher.batches[0]
    again = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
             for r in reqs0]
    engine.serve_batch(again)
    if not all(a.tokens_out == b.tokens_out for a, b in zip(reqs0, again)):
        raise AssertionError("greedy decode must be deterministic")
    print("determinism check passed")
    return {"device": str(device), "batches": batches, "n_jobs": rep.n_jobs,
            "n_decisions": rep.n_decisions, "decision_p99_ms": rep.latency["p99_ms"],
            "slo_ok": rep.ok, "decisions": decisions, "deterministic": True}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
