"""Quickstart: train a small LM end to end on one device.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --steps 300 --size 100m \
        [--device cpu]

The port's counterpart of `examples/quickstart.py`: the same two model sizes
(`20m`: 6 layers of d_model 384; `100m`: 12 layers of d_model 768; both
dense, d_head 64, tied embeddings, f32), the same AdamW schedule (warmup
20), the same `synthetic_batch` stream (seed 0, one batch a step) and the
same log line every 20 steps and at the last.  Runs on CUDA unless `--device
cpu` is given; with the default device and no CUDA it raises rather than
fall back.  Weights are random from seed 0 (`init_params`), or the caller's
(`run(params=...)`).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.training import (AdamW, checkpoint, make_train_state,
                                  make_train_step, synthetic_batch)

SIZES = {
    "20m": ModelConfig(name="quick-20m", family="dense", n_layers=6,
                       d_model=384, n_heads=6, n_kv=6, d_ff=1536,
                       vocab=8192, tie_embeddings=True),
    "100m": ModelConfig(name="quick-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv=12, d_ff=3072,
                        vocab=16384, tie_embeddings=True),
}
LOG_EVERY = 20
CKPT_EVERY = 100


def config(size: str) -> ModelConfig:
    """The example's model at `size`, in f32 as the example trains it."""
    return SIZES[size].with_(param_dtype="float32", compute_dtype="float32")


def run(size: str = "20m", *, steps: int = 200, batch: int = 4, seq: int = 256,
        lr: float = 3e-3, ckpt_dir: Optional[str] = None, device="cuda",
        params=None) -> Dict:
    """Train `steps` steps; returns what the example prints (the logged
    steps) and every step's metrics."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")
    cfg = config(size)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M device={device}")
    if params is None:
        params = init_params(cfg, seed=0, device=device)
    opt = AdamW(lr=lr, warmup=20, total_steps=steps)
    state = make_train_state(params, opt)
    step_fn = make_train_step(cfg, opt)

    log, nll, gnorm, lrs = [], [], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        b = synthetic_batch(cfg, batch, seq, seed=0, step=i, device=device)
        state, m = step_fn(state, b)
        nll.append(float(m["nll"]))                     # waits for the step
        gnorm.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        if i % LOG_EVERY == 0 or i == steps - 1:
            tput = batch * seq * (i + 1) / (time.perf_counter() - t0)
            log.append({"step": i, "nll": nll[-1], "gnorm": gnorm[-1], "lr": lrs[-1],
                        "tok_per_s": tput})
            print(f"step {i:4d} nll={nll[-1]:.3f} gnorm={gnorm[-1]:.2f} "
                  f"lr={lrs[-1]:.2e} tok/s={tput:,.0f}", flush=True)
        if ckpt_dir and (i + 1) % CKPT_EVERY == 0:
            checkpoint.save(ckpt_dir, i + 1, state)
            print(f"  checkpointed step {i + 1}")
    seconds = time.perf_counter() - t0
    print(f"done in {seconds:.1f}s")
    return {"arch": cfg.name, "device": str(device), "steps": steps, "seconds": seconds,
            "log": log, "nll": nll, "grad_norm": gnorm, "lr": lrs,
            "tokens_per_s": batch * seq * steps / seconds}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="20m", choices=sorted(SIZES))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.size, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
               ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
