"""Training launcher on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --steps 3 --batch 8 --seq 2048 [--ckpt-dir DIR] [--device cpu]

The port's counterpart of `repro.launch.train`, without `--mesh` (one card).
Runs on CUDA unless `--device cpu` is given; with the default device and no
CUDA it raises rather than fall back.  `--reduced` swaps in the same-family
smoke config and `--layers N` cuts the depth (for a model whose full depth
does not fit on one card: `--arch olmoe-1b-7b --layers 8`).  Weights are
random from seed 0 and the data is `synthetic_batch`, with the patch
(`--arch internvl2-1b`: `--seq` text tokens after its 256 patches) or frame
(`--arch seamless-m4t-medium`: 1,024 frames) embeddings it draws.  Restart after a
failure is re-running the same command: the launcher resumes from the
newest checkpoint in `--ckpt-dir`.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import init_params
from repro_torch.training import (AdamW, checkpoint, make_train_state,
                                  make_train_step, synthetic_batch)
from repro_torch.training.optimizer import tree_leaves


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="same-family smoke config (CPU-sized)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")
    cfg = get_config(ALIASES.get(args.arch, args.arch))
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.microbatches:
        cfg = cfg.with_(train_microbatches=args.microbatches)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    if args.batch % cfg.train_microbatches:
        raise ValueError(f"--batch {args.batch} does not split into "
                         f"{cfg.train_microbatches} microbatches")
    params = init_params(cfg, seed=0, device=device)
    # the leaves, not cfg.param_count(): the config's formula undercounts
    # xLSTM (its copy keeps the reference's)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.0f}M "
          f"layers={cfg.n_layers} microbatches={cfg.train_microbatches} "
          f"remat={cfg.remat} dtype={cfg.param_dtype} device={device}")

    opt = AdamW(lr=args.lr, warmup=min(100, args.steps // 10 + 1),
                total_steps=args.steps)
    state = make_train_state(params, opt, compress=args.compress_grads)
    start = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        start = checkpoint.latest_step(args.ckpt_dir)
        state = checkpoint.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")
    step_fn = make_train_step(cfg, opt, microbatches=cfg.train_microbatches,
                              compress_grads=args.compress_grads)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    losses, gnorms, step_s = [], [], []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        ts = time.perf_counter()
        batch = synthetic_batch(cfg, args.batch, args.seq, step=i, device=device)
        state, m = step_fn(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # waits for the step
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        gnorms.append(gnorm)
        print(f"step {i:5d} loss={loss:.4f} gnorm={gnorm:.3f} "
              f"({step_s[-1]:.2f}s)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, i + 1, state)
    dt = time.perf_counter() - t0
    n = args.steps - start
    tokens = n * args.batch * args.seq
    print(f"{n} steps in {dt:.1f}s ({tokens / max(dt, 1e-9):.0f} tokens/s)")
    return {
        "arch": cfg.name, "device": str(device), "steps": n, "seconds": dt,
        "tokens_per_s": tokens / max(dt, 1e-9), "step_seconds": step_s,
        "losses": losses, "grad_norms": gnorms,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }


if __name__ == "__main__":
    main()
