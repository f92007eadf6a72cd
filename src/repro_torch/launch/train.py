"""Training launcher: one GPU, or a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --steps 3 --batch 8 --seq 2048 [--ckpt-dir DIR] [--device cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3-8b --reduced --mesh 2x2 --device cpu

The port's counterpart of `repro.launch.train`.  Runs on CUDA unless
`--device cpu` is given; with the default device and no CUDA it raises
rather than fall back.  `--reduced` swaps in the same-family smoke config
and `--layers N` cuts the depth (for a model whose full depth does not fit
on one card: `--arch olmoe-1b-7b --layers 8`).  Weights are random from
seed 0 and the data is `synthetic_batch`, with the patch (`--arch
internvl2-1b`: `--seq` text tokens after its 256 patches) or frame (`--arch
seamless-m4t-medium`: 1,024 frames) embeddings it draws.  Restart after a
failure is re-running the same command: the launcher resumes from the
newest checkpoint in `--ckpt-dir`.

In a world of ranks, one process a device (torchrun's `RANK`,
`WORLD_SIZE`, `LOCAL_RANK` and `MASTER_ADDR` / `MASTER_PORT`, or a process
group the caller set up, as `runtime/ranks.py` does), the launcher trains
on a mesh, as the reference's does: `--mesh AxB` is ("data", "model"),
`AxBxC` ("pod", "data", "model"), and with no `--mesh` the mesh is (n, 1)
over the n ranks.  The state is placed by `sharding.tree_shardings`, the
step pins its gradients to the same placements, each batch is placed by
`batch_sharding`, a resume takes each rank's own shard, and rank 0 alone
prints.  CUDA ranks take the card `LOCAL_RANK` names.  With no world the
one-device path runs.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ALIASES, get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch.mesh import init_world, make_mesh
from repro_torch.models import init_params, set_mesh
from repro_torch.sharding import batch_axes, distribute, tree_shardings
from repro_torch.training import (AdamW, checkpoint, make_train_state,
                                  make_train_step, synthetic_batch)
from repro_torch.training.optimizer import tree_leaves


def parse_mesh(spec: str, device_type: str = "cpu", axis_names=("data", "model")):
    """The mesh of "AxB" (data x model) or "AxBxC" (pod x data x model)
    over the default process group's ranks."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 3:
        axis_names = ("pod", "data", "model")
    elif len(dims) != 2:
        raise ValueError(f"--mesh {spec}: give AxB or AxBxC")
    return make_mesh(dims, axis_names[:len(dims)], device_type)


def _rank_device(device: torch.device, own_world: bool) -> torch.device:
    """The card of this rank: LOCAL_RANK's under torchrun, else the one the
    caller made current; the CPU for CPU ranks."""
    if device.type != "cuda":
        return device
    if own_world:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cuda", torch.cuda.current_device())


def _scalar(t) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default=None,
                    help="AxB or AxBxC over the world's ranks, e.g. 2x2")
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
    own_world = not tdist.is_initialized() and "WORLD_SIZE" in os.environ
    if own_world:
        device = init_world(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                            _rank_device(device, True))
    elif tdist.is_initialized():
        device = _rank_device(device, False)
    elif args.mesh:
        raise ValueError(f"--mesh {args.mesh} needs a world of ranks: run under "
                         f"torchrun (RANK, WORLD_SIZE) or in a process group")
    try:
        return _train(args, device)
    finally:
        if tdist.is_initialized():
            set_mesh(None)
            if own_world:
                tdist.destroy_process_group()


def _train(args, device: torch.device) -> dict:
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
    mesh = None
    if tdist.is_initialized():
        backend = {"cuda": "nccl", "cpu": "gloo"}[device.type]
        if tdist.get_backend() != backend:
            raise ValueError(f"--device {device.type} needs {backend} ranks, "
                             f"not {tdist.get_backend()}")
        mesh = (parse_mesh(args.mesh, device.type) if args.mesh else
                make_mesh((tdist.get_world_size(), 1), ("data", "model"), device.type))
        set_mesh(mesh, batch_axes(mesh))
    lead = not tdist.is_initialized() or tdist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    params = init_params(cfg, seed=0, device=device)
    # the leaves, not cfg.param_count(): the config's formula undercounts
    # xLSTM (its copy keeps the reference's)
    n_params = sum(t.numel() for t in tree_leaves(params))
    shape = None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))
    say(f"arch={cfg.name} params={n_params/1e6:.0f}M "
        f"layers={cfg.n_layers} microbatches={cfg.train_microbatches} "
        f"remat={cfg.remat} dtype={cfg.param_dtype} device={device}"
        + (f" mesh={shape}" if mesh is not None else ""))

    opt = AdamW(lr=args.lr, warmup=min(100, args.steps // 10 + 1),
                total_steps=args.steps)
    state = make_train_state(params, opt, compress=args.compress_grads)
    sh = None
    if mesh is not None:
        sh = tree_shardings(state, cfg, mesh)
        state = distribute(state, sh, mesh)
    del params
    start = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        start = checkpoint.latest_step(args.ckpt_dir)
        state = checkpoint.restore(args.ckpt_dir, state, placements=sh, mesh=mesh)
        say(f"resumed from step {start}")
    step_fn = make_train_step(cfg, opt, microbatches=cfg.train_microbatches,
                              compress_grads=args.compress_grads,
                              grad_shardings=None if sh is None else sh.params)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    losses, gnorms, step_s = [], [], []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        ts = time.perf_counter()
        batch = synthetic_batch(cfg, args.batch, args.seq, step=i, device=device, mesh=mesh)
        state, m = step_fn(state, batch)
        loss, gnorm = _scalar(m["loss"]), _scalar(m["grad_norm"])  # waits for the step
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        gnorms.append(gnorm)
        say(f"step {i:5d} loss={loss:.4f} gnorm={gnorm:.3f} "
            f"({step_s[-1]:.2f}s)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, i + 1, state)
    dt = time.perf_counter() - t0
    n = args.steps - start
    tokens = n * args.batch * args.seq
    say(f"{n} steps in {dt:.1f}s ({tokens / max(dt, 1e-9):.0f} tokens/s)")
    return {
        "arch": cfg.name, "device": str(device), "mesh": shape, "steps": n,
        "seconds": dt, "tokens_per_s": tokens / max(dt, 1e-9), "step_seconds": step_s,
        "losses": losses, "grad_norms": gnorms,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }

if __name__ == "__main__":
    main()
