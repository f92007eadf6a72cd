"""Serving launcher: batched on-demand inference on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --reduced --requests 8 --max-new 32 [--device cpu]

Any dense, MoE or VLM arch serves (`--arch olmoe-1b-7b`; `--arch
deepseek-v2-236b` with a batch padded to at least its kv_lora tokens, 64
reduced, or decode fails as the reference's does; `--arch internvl2-1b`
text alone, as the reference's engine serves it, padded to at least its 64
head dims, 32 reduced, or decode overwrites the last prompt row as the
reference's does); the others raise.

Runs on CUDA unless `--device cpu` is given; with the default device and no
CUDA it raises rather than fall back.  Weights and prompts are random, from seed 0.
`--min-prompt-len` draws prompt lengths from [min, --prompt-len], so the
batch is left-padded.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import init_params
from repro_torch.serving import Request, ServeEngine


def draw_requests(vocab: int, n: int, min_len: int, max_len: int, max_new: int,
                  seed: int = 0):
    """n requests of random prompts, each of a length drawn from [min_len,
    max_len], from numpy's generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(min_len, max_len + 1)),
                                        dtype=np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--min-prompt-len", type=int, default=None,
                    help="draw prompt lengths from [this, --prompt-len]")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="param and compute dtype (default: the config's)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to serve on the CPU")
    cfg = get_config(ALIASES.get(args.arch, args.arch))
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.dtype:
        cfg = cfg.with_(param_dtype=args.dtype, compute_dtype=args.dtype)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.0f}M "
          f"layers={cfg.n_layers} dtype={cfg.compute_dtype} device={device}")
    params = init_params(cfg, seed=0, device=device)
    engine = ServeEngine(cfg, params, max_seq=args.max_seq, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    reqs = draw_requests(cfg.vocab, args.requests, args.min_prompt_len or args.prompt_len,
                         args.prompt_len, args.max_new)
    t0 = time.perf_counter()
    engine.serve_batch(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n = sum(len(r.tokens_out) for r in reqs)
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    stats = {
        "arch": cfg.name, "device": str(device), "dtype": cfg.compute_dtype,
        "requests": len(reqs), "prompt_lens": [len(r.prompt) for r in reqs],
        "tokens": n, "seconds": dt, "tok_per_s": n / dt,
        "ttft_s_max": max(ttft),
        "decode_step_s_median": (float(np.median(engine.step_seconds))
                                 if engine.step_seconds else None),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }
    print(f"{n} tokens / {len(reqs)} requests in {dt:.2f}s "
          f"({n/dt:.1f} tok/s), ttft max {1e3*max(ttft):.0f}ms")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt={len(r.prompt)} "
              f"ttft={1e3*(r.first_token_at-r.submitted_at):.0f}ms "
              f"tokens={r.tokens_out[:8]}...")
    stats["outputs"] = [r.tokens_out for r in reqs]
    return stats


if __name__ == "__main__":
    main()
