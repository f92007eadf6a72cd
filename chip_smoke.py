#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device  -- the card's name and power limit (nvidia-smi) and torch's
                device name; no CUDA device is an error.
  2. build   -- both hand-written kernels from src/repro_torch/kernels/csrc
                with nvcc, printing ptxas' registers / shared memory / spills.
  3. kernels -- each kernel against its plain torch version on the same
                inputs, in bf16 and f32, at the serving path's shapes
                (llama3-8b: H=32, K=8, D=128) and at ragged / MQA shapes.
                Tolerance: 1e-4 in f32 and 2e-2 in bf16 against the plain
                version computed in f32.  Each case prints the kernel's, the
                plain version's and F.scaled_dot_product_attention's time
                (CUDA events, L2 flushed before each launch) beside the
                least time the card could take (bound_ms).
  4. parity  -- reduced llama3-8b in f32 (TF32 off), the same seeded params
                served on the card (kernels) and on the CPU (plain versions):
                prefill logits within 1e-4, greedy tokens equal.
  5. serve   -- `repro_torch.launch.serve.main` at llama3-8b's full widths,
                all 32 layers, bf16, 8 requests of 384-512 prompt tokens and
                64 new tokens each, max_seq 1024; the kernels' launch counts
                are zeroed just before and read just after.
  6. a JSON line {"kernels": [...]} with each kernel's launches in phase 5
     and its numbers at the serving shapes.
  7. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package `repro`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # f32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
L2_FLUSH_BYTES = 256 << 20           # > the 50 MB L2


def phase(name: str) -> None:
    print(f"\n=== {name}", flush=True)


# ---------------------------------------------------------------- 1. device
def device_info(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}")
    return smi


# --------------------------------------------------------------- 3. kernels
def time_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of fn over iters launches, L2 flushed before each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def attention_cost(B, Sq, Skv, H, K, D, Dv, esize, causal=True, vlen=None):
    """(FLOPs, bytes) the function needs on these inputs: each input byte
    read once (a cache only up to vlen), the output written once."""
    if vlen is not None:
        pairs = Sq * vlen
        kv_rows = vlen
    elif causal:
        shift = Skv - Sq
        pairs = sum(min(Skv, max(0, i + shift + 1)) for i in range(Sq))
        kv_rows = Skv
    else:
        pairs, kv_rows = Sq * Skv, Skv
    flops = 2 * B * H * pairs * (D + Dv)
    nbytes = esize * (B * Sq * H * D + B * kv_rows * K * (D + Dv) + B * Sq * H * Dv)
    return flops, nbytes


def kernel_cases(torch, F, fa, fd):
    """Run every kernel-vs-plain case; return the rows, keyed by case name."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rows = {}

    def rnd(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    cases = []
    for dt in ("bfloat16", "float32"):
        cases += [("flash_attention", dt, dict(B=8, S=512, H=32, K=8, D=128)),
                  ("flash_attention", dt, dict(B=2, S=192, H=32, K=1, D=128)),
                  ("flash_attention", dt, dict(B=2, S=200, H=32, K=1, D=128))]
        cases += [("flash_decode", dt, dict(B=8, S=1024, H=32, K=8, D=128, vlen=vl))
                  for vl in (1, 513, 1024)]
        cases += [("flash_decode", dt, dict(B=2, S=192, H=32, K=1, D=128, vlen=192)),
                  ("flash_decode", dt, dict(B=2, S=192, H=32, K=1, D=128, vlen=150))]

    for kname, dtn, c in cases:
        dt = getattr(torch, dtn)
        B, S, H, K, D = c["B"], c["S"], c["H"], c["K"], c["D"]
        scale = 1.0 / math.sqrt(D)
        vlen = c.get("vlen")
        sq = 1 if kname == "flash_decode" else S
        q, k, v = rnd((B, sq, H, D), dt), rnd((B, S, K, D), dt), rnd((B, S, K, D), dt)
        qf, kf, vf = q.float(), k.float(), v.float()
        if kname == "flash_attention":
            run = lambda: fa.flash_attention(q, k, v, causal=True, scale=scale)  # noqa: E731
            plain = lambda: fa.flash_attention_plain(q, k, v, causal=True, scale=scale)  # noqa: E731
            ref = fa.flash_attention_plain(qf, kf, vf, causal=True, scale=scale)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=scale, enable_gqa=True)
            iters = 10
        else:
            run = lambda: fd.flash_decode(q, k, v, vlen, scale=scale)  # noqa: E731
            plain = lambda: fd.flash_decode_plain(q, k, v, vlen, scale=scale)  # noqa: E731
            ref = fd.flash_decode_plain(qf, kf, vf, vlen, scale=scale)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), k[:, :vlen].transpose(1, 2),
                v[:, :vlen].transpose(1, 2), scale=scale, enable_gqa=True)
            iters = 50
        out = run()
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        if not (out.shape == ref.shape and out.dtype == dt and err <= TOL[dtn]):
            raise AssertionError(f"{kname} {dtn} {c}: max_abs_err {err} > {TOL[dtn]} "
                                 f"or shape/dtype {tuple(out.shape)}/{out.dtype}")
        flops, nbytes = attention_cost(B, sq, S, H, K, D, D, q.element_size(),
                                       vlen=vlen)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtn], nbytes / HBM_BYTES_PER_S
        row = {"kernel": kname, "dtype": dtn, **c, "max_abs_err": err,
               "ms": time_ms(torch, run, iters, flush),
               "plain_ms": time_ms(torch, plain, iters, flush),
               "library_ms": time_ms(torch, lib, iters, flush),
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes}
        print(json.dumps(row), flush=True)
        rows[(kname, dtn, tuple(sorted(c.items())))] = row
    del flush
    return rows


# ---------------------------------------------------------------- 4. parity
def slice_parity(torch):
    import numpy as np
    from repro_torch.configs.reduced import reduced
    from repro_torch.models import init_params, prefill
    from repro_torch.serving import Request, ServeEngine

    cfg = reduced("llama3_8b")                      # f32 params and compute
    params = init_params(cfg, seed=0, device="cpu")
    params_gpu = _to(params, "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in (40, 57, 64, 33)]
    toks = np.stack([np.pad(p, (64 - len(p), 0)) for p in prompts]).astype(np.int64)
    lc, _ = prefill(params, torch.from_numpy(toks), cfg)
    lg, _ = prefill(params_gpu, torch.from_numpy(toks).cuda(), cfg)
    err = float((lg.cpu() - lc).abs().max())
    print(f"prefill logits max_abs_err cuda vs cpu: {err}")
    if not err <= 1e-4:
        raise AssertionError(f"prefill logits differ by {err} > 1e-4")
    outs = {}
    for dev, p in (("cpu", params), ("cuda", params_gpu)):
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=16) for i, pr in enumerate(prompts)]
        ServeEngine(cfg, p, max_seq=128, device=dev).serve_batch(reqs)
        outs[dev] = [r.tokens_out for r in reqs]
    print(f"greedy tokens equal: {outs['cpu'] == outs['cuda']} "
          f"(first request {outs['cuda'][0]})")
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError(f"greedy tokens differ: {outs}")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ----------------------------------------------------------------- 5. serve
def full_width_serve(torch, fa, fd):
    from repro_torch.launch.serve import main as serve_main

    argv = ["--arch", "llama3-8b", "--requests", "8", "--prompt-len", "512",
            "--min-prompt-len", "384", "--max-new", "64", "--max-seq", "1024",
            "--dtype", "bfloat16"]
    fa.flash_attention.launches = 0
    fd.flash_decode.launches = 0
    stats = serve_main(argv)
    launches = {"flash_attention": fa.flash_attention.launches,
                "flash_decode": fd.flash_decode.launches}
    outputs = stats.pop("outputs")
    print(json.dumps({"serve": stats, "launches": launches}))
    expected = {"flash_attention": 32, "flash_decode": 32 * 63}
    print(f"launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    if any(len(o) != 64 or not all(0 <= t < 128256 for t in o) for o in outputs):
        raise AssertionError("a request did not return 64 tokens in the vocab")
    if not (math.isfinite(stats["tok_per_s"]) and stats["ttft_s_max"] > 0):
        raise AssertionError(f"bad serve stats {stats}")
    # a decode step reads every weight once: 2 bytes x ~8.03e9 params
    from repro_torch.configs import get_config
    weight_bytes = 2 * get_config("llama3_8b").param_count()
    print(json.dumps({"decode_ms_per_step_approx":
                      1e3 * (stats["seconds"] - stats["ttft_s_max"]) / 63,
                      "decode_step_bound_ms": 1e3 * weight_bytes / HBM_BYTES_PER_S}))
    return launches


def main() -> int:
    import torch
    import torch.nn.functional as F

    phase("1. device")
    smi = device_info(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build(["flash_attention", "flash_decode"])
    print(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase("3. kernels vs plain")
    rows = kernel_cases(torch, F, fa, fd)

    phase("4. slice parity (reduced llama3-8b, f32, cuda vs cpu)")
    slice_parity(torch)

    phase("5. full-width llama3-8b serve (bf16, 32 layers)")
    launches = full_width_serve(torch, fa, fd)

    phase("6. kernels")
    main_shape = {
        "flash_attention": ("bfloat16", dict(B=8, S=512, H=32, K=8, D=128)),
        "flash_decode": ("bfloat16", dict(B=8, S=1024, H=32, K=8, D=128, vlen=513)),
    }
    meta = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:85"),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:70"),
    }
    kernels = []
    for name, (dtn, c) in main_shape.items():
        row = rows[(name, dtn, tuple(sorted(c.items())))]
        kernels.append({"name": name, "route": "cuda", "source": meta[name][0],
                        "replaces": meta[name][1], "launches": launches[name],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
