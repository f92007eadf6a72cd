#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py                 # every phase, on one card
    python3 chip_smoke.py --kernels-only  # phases 1 and 3 alone: the kernel
                                          # times, also from an older checkout

Phases, in order; any failure raises and the script exits non-zero:

  1. device  -- the card's name and power limit (nvidia-smi) and torch's
                device name; no CUDA device is an error.
  2. build   -- every hand-written kernel source in
                src/repro_torch/kernels/csrc with nvcc, one process per
                source, all started together, printing ptxas' registers /
                shared memory / spills and any "wgmma serialized" warning;
                then `cuobjdump -sass` of each library, printing per kernel
                function its HGMMA, HMMA, UTMALDG and FFMA instructions, and
                failing if the bf16 attention forward lacks HGMMA or UTMALDG,
                either bf16 attention backward kernel lacks HGMMA / HMMA, a
                bf16 SSD forward or backward product kernel lacks HGMMA, or
                ptxas serialized the wgmma of an SSD kernel.
  3. kernels -- each kernel against its plain torch version on the same
                inputs, in bf16 and f32: the attention kernels at the serving
                shapes (llama3-8b: H=32, K=8, D=128), at zamba2-1.2b's shared
                block (H=K=32, D=64) and at ragged / MQA / GQA shapes; the SSD
                scan and its backward at zamba2-1.2b's widths, the reduced
                config's and a test sweep's, and the backward (untimed) at
                the decay the model's init gives (its error against the
                plain version in f64 shown beside); decode at vlen 1, ragged, full
                and MQA (the split-KV runs); the SSD forward at chunks 32 to
                256 with n, p in {16, 32, 64}; and, in bf16, every kernel at
                the shapes phase 9 gives it (the prefill of a 4 x 38-token
                batch, decode over its 38-row cache, the SSD forward and
                backward and the attention forward and backward of 4 x 2048
                tokens at zamba2-1.2b's widths).  Tolerance: 1e-4 in f32 and 2e-2
                in bf16 against the plain version computed in f32 (the
                attention forward absolute, the SSD scan and the backward
                kernels relative to the largest reference magnitude).  Each
                case prints the kernel's, the plain version's and the library
                call's (where one exists) device time `ms` and host time
                `host_ms` (see `Clock`), beside the least time the card could
                take (bound_ms).  The library call is SDPA pinned to its
                fastest backend that accepts the case, named in the row.  A
                backward case times the backward alone: the plain version's
                and SDPA's backward are autograd over a retained graph.
                Then `torch.profiler`'s device time of each CUDA kernel that
                one flash_decode call, one bf16 ssd_scan call and one bf16
                SSD backward call launch, at the main path's shapes (L2
                flushed before each call).
  4. serve parity -- reduced llama3-8b in f32 (TF32 off), the same seeded
                params served on the card (kernels) and on the CPU (plain
                versions): prefill logits within 1e-4, greedy tokens equal.
  5. serve   -- `repro_torch.launch.serve.main` at llama3-8b's full widths,
                all 32 layers, bf16, 8 requests of 384-512 prompt tokens and
                64 new tokens each, max_seq 1024; the kernels' launch counts
                are zeroed just before and read just after.
  6. train parity -- reduced zamba2 in f32 (TF32 off), the same seeded
                params stepped once on the card (kernels) and on the CPU
                (plain versions): loss, grad norm and params within 1e-4;
                then the same step in bf16, which runs the tensor-core
                attention kernels through the model's autograd: loss and
                grad norm within 2e-2 relative (the kernels round P and dS
                to bf16 for their tensor-core products; the plain versions
                keep them in f32).
  7. train   -- `repro_torch.launch.train.main` at zamba2-1.2b's full
                widths (38 layers, bf16, remat full, 4 microbatches), 3 steps
                of 8 x 2048 tokens; the launch counts are zeroed just before
                and read just after and must equal `train_launches`.
  9. live seam -- `repro_torch.launch.elastic_cluster.main`: the scheduler
                service (CUA&SPAA, speed inf) over 8 slots of the card, three
                zamba2-1.2b training jobs at full width cut to 6 layers (bf16,
                4 x 2048 tokens a step, 12 steps, a checkpoint every 6) and
                llama3-8b at full width and depth serving the on-demand job
                (4 prompts of 29-38 tokens: the cache stays prompt-long, and
                each decode step writes its last row, as the reference's
                does).  Runs before the line of phase 8.  Fails unless its
                serve batch has the shapes phase 3 checked, every job
                reaches 12 steps with finite losses, the log
                holds the SPAA acquire, a shrink and the expand that repays
                it, each kernel launched as often as `train_launches` and the
                serve's layers say (counts zeroed just before, read just
                after), the on-demand tokens equal a second `serve_batch` of
                the same requests (the serve is deterministic; phase 3 holds
                the kernels to their plain versions at these shapes), and a
                malleable job preempted on the card
                resumes from its checkpoint with its params bit for bit.
  8. a JSON line {"kernels": [...]} with each kernel's launches in phases 5,
     7 and 9 and its numbers at its main path's shapes.
  10. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package `repro`.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import warnings
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


# ----------------------------------------------------------------- 2. build
# Kernel functions (by a part of their mangled name) that must run on the
# tensor cores, with the instructions each must contain (any one of a group).
TENSOR_CORE_KERNELS = {
    "flash_attention": {"fwd_sm90": (("HGMMA",), ("UTMALDG",))},
    "flash_attention_bwd": {"dq_sm90": (("HGMMA", "HMMA"),),
                            "dkv_sm90": (("HGMMA", "HMMA"),)},
    "ssd_scan_fwd": {"ssd_state_sm90": (("HGMMA",),), "ssd_scan_sm90": (("HGMMA",),)},
    "ssd_scan_bwd": {"ssd_dstate_sm90": (("HGMMA",),), "ssd_bwd_dx_sm90": (("HGMMA",),),
                     "ssd_bwd_dc_sm90": (("HGMMA",),)},
}
# Libraries whose kernels may have no wgmma serialized by ptxas (C7510-C7520:
# a wgmma under a runtime branch, a register written between issue and wait,
# registers short).
NO_SERIALIZED_WGMMA = ("ssd_scan_fwd", "ssd_scan_bwd")


def check_no_serialized_wgmma(logs: dict) -> None:
    """logs: library name -> nvcc output of a build made now.  Raises if
    ptxas reports serialized wgmma in a library of NO_SERIALIZED_WGMMA."""
    for lib in NO_SERIALIZED_WGMMA:
        bad = [line.strip() for line in logs.get(lib, "").splitlines() if "serialized" in line]
        if bad:
            raise AssertionError(f"{lib}: ptxas serialized wgmma: {bad}")


def check_tensor_cores(sass: dict) -> None:
    """sass: library name -> `_build.sass_counts` of it.  Raises unless every
    kernel of TENSOR_CORE_KERNELS exists and has each required instruction."""
    for lib, kernels in TENSOR_CORE_KERNELS.items():
        for marker, groups in kernels.items():
            fns = {fn: c for fn, c in sass[lib].items() if marker in fn}
            if not fns:
                raise AssertionError(f"{lib}: no kernel function named *{marker}*")
            for fn, c in fns.items():
                for group in groups:
                    if not any(c[op] for op in group):
                        raise AssertionError(f"{lib}: {fn} has no {' / '.join(group)}: {c}")


# --------------------------------------------------------------- 3. kernels
# Phase 9's sizes, which phase 3 also checks the kernels at: the training
# jobs' layers, steps, batch and sequence, and the on-demand batch that
# `plan_requests` plans for the demo's job (4 prompts of 29-38 tokens).
LIVE_TRAIN_LAYERS = 6     # zamba2-1.2b's first attention period
LIVE_TARGET_STEPS = 12
LIVE_BATCH, LIVE_SEQ = 4, 2048
LIVE_SERVE_BATCH, LIVE_SERVE_PROMPT = 4, 38


class Clock:
    """Times a Python call that launches device work, two ways.

    `host_ms`: the wall time of the call from a synchronised device to the
    device done with it (sync to sync), the L2 left warm: what a caller
    waits, the wrapper's host work included.

    `ms`: device time.  The L2 is flushed (a 256 MB memset), then a device
    sleep is queued that lasts longer than the call's host time, then the
    start event, the call and the end event.  The host has enqueued all of
    the call before the device leaves the sleep, so the events time the
    device's work alone, however long the wrapper's host work takes.
    Each is the mean over `iters` calls, after 3 warm-up calls."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        torch.cuda._sleep(1000)
        start, end = self._events()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 1e7 / start.elapsed_time(end)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def __call__(self, fn, iters: int):
        """(ms, host_ms) of fn."""
        cuda = self.torch.cuda
        for _ in range(3):
            fn()
        cuda.synchronize()
        host = 0.0
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            cuda.synchronize()
            host += time.perf_counter() - t0
        host_ms = 1e3 * host / iters
        cycles = int(self.cycles_per_ms * (2 * host_ms + 0.05))
        dev = 0.0
        for _ in range(iters):
            start, end = self._events()
            self.flush.zero_()
            cuda._sleep(cycles)
            start.record()
            fn()
            end.record()
            end.synchronize()
            dev += start.elapsed_time(end)
        return dev / iters, host_ms


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def sdpa_fastest(torch, clock, call, iters: int):
    """(ms, host_ms, backend) of `call` (an SDPA call) pinned with
    `sdpa_kernel` to each backend that accepts the case, the fastest by
    device time."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    best = None
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)

        def run(backend=backend):
            with sdpa_kernel(backend):
                return call()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # a refused backend warns, then raises
                run()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        ms, host_ms = clock(run, iters)
        if best is None or ms < best[0]:
            best = (ms, host_ms, name)
    if best is None:
        raise AssertionError("no SDPA backend accepts the case")
    return best


def timed_row(torch, clock, run, plain, lib, iters: int, flops, nbytes, dtn,
              lib_backward=False) -> dict:
    """The timing columns of a phase-3 row: kernel, plain version and the
    library call (an SDPA forward call, or None), beside the bound.  With
    lib_backward, `lib` is the backward of an SDPA graph already built on
    the default backend, timed as it is."""
    ms, host_ms = clock(run, iters)
    plain_ms, plain_host_ms = clock(plain, iters)
    if lib is None:
        lib_ms, lib_host_ms, lib_name = None, None, None
    elif lib_backward:
        (lib_ms, lib_host_ms), lib_name = clock(lib, iters), "default backward"
    else:
        lib_ms, lib_host_ms, lib_name = sdpa_fastest(torch, clock, lib, iters)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtn], nbytes / HBM_BYTES_PER_S
    return {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "plain_host_ms": plain_host_ms, "library_ms": lib_ms,
            "library_host_ms": lib_host_ms, "library": lib_name and f"sdpa:{lib_name}",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


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


def kernel_cases(torch, F, fa, fd, clock):
    """Run every kernel-vs-plain case; return the rows, keyed by case name."""
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rows = {}

    def rnd(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    cases = []
    for dt in ("bfloat16", "float32"):
        cases += [("flash_attention", dt, dict(B=8, S=512, H=32, K=8, D=128)),
                  ("flash_attention", dt, dict(B=2, S=2048, H=32, K=32, D=64)),
                  ("flash_attention", dt, dict(B=2, S=192, H=32, K=1, D=128)),
                  ("flash_attention", dt, dict(B=2, S=200, H=32, K=1, D=128))]
        cases += [("flash_decode", dt, dict(B=8, S=1024, H=32, K=8, D=128, vlen=vl))
                  for vl in (1, 513, 1024)]
        cases += [("flash_decode", dt, dict(B=2, S=192, H=32, K=1, D=128, vlen=192)),
                  ("flash_decode", dt, dict(B=2, S=192, H=32, K=1, D=128, vlen=150)),
                  ("flash_decode", dt, dict(B=2, S=1024, H=32, K=1, D=128, vlen=777)),
                  ("flash_decode", dt, dict(B=1, S=4096, H=32, K=8, D=128, vlen=3001))]
    # phase 9's own shapes (it runs bf16): its prefill, its training jobs'
    # shared block, and its decode over the prompt-long cache
    B, S = LIVE_SERVE_BATCH, LIVE_SERVE_PROMPT
    cases += [("flash_attention", "bfloat16", dict(B=B, S=S, H=32, K=8, D=128)),
              ("flash_attention", "bfloat16", dict(B=LIVE_BATCH, S=LIVE_SEQ, H=32, K=32, D=64)),
              ("flash_decode", "bfloat16", dict(B=B, S=S, H=32, K=8, D=128, vlen=S))]

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
        row = {"kernel": kname, "dtype": dtn, **c, "max_abs_err": err,
               **timed_row(torch, clock, run, plain, lib, iters, flops, nbytes, dtn)}
        print(json.dumps(row), flush=True)
        rows[(kname, dtn, tuple(sorted(c.items())))] = row
    return rows


def _kernel_name(key: str) -> str:
    """'void repro_torch::(anonymous namespace)::split_kernel<...>(...)'
    -> 'split_kernel'."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("::")[-1].split("<")[0]


def kernel_breakdown(torch, fd, ssd) -> dict:
    """Device time (ms) of each CUDA kernel a wrapper call launches, by
    torch.profiler over 10 calls at the main path's shapes, the L2 flushed
    before each call: {wrapper: {kernel name: ms per call}}."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    q, k, v = rnd(8, 1, 32, 128).to(bf), rnd(8, 1024, 8, 128).to(bf), rnd(8, 1024, 8, 128).to(bf)
    x, B, C = rnd(2, 2048, 64, 64).to(bf), rnd(2, 2048, 64).to(bf), rnd(2, 2048, 64).to(bf)
    dt, A, D = rnd(2, 2048, 64, scale=0.1).abs(), -torch.linspace(1.0, 16.0, 64, device="cuda"), \
        torch.ones(64, device="cuda")
    dy = rnd(2, 2048, 64, 64).to(bf)
    calls = {"flash_decode": lambda: fd.flash_decode(q, k, v, 513),
             "ssd_scan": lambda: ssd.ssd_scan(x, dt, A, B, C, D, chunk=256),
             "ssd_scan_bwd": lambda: ssd._launch_bwd(x, dt, A, B, C, D, dy, 256)}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out[name] = {_kernel_name(e.key): e.device_time_total / 10 / 1e3
                     for e in prof.key_averages() if "repro_torch" in e.key}
    print(json.dumps({"kernel_breakdown_ms": out}), flush=True)
    return out


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


# ------------------------------------------------ 3b. the training kernels
def ssd_cost(b, s, h, p, n, chunk, esize, backward=False):
    """(FLOPs, bytes) of the SSD scan or its backward on these shapes: only
    the causal (t, u) pairs of each chunk; each input read once, each output
    written once.  B and C are shared by the heads, so C.B^T (and, in the
    backward, dB and dC from the head-summed gate gradient) is one product
    per (batch, chunk).  Per head and chunk, forward: W.x over the pairs,
    C.S and the state update; backward: dy.x^T and dx over the pairs, and
    five (n x p x chunk) products (the state recomputed, dS, dC's, dx's and
    dB's state terms)."""
    pairs = chunk * (chunk + 1) // 2
    if backward:
        per_head = 2 * pairs * 2 * p + 5 * 2 * chunk * n * p
        shared = 3 * 2 * pairs * n
    else:
        per_head = 2 * pairs * p + 2 * 2 * chunk * n * p
        shared = 2 * pairs * n
    ins = esize * (b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + 2 * h)
    ys = esize * b * s * h * p
    flops = b * (s // chunk) * (h * per_head + shared)
    return flops, (2 * ins + ys) if backward else (ins + ys)


def _rel_err(out, ref):
    return (float((out.float() - ref.float()).abs().max())
            / (float(ref.float().abs().max()) + 1e-6))


def _row(torch, clock, kname, dtn, c, errs, flops, nbytes, run, plain, lib, iters,
         lib_backward=False):
    """Check the relative errors, time the three calls, print and return."""
    err_abs = max(e[0] for e in errs.values())
    err_rel = max(e[1] for e in errs.values())
    if not err_rel <= TOL[dtn]:
        raise AssertionError(f"{kname} {dtn} {c}: relative error {errs} > {TOL[dtn]}")
    row = {"kernel": kname, "dtype": dtn, **c, "max_abs_err": err_abs,
           "max_rel_err": err_rel, "rel_errs": {k: e[1] for k, e in errs.items()},
           **timed_row(torch, clock, run, plain, lib, iters, flops, nbytes, dtn,
                       lib_backward)}
    print(json.dumps(row), flush=True)
    return row


def training_kernel_cases(torch, F, fa, ssd, clock):
    """ssd_scan, ssd_scan_bwd and flash_attention_bwd against their plain
    versions; return the rows keyed like kernel_cases'."""
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    rows = {}

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)

    ssd_shapes = [dict(b=2, s=2048, h=64, p=64, n=64, chunk=256),   # zamba2-1.2b
                  dict(b=2, s=256, h=8, p=32, n=16, chunk=32),      # reduced zamba2
                  dict(b=2, s=512, h=2, p=16, n=8, chunk=128)]      # test sweep
    # the forward alone at chunks 32 to 256, n and p in {16, 32, 64}
    ssd_fwd_shapes = [dict(b=1, s=1024, h=8, p=p, n=n, chunk=ch) for p, n, ch in
                      ((16, 16, 32), (32, 64, 32), (64, 64, 32), (64, 32, 64),
                       (16, 64, 128), (64, 16, 128), (32, 32, 256), (64, 64, 256))]
    fa_shapes = [dict(B=2, S=2048, H=32, K=32, D=64),               # zamba2 shared block
                 dict(B=2, S=1024, H=32, K=8, D=128),               # GQA
                 dict(B=2, S=200, H=32, K=8, D=64)]                 # ragged
    # phase 9's own shapes (bf16): its jobs' batch at zamba2-1.2b's widths
    live_ssd = [dict(b=LIVE_BATCH, s=LIVE_SEQ, h=64, p=64, n=64, chunk=256)]
    live_fa = [dict(B=LIVE_BATCH, S=LIVE_SEQ, H=32, K=32, D=64)]
    for dtn in ("bfloat16", "float32"):
        dt = getattr(torch, dtn)
        bf16 = dtn == "bfloat16"
        fwd_bwd = ssd_shapes + (live_ssd if bf16 else [])
        for c in fwd_bwd + ssd_fwd_shapes:
            b, s, h, p, n, chunk = (c[k] for k in ("b", "s", "h", "p", "n", "chunk"))
            x, B, C = rnd((b, s, h, p), dt), rnd((b, s, n), dt), rnd((b, s, n), dt)
            # dt as the reference's test_ssd_kernel_sweep draws it (|N(0, 0.1)|),
            # A = -exp(a_log) as the model initialises it, in [-16, -1]
            dtv = rnd((b, s, h), torch.float32, 0.1).abs()
            A = -torch.linspace(1.0, 16.0, h, device="cuda")
            D = torch.ones(h, device="cuda")
            ins = (x, dtv, A, B, C, D)
            f32 = [t.float() for t in ins]
            esize = x.element_size()
            # forward
            y = ssd.ssd_scan(*ins, chunk=chunk)
            ref = ssd.ssd_scan_plain(*f32, chunk=chunk)
            torch.cuda.synchronize()
            errs = {"y": (float((y.float() - ref).abs().max()), _rel_err(y, ref))}
            flops, nbytes = ssd_cost(b, s, h, p, n, chunk, esize)
            rows[("ssd_scan", dtn, tuple(sorted(c.items())))] = _row(
                torch, clock, "ssd_scan", dtn, c, errs, flops, nbytes,
                lambda: ssd.ssd_scan(*ins, chunk=chunk),
                lambda: ssd.ssd_scan_plain(*ins, chunk=chunk), None,
                10 if c in fwd_bwd else 3)
            if c not in fwd_bwd:
                continue
            # backward
            dy = rnd((b, s, h, p), dt)
            got = ssd._launch_bwd(*ins, dy, chunk)
            refs = ssd.ssd_scan_bwd_plain(*f32, dy.float(), chunk=chunk)
            torch.cuda.synchronize()
            errs = {k: (float((a.float() - r).abs().max()), _rel_err(a, r))
                    for k, a, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, refs)}
            live = [t.detach().requires_grad_(True) for t in ins]
            y_plain = ssd.ssd_scan_plain(*live, chunk=chunk)
            flops, nbytes = ssd_cost(b, s, h, p, n, chunk, esize, backward=True)
            rows[("ssd_scan_bwd", dtn, tuple(sorted(c.items())))] = _row(
                torch, clock, "ssd_scan_bwd", dtn, c, errs, flops, nbytes,
                lambda: ssd._launch_bwd(*ins, dy, chunk),
                lambda: torch.autograd.grad(y_plain, live, dy, retain_graph=True),
                None, 10)
            del y_plain, live
        # the backward at the decay the model's init gives (dt = softplus(N(0, 1)),
        # hundreds of e-folds a chunk), where ddt and dA are small differences
        # of large sums: checked, not timed
        b, s, h, p, n, chunk = 2, 2048, 64, 64, 64, 256
        x, B, C, dy = rnd((b, s, h, p), dt), rnd((b, s, n), dt), rnd((b, s, n), dt), \
            rnd((b, s, h, p), dt)
        ins = (x, torch.nn.functional.softplus(rnd((b, s, h), torch.float32)),
               -torch.linspace(1.0, 16.0, h, device="cuda"), B, C, torch.ones(h, device="cuda"))
        got = ssd._launch_bwd(*ins, dy, chunk)
        refs = ssd.ssd_scan_bwd_plain(*(t.float() for t in ins), dy.float(), chunk=chunk)
        names = ("dx", "ddt", "dA", "dB", "dC", "dD")
        errs = {k: _rel_err(a, r) for k, a, r in zip(names, got, refs)}
        # beside it, the error against the plain version computed in f64
        # (shown, not checked: the f32 plain version's own rounding is of
        # the order of the tolerance here)
        refs = ssd.ssd_scan_bwd_plain(*(t.double() for t in ins), dy.double(), chunk=chunk)
        errs64 = {k: _rel_err(a, r) for k, a, r in zip(names, got, refs)}
        print(json.dumps({"kernel": "ssd_scan_bwd", "dtype": dtn, "decay": "model",
                          "max_rel_err": errs, "max_rel_err_vs_f64": errs64}), flush=True)
        if not max(errs.values()) <= TOL[dtn]:
            raise AssertionError(f"ssd_scan_bwd {dtn} at the model's decay: {errs} > {TOL[dtn]}")
        del got, refs
        for c in fa_shapes + (live_fa if bf16 else []):
            B, S, H, K, D = (c[k] for k in ("B", "S", "H", "K", "D"))
            scale = 1.0 / math.sqrt(D)
            q, k, v = rnd((B, S, H, D), dt), rnd((B, S, K, D), dt), rnd((B, S, K, D), dt)
            do = rnd((B, S, H, D), dt)
            o, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=scale)
            got = fa._launch_bwd(q, k, v, o, lse, do, causal=True, scale=scale)
            refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                                causal=True, scale=scale)
            torch.cuda.synchronize()
            errs = {n_: (float((a.float() - r).abs().max()), _rel_err(a, r))
                    for n_, a, r in zip(("dq", "dk", "dv"), got, refs)}
            flops, nbytes = attention_cost(B, S, S, H, K, D, D, q.element_size())
            flops = flops // 2 * 5           # S, dP, dV, dK and dQ over the causal pairs
            nbytes += q.element_size() * (2 * B * S * H * D + 2 * B * S * K * D) \
                + 4 * B * H * S              # do, dq read/written; dk, dv; lse
            live = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o_plain = fa.flash_attention_plain(*live, causal=True, scale=scale)
            o_lib = F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in live), is_causal=True, scale=scale,
                enable_gqa=True).transpose(1, 2)
            rows[("flash_attention_bwd", dtn, tuple(sorted(c.items())))] = _row(
                torch, clock, "flash_attention_bwd", dtn, c, errs, flops, nbytes,
                lambda: fa._launch_bwd(q, k, v, o, lse, do, causal=True, scale=scale),
                lambda: torch.autograd.grad(o_plain, live, do, retain_graph=True),
                lambda: torch.autograd.grad(o_lib, live, do, retain_graph=True), 10,
                lib_backward=True)
            del o_plain, o_lib, live
    return rows


def train_launches(cfg, microbatches: int) -> dict:
    """Each kernel's launches in one hybrid train step, from the layer
    structure and the remat nesting.  Per microbatch: G = n_layers //
    attn_every groups of attn_every Mamba-2 layers, each group followed by
    the shared attention block, then n_layers % attn_every tail layers.
    Under remat="full" each group is checkpointed and so is each Mamba-2
    layer in it (as in the reference), so a group's layer runs its forward
    three times (forward, the group's recompute, its own recompute), a tail
    layer twice and the shared block twice; each backward runs once."""
    k = cfg.attn_every
    groups, tail = cfg.n_layers // k, cfg.n_layers % k
    full = cfg.remat == "full"
    per_mb = {"ssd_scan": groups * k * (3 if full else 1) + tail * (2 if full else 1),
              "ssd_scan_bwd": cfg.n_layers,
              "flash_attention": groups * (2 if full else 1),
              "flash_attention_bwd": groups}
    return {name: microbatches * n for name, n in per_mb.items()}


# ------------------------------------------------------------ 6. train parity
def train_parity(torch):
    from repro_torch.configs.reduced import reduced
    from repro_torch.models import init_params
    from repro_torch.training import (AdamW, make_train_state, make_train_step,
                                      synthetic_batch)
    from repro_torch.training.optimizer import tree_leaves

    cfg = reduced("zamba2_1p2b")                    # f32 params and compute
    # eps 1e-3: Adam's first update g / (|g| + eps) would otherwise divide
    # the f32 noise of near-zero gradient elements by their own size
    opt = AdamW(lr=1e-3, eps=1e-3, warmup=1, total_steps=4)
    out = {}
    for dev in ("cpu", "cuda"):
        params = _to(init_params(cfg, seed=0, device="cpu"), dev)
        state, m = make_train_step(cfg, opt)(make_train_state(params, opt),
                                             synthetic_batch(cfg, 2, 64, device=dev))
        out[dev] = (state.params, {k: float(v) for k, v in m.items()})
    (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
    worst = 0.0
    for k in ("loss", "grad_norm"):
        worst = max(worst, abs(mg[k] - mc[k]) / max(1.0, abs(mc[k])))
    for a, b in zip(tree_leaves(pc), tree_leaves(pg)):
        worst = max(worst, float(((b.cpu() - a).abs() / (1 + a.abs())).max()))
    print(json.dumps({"train_parity": {"cpu": mc, "cuda": mg, "max_err": worst}}))
    if not worst <= 1e-4:
        raise AssertionError(f"reduced zamba2 train step differs cuda vs cpu by {worst} > 1e-4")

    # bf16: the tensor-core attention kernels round P and dS to bf16 before
    # their products (the plain versions keep f32), and the bf16 step rounds
    # every activation; 2e-2 relative on the loss and the grad norm
    cfg = cfg.with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    out = {}
    for dev in ("cpu", "cuda"):
        params = _to(init_params(cfg, seed=0, device="cpu"), dev)
        _, m = make_train_step(cfg, opt)(make_train_state(params, opt),
                                         synthetic_batch(cfg, 2, 64, device=dev))
        out[dev] = {k: float(v) for k, v in m.items()}
    mc, mg = out["cpu"], out["cuda"]
    worst = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("loss", "grad_norm"))
    print(json.dumps({"train_parity_bf16": {"cpu": mc, "cuda": mg, "max_rel_err": worst}}))
    if not worst <= 2e-2:
        raise AssertionError(f"bf16 reduced zamba2 train step differs cuda vs cpu by "
                             f"{worst} > 2e-2 relative")


# ----------------------------------------------------------------- 7. train
def full_width_train(torch, fa, ssd):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main

    argv = ["--arch", "zamba2-1.2b", "--steps", "3", "--batch", "8", "--seq", "2048"]
    counters = {"flash_attention": fa.flash_attention, "flash_attention_bwd": fa._launch_bwd,
                "ssd_scan": ssd.ssd_scan, "ssd_scan_bwd": ssd._launch_bwd}
    for fn in counters.values():
        fn.launches = 0
    stats = train_main(argv)
    launches = {name: fn.launches for name, fn in counters.items()}
    print(json.dumps({"train": stats, "launches": launches}))
    cfg = get_config("zamba2_1p2b")
    expected = {k: 3 * n for k, n in train_launches(cfg, cfg.train_microbatches).items()}
    print(f"launches {launches}, expected {expected} (3 steps)")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    losses = stats["losses"]
    if not (len(losses) == 3 and all(math.isfinite(x) for x in losses)
            and abs(losses[0] - math.log(cfg.vocab)) < 1.5):
        raise AssertionError(f"losses {losses}: not 3 finite, or the first far from "
                             f"ln {cfg.vocab} = {math.log(cfg.vocab):.2f}")
    print(json.dumps({"step_seconds": stats["step_seconds"],
                      "tokens_per_s": stats["tokens_per_s"],
                      "max_memory_allocated": stats["max_memory_allocated"]}))
    return launches


# ------------------------------------------------------------- 9. live seam

def live_seam(torch, fa, fd, ssd):
    """The scheduler service driving the port on 8 slots of the card
    (`repro_torch.launch.elastic_cluster.main`, CUA&SPAA, speed inf): three
    zamba2-1.2b jobs at full width cut to LIVE_TRAIN_LAYERS layers, bf16,
    4 x 2048 tokens a step, and llama3-8b at full width and depth serving
    the on-demand job.  Returns the phase's launches per kernel."""
    import shutil
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.launch.elastic_cluster import MAX_SEQ, plan_batch
    from repro_torch.launch.elastic_cluster import main as cluster_main
    from repro_torch.models import init_params
    from repro_torch.runtime import ElasticJob
    from repro_torch.runtime.elastic import _state_leaves
    from repro_torch.serving import ServeEngine

    ckpt = ROOT / "build" / "live_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    print(f"disk free under build/: {shutil.disk_usage(ckpt).free / 2**30:.1f} GiB")
    serve_cfg = get_config("llama3_8b")
    serve_params = init_params(serve_cfg, seed=9, device="cuda")
    argv = ["--train-arch", "zamba2-1.2b", "--train-layers", str(LIVE_TRAIN_LAYERS),
            "--serve-arch", "llama3-8b", "--batch", str(LIVE_BATCH), "--seq", str(LIVE_SEQ),
            "--target-steps", str(LIVE_TARGET_STEPS), "--ckpt-every", "6",
            "--speed", "inf", "--ckpt-dir", str(ckpt)]
    counters = {"flash_attention": fa.flash_attention, "flash_decode": fd.flash_decode,
                "ssd_scan": ssd.ssd_scan, "ssd_scan_bwd": ssd._launch_bwd,
                "flash_attention_bwd": fa._launch_bwd}
    jobs = {}
    for fn in counters.values():
        fn.launches = 0
    stats = cluster_main(argv, serve_params=serve_params,
                         on_job=lambda job: jobs.__setitem__(job.jid, job))
    launches = {name: fn.launches for name, fn in counters.items()}

    log = stats["cluster_log"]
    print(json.dumps({"live": {
        "decisions": stats["n_decisions"], "digest": stats["digest"],
        "cluster_log": log,
        "jobs": {jid: {k: j[k] for k in ("kind", "steps_done", "shrink_count",
                                         "preempt_count", "step_seconds", "steady_step_s",
                                         "tokens_per_s", "ckpt_seconds", "reshard_s",
                                         "losses")}
                 for jid, j in stats["jobs"].items()},
        "served": [{k: s[k] for k in ("jid", "nodes", "prompt_lens", "seconds", "ttft_s",
                                      "tok_per_s")} for s in stats["served"]],
        "wall_s": stats["wall_s"], "max_memory_allocated": stats["max_memory_allocated"],
        "launches": launches}}), flush=True)

    # the serve batches had the shapes phase 3 held the kernels to
    for s in stats["served"]:
        if (len(s["prompt_lens"]), max(s["prompt_lens"])) != (LIVE_SERVE_BATCH,
                                                              LIVE_SERVE_PROMPT):
            raise AssertionError(f"on-demand batch of prompts {s['prompt_lens']}: not the "
                                 f"{LIVE_SERVE_BATCH} x {LIVE_SERVE_PROMPT} phase 3 checked")
    # every job trained to the target with finite losses
    for jid, j in stats["jobs"].items():
        if j["steps_done"] != LIVE_TARGET_STEPS or not all(map(math.isfinite, j["losses"])):
            raise AssertionError(f"job {jid}: {j['steps_done']} steps, losses {j['losses']}")
    # the arrival policy vacated the on-demand nodes by a shrink, repaid by an expand
    shrunk = {e["jid"] for e in log if e["event"] == "shrink"}
    if not ({"event": "od_acquire", "jid": -1, "source": "SPAA", "nodes": 4} in log
            and shrunk and shrunk <= {e["jid"] for e in log if e["event"] == "expand"}):
        raise AssertionError(f"no SPAA acquire with a shrink and its repaying expand: {log}")
    # each kernel: launched in this phase, the training kernels as many times
    # as train_launches says for the steps taken, serving 32 layers a prefill
    # and 32 a decode step
    cfg = get_config("zamba2_1p2b").with_(n_layers=LIVE_TRAIN_LAYERS)
    steps = sum(len(job.step_seconds) for job in jobs.values())
    serves = len(stats["served"])
    decode_steps = sum(max(len(t) for t in s["tokens"]) - 1 for s in stats["served"])
    per_step = train_launches(cfg, 1)
    expected = {name: n * steps for name, n in per_step.items()}
    expected["flash_attention"] += serve_cfg.n_layers * serves
    expected["flash_decode"] = serve_cfg.n_layers * decode_steps
    print(f"launches {launches}, expected {expected} ({steps} train steps, "
          f"{serves} serve batches, {decode_steps} decode steps)")
    if launches != expected or not all(launches.values()):
        raise AssertionError(f"kernel launches {launches} != {expected}")
    # the served tokens are those of the same requests served again outside
    # the cluster, on an engine over the same params (a determinism check)
    engine = ServeEngine(serve_cfg, serve_params, max_seq=MAX_SEQ, device="cuda")
    for s in stats["served"]:
        reqs = plan_batch(SimpleNamespace(jid=s["jid"], size=s["nodes"]), serve_cfg.vocab)
        engine.serve_batch(reqs)
        if [r.tokens_out for r in reqs] != s["tokens"]:
            raise AssertionError(f"on-demand job {s['jid']}: tokens differ from a "
                                 f"second serve_batch")
    print(f"on-demand tokens equal a second serve_batch: {len(stats['served'])} batch(es)")
    del engine, serve_params
    # preempt -> resume on the card from the checkpoint, bit for bit
    jid, job = next((jid, job) for jid, job in sorted(jobs.items()) if job.kind == "malleable")
    before = [t.clone() for t in _state_leaves(job.state.params)]
    t0 = time.perf_counter()
    job.preempt(warning=True)
    t_preempt = time.perf_counter() - t0
    again = ElasticJob(jid, job.cfg, kind="malleable", batch=job.batch, seq=job.seq,
                       ckpt_dir=job.ckpt_dir, seed=job.seed)
    t0 = time.perf_counter()
    again.resume(["cuda"])
    t_resume = time.perf_counter() - t0
    after = _state_leaves(again.state.params)
    same = len(before) == len(after) and all(
        a.is_cuda and torch.equal(a, b) for a, b in zip(after, before))
    print(json.dumps({"preempt_resume": {"jid": jid, "step": again.step_idx,
                                         "preempt_s": t_preempt, "resume_s": t_resume,
                                         "params_bit_equal": same}}))
    if not (same and again.step_idx == job.step_idx):
        raise AssertionError(f"job {jid}: resume on the card did not restore the params "
                             f"bit for bit (step {again.step_idx} vs {job.step_idx})")
    del jobs, job, again, before, after
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1 and 3 alone (the kernel-vs-plain cases and their times)")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    phase("1. device")
    smi = device_info(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_scan as ssd

    if not args.kernels_only:
        phase("2. build")
        t0 = time.perf_counter()
        sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        logs = _build.build(sources)
        print(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f}s")
        for name, log in logs.items():
            for line in log.splitlines():
                if any(w in line for w in ("Compiling entry", "registers", "spill",
                                           "Performance", "serialized")):
                    print(f"  {name}: {line.strip()}")
        sass = {name: _build.sass_counts(name) for name in sources}
        for name, fns in sass.items():
            for fn, counts in fns.items():
                print(f"  {name}: {fn} {counts}")
        check_tensor_cores(sass)
        check_no_serialized_wgmma(logs)

    phase("3. kernels vs plain")
    clock = Clock(torch)
    rows = kernel_cases(torch, F, fa, fd, clock)
    rows.update(training_kernel_cases(torch, F, fa, ssd, clock))
    del clock
    kernel_breakdown(torch, fd, ssd)
    if args.kernels_only:
        print(smi)
        return 0

    phase("4. serve parity (reduced llama3-8b, f32, cuda vs cpu)")
    slice_parity(torch)

    phase("5. full-width llama3-8b serve (bf16, 32 layers)")
    serve_launches = full_width_serve(torch, fa, fd)

    phase("6. train parity (reduced zamba2, f32 and bf16, cuda vs cpu)")
    train_parity(torch)

    phase("7. full-width zamba2-1.2b train (bf16, 38 layers, 3 steps)")
    train_launches_seen = full_width_train(torch, fa, ssd)

    phase(f"9. live seam (CUA&SPAA, 8 slots on one card: zamba2-1.2b cut to "
          f"{LIVE_TRAIN_LAYERS} layers x 3 jobs, llama3-8b serving)")
    live_launches = live_seam(torch, fa, fd, ssd)

    phase("8. kernels")
    main_shape = {
        "flash_attention": ("bfloat16", dict(B=8, S=512, H=32, K=8, D=128)),
        "flash_decode": ("bfloat16", dict(B=8, S=1024, H=32, K=8, D=128, vlen=513)),
        "ssd_scan": ("bfloat16", dict(b=2, s=2048, h=64, p=64, n=64, chunk=256)),
        "ssd_scan_bwd": ("bfloat16", dict(b=2, s=2048, h=64, p=64, n=64, chunk=256)),
        "flash_attention_bwd": ("bfloat16", dict(B=2, S=2048, H=32, K=32, D=64)),
    }
    csrc = "src/repro_torch/kernels/csrc/"
    meta = {
        "flash_attention": (csrc + "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:85"),
        "flash_decode": (csrc + "flash_decode.cu", "src/repro/kernels/flash_decode.py:70"),
        "ssd_scan": (csrc + "ssd_scan_fwd.cu", "src/repro/kernels/ssd_scan.py:68"),
        "ssd_scan_bwd": (csrc + "ssd_scan_bwd.cu", "src/repro/kernels/ssd_scan.py:68"),
        "flash_attention_bwd": (csrc + "flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention.py:85"),
    }
    kernels = []
    for name, (dtn, c) in main_shape.items():
        row = rows[(name, dtn, tuple(sorted(c.items())))]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train": train_launches_seen.get(name, 0),
                   "live": live_launches[name]}
        kernels.append({"name": name, "route": "cuda", "source": meta[name][0],
                        "replaces": meta[name][1], "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        **{k: row[k] for k in ("max_abs_err", "ms", "host_ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms",
                                               "library")}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
