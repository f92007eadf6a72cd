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
                the decay the model's init gives (f32 held to the plain
                version computed in f64, bf16 to the f32 one, each error shown
                beside the other); decode at vlen 1, ragged, full
                and MQA (the split-KV runs); the SSD forward at chunks 32 to
                256 with n, p in {16, 32, 64}; the SSD forward with its final
                state (y and the f32 state) at phase 10's shape in bf16 and at
                two small shapes in f32 (one phase 6's); in bf16, every kernel
                at the shapes phases 9 and 10 give it (the prefill of a 4 x
                38-token batch, decode over its 38-row cache, the SSD forward
                and backward and the attention forward and backward of 4 x
                2048 tokens at zamba2-1.2b's widths; phase 10's shared-block
                prefill of 8 x 512 tokens and its decode over the 576-row
                cache at the first and the last valid length); in bf16 at
                olmoe-1b-7b's heads (H = K = 16, D = 128): phase 14's
                prefill of 8 prompts padded to the longest, its decode over
                the 1024-row cache at the first and the last valid length,
                and phase 15's attention forward and backward of 2 x 2048
                tokens; and, in f32,
                at the shapes phase 11 gives them (the serve demo's two
                prefills and decodes over their prompt-long caches,
                quickstart's attention forward and backward).  Tolerance: 1e-4 in f32 and 2e-2
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
  6. train and serve parity -- reduced zamba2 in f32 (TF32 off), the same
                seeded params stepped once on the card (kernels) and on the
                CPU (plain versions): loss, grad norm and params within 1e-4;
                then the same step in bf16, which runs the tensor-core
                attention kernels through the model's autograd: loss and
                grad norm within 2e-2 relative (the kernels round P and dS
                to bf16 for their tensor-core products; the plain versions
                keep them in f32).  Then reduced zamba2 served in f32 on the
                card and on the CPU: a 64-token prefill (two SSD chunks, the
                final state from the kernel) and 8 greedy decode steps,
                logits and every cache leaf within 1e-4, tokens equal.
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
  10. hybrid serve -- zamba2-1.2b at full width and depth (38 Mamba-2
                layers, the shared block after every 6), bf16, random weights
                from seed 0, served as the reference serves hybrid models
                (`prefill`, then greedy `decode_step`; no engine): 8 prompts
                of 512 tokens, the attention cache grown to 576 rows, 64 new
                tokens.  Prints TTFT, tok/s, the median decode step, peak
                device memory and the decode step's byte bound; launches
                (counts zeroed just before, read just after) must be
                ssd_scan 38 (each with its final state), flash_attention 6
                and flash_decode 6 x 63.  A second serve must give the same
                tokens; the teacher-forced gap between decode and `forward`
                at full width is printed.
  11. launchers -- `repro_torch.launch.quickstart.main` (20m, f32, 20 steps
                of 4 x 256) and `repro_torch.launch.ondemand_serving.main`
                (the demo's two bursts through the service, then its
                determinism check) on the card; fails unless the bursts had
                the shapes phase 3 checked, the first nll is near ln(vocab)
                and the launches equal what the layers and steps say.
  12. decision sweep -- `Experiment(device="torch")` (the port's
                `core.decision_torch`: plain torch ops, no hand-written
                kernel) over all 13 registered mechanisms: the reference
                benchmark's grid (W1/W2/W4/W5 x 12 seeds, 40 jobs a cell,
                624 cells) replayed in f64 and f32, and a Theta-scale grid
                (600 jobs on 4392 nodes, W5, load 1.15, seeds 0-3, 4096
                calls captured a kernel) in f64; serial (processes=0).
                Prints each report's summary and, per replay, the CUDA-event
                time of one call, the CUDA operations it launches and their
                device time (torch.profiler), the apportion rounds, the
                padded bytes and their byte bound, and the host's numpy
                replay time of the same calls.  Fails unless f64 equals the
                numpy engine exactly, f32 meets the reference's invariants,
                the Theta grid drops nothing, each replay takes at most 40 us
                of device time a decision, and the bench grid's metrics
                equal the same grid run without the replay.
  13. MoE parity -- reduced olmoe-1b-7b in f32 (TF32 off) and its two
                variants (capacity factor 0.5, so prefill drops assignments;
                a shared expert and a dense first block), the same seeded
                params on the card (kernels) and on the CPU (plain
                versions): prefill logits within 1e-4, `ServeEngine`'s greedy
                tokens equal, one train step's loss, grad norm and params
                within 1e-4 (AdamW eps 1e-3).
  14. MoE serve -- `repro_torch.launch.serve.main` at olmoe-1b-7b's full
                width and depth (16 layers, 64 experts top-8, bf16), random
                weights from seed 0, 8 requests of 384-512 prompt tokens and
                64 new each, max_seq 1024.  Launches (counts zeroed just
                before, read just after) must be flash_attention 16 and
                flash_decode 16 x 63, the batch the shape phase 3 checked,
                and a second serve of the same requests on an engine over
                the same seeded params must give the same tokens.  Prints
                TTFT, tok/s, the median decode step, peak memory, the decode
                step's byte bound (every weight is read: the capacity buffer
                runs every expert) and `torch.profiler`'s top CUDA kernels
                and the device's busy share in one prefill and one decode
                step.
  15. MoE train -- `repro_torch.launch.train.main` at olmoe-1b-7b's full
                width cut to 8 of its 16 layers (memory: 16 layers' bf16
                params and grads, f32 grad sums and f32 AdamW moments need
                about 111 GB; 8 layers about 57 GB and the activations),
                bf16, remat "full", 4 microbatches, 3 steps of 8 x 2048
                tokens.  Fails unless the losses are finite and the
                attention launches equal `train_launches` (dense layout).
                Prints the step times, tokens/s and peak memory.
  16. campaigns -- `repro_torch.campaign.run_campaign` over
                examples/campaigns/mini.toml (16 cells) and faulty.toml (4
                cells), offline and serial, into a directory under build/
                (removed after); each campaign's grid replayed through
                `core.decision_torch` on the card (`spec.to_experiment` with
                `Experiment(device="torch", device_capture=4096)`) in f64,
                and mini's also in f32; then `launch/fault_sweep.main` at its
                defaults.  Prints, per replay, its report and phase 12's
                measures (calls, the CUDA operations of one call and their
                device time, the busy share of the CUDA-event time).  Fails
                unless every artifact equals results/campaigns/<name>/ apart
                from provenance.grid_key (it hashes the fixture's absolute
                path), each f64 replay is exact with 0 dropped calls, f32
                meets the reference's invariants, the metrics equal the grid
                run without the replay, each replay takes at most 40 us of
                device time a call, the fault sweep writes
                results/faults/mtbf_sweep.json byte for byte, and no
                hand-written kernel launched (counts zeroed just before,
                read just after).
  8. a JSON line {"decision_sweep": [...]} (phase 12's rows), a JSON line
     {"campaign_sweep": [...]} (phase 16's), then a JSON line {"kernels":
     [...]} with each kernel's launches in phases 5, 7, 9, 10, 11, 14, 15
     and 16 and its numbers at its main path's shapes.
  last, the line {"ok": true, "device": {...}}.

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
# Phase 10's sizes: full-width zamba2-1.2b serving 8 prompts of 512 tokens
# (two SSD chunks) and 64 new tokens, the attention cache grown to 576 rows
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = 8, 512, 64
HYBRID_CACHE = HYBRID_PROMPT + HYBRID_NEW
# Phase 11's sizes: the serve demo's two bursts as `plan_requests` plans
# them (batch, longest prompt), whose caches stay prompt-long (d_head 64 is
# their largest axis), and quickstart's 20m model at its own batch and seq
DEMO_SERVE_SHAPES = ((8, 29), (4, 24))
QUICK_STEPS, QUICK_BATCH, QUICK_SEQ = 20, 4, 256
# Phase 14's sizes: full-width olmoe-1b-7b serving MOE_REQUESTS requests of
# MOE_PROMPT prompt tokens (lengths drawn by `launch.serve.draw_requests`),
# MOE_NEW new tokens, a MOE_MAX_SEQ-row cache; olmoe's heads (H = K = 16)
MOE_REQUESTS, MOE_PROMPT, MOE_NEW, MOE_MAX_SEQ = 8, (384, 512), 64, 1024
MOE_HEADS = dict(H=16, K=16, D=128)
# Phase 15's: olmoe-1b-7b cut to MOE_TRAIN_LAYERS layers, MOE_TRAIN_STEPS
# steps of MOE_TRAIN_BATCH x MOE_TRAIN_SEQ tokens (2 x 2048 a microbatch)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 8, 3, 8, 2048


def moe_serve_batch():
    """(batch, padded prompt length) of phase 14's requests: the draws of
    `launch.serve.draw_requests` (numpy, seed 0), made here so that
    `--kernels-only` also runs in a checkout older than that function;
    phase 14 checks that its batch has this shape."""
    import numpy as np
    from repro_torch.configs import get_config
    vocab = get_config("olmoe_1b_7b").vocab
    rng = np.random.default_rng(0)
    lens = []
    for _ in range(MOE_REQUESTS):
        lens.append(int(rng.integers(MOE_PROMPT[0], MOE_PROMPT[1] + 1)))
        rng.integers(0, vocab, lens[-1], dtype=np.int32)
    return MOE_REQUESTS, max(lens)


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
    moe_b, moe_s = moe_serve_batch()
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
    # phase 10's: the shared block's prefill, and its decode over the grown
    # cache at the first and the last step's valid length
    B, S = HYBRID_BATCH, HYBRID_PROMPT
    cases += [("flash_attention", "bfloat16", dict(B=B, S=S, H=32, K=32, D=64))]
    cases += [("flash_decode", "bfloat16", dict(B=B, S=HYBRID_CACHE, H=32, K=32, D=64, vlen=vl))
              for vl in (S + 1, HYBRID_CACHE - 1)]
    # phase 11's (f32): the serve demo's prefill and its decode over the
    # prompt-long cache, and quickstart's training forward
    for B, S in DEMO_SERVE_SHAPES:
        cases += [("flash_attention", "float32", dict(B=B, S=S, H=4, K=2, D=64)),
                  ("flash_decode", "float32", dict(B=B, S=S, H=4, K=2, D=64, vlen=S))]
    cases += [("flash_attention", "float32", dict(B=QUICK_BATCH, S=QUICK_SEQ, H=6, K=6, D=64))]
    # phase 14's (bf16, olmoe's heads: G = 1 at D = 128): the prefill and
    # the decode over the grown cache at the first and the last valid
    # length; phase 15's training forward (2 x 2048 a microbatch)
    cases += [("flash_attention", "bfloat16", dict(B=moe_b, S=moe_s, **MOE_HEADS))]
    cases += [("flash_decode", "bfloat16", dict(B=moe_b, S=MOE_MAX_SEQ, **MOE_HEADS, vlen=vl))
              for vl in (moe_s + 1, moe_s + MOE_NEW - 1)]
    cases += [("flash_attention", "bfloat16", dict(B=2, S=MOE_TRAIN_SEQ, **MOE_HEADS))]

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
    -> 'split_kernel' (template arguments dropped before the scope)."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0].split("::")[-1]


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

    def rnd(shape, dt, scale=1.0, gen=g):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

    # the final-state cases draw from a generator of their own, so the
    # draws of the cases that were here before them stay as they were
    g_final = torch.Generator(device="cuda")
    g_final.manual_seed(3)

    def rnd_final(shape, dt, scale=1.0):
        return rnd(shape, dt, scale, gen=g_final)

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
    # phase 11's quickstart backward (f32); phase 15's backward (bf16, D = 128)
    quick_fa = [dict(B=QUICK_BATCH, S=QUICK_SEQ, H=6, K=6, D=64)]
    moe_fa = [dict(B=2, S=MOE_TRAIN_SEQ, **MOE_HEADS)]
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
        # the forward with its final state (hybrid prefill): phase 10's shape
        # in bf16; in f32 a small shape and phase 6's reduced zamba2 prefill
        final_shapes = [dict(b=HYBRID_BATCH, s=HYBRID_PROMPT, h=64, p=64, n=64, chunk=256)] \
            if bf16 else [dict(b=2, s=512, h=8, p=64, n=64, chunk=256),
                          dict(b=2, s=64, h=8, p=32, n=16, chunk=32)]
        for c in final_shapes:
            b, s, h, p, n, chunk = (c[k] for k in ("b", "s", "h", "p", "n", "chunk"))
            x, B, C = (rnd_final((b, s, h, p), dt), rnd_final((b, s, n), dt),
                       rnd_final((b, s, n), dt))
            ins = (x, rnd_final((b, s, h), torch.float32, 0.1).abs(),
                   -torch.linspace(1.0, 16.0, h, device="cuda"), B, C,
                   torch.ones(h, device="cuda"))
            y, st = ssd.ssd_scan(*ins, chunk=chunk, return_final_state=True)
            ry, rst = ssd.ssd_scan_plain(*(t.float() for t in ins), chunk=chunk,
                                         return_final_state=True)
            torch.cuda.synchronize()
            if st.shape != (b, h, p, n) or st.dtype != torch.float32:
                raise AssertionError(f"final state {tuple(st.shape)} {st.dtype}")
            errs = {"y": (float((y.float() - ry).abs().max()), _rel_err(y, ry)),
                    "state": (float((st - rst).abs().max()), _rel_err(st, rst))}
            flops, nbytes = ssd_cost(b, s, h, p, n, chunk, x.element_size())
            nbytes += 4 * b * h * p * n          # the state, written once
            rows[("ssd_scan_final_state", dtn, tuple(sorted(c.items())))] = _row(
                torch, clock, "ssd_scan_final_state", dtn, c, errs, flops, nbytes,
                lambda: ssd.ssd_scan(*ins, chunk=chunk, return_final_state=True),
                lambda: ssd.ssd_scan_plain(*ins, chunk=chunk, return_final_state=True),
                None, 10)
            # the same call without the state: what writing the state costs
            flops, nbytes = ssd_cost(b, s, h, p, n, chunk, x.element_size())
            y0 = ssd.ssd_scan(*ins, chunk=chunk)
            errs = {"y": (float((y0.float() - ry).abs().max()), _rel_err(y0, ry))}
            rows[("ssd_scan", dtn, tuple(sorted(c.items())))] = _row(
                torch, clock, "ssd_scan", dtn, c, errs, flops, nbytes,
                lambda: ssd.ssd_scan(*ins, chunk=chunk),
                lambda: ssd.ssd_scan_plain(*ins, chunk=chunk), None, 10)
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
        refs = ssd.ssd_scan_bwd_plain(*(t.double() for t in ins), dy.double(), chunk=chunk)
        errs64 = {k: _rel_err(a, r) for k, a, r in zip(names, got, refs)}
        print(json.dumps({"kernel": "ssd_scan_bwd", "dtype": dtn, "decay": "model",
                          "max_rel_err": errs, "max_rel_err_vs_f64": errs64}), flush=True)
        # f32 is held to the plain version computed in f64: at this decay
        # the f32 plain version is itself rounded by about the tolerance.
        # bf16 is held to the f32 plain version, as everywhere.
        checked = errs64 if dtn == "float32" else errs
        if not max(checked.values()) <= TOL[dtn]:
            raise AssertionError(f"ssd_scan_bwd {dtn} at the model's decay: {checked} > "
                                 f"{TOL[dtn]}")
        del got, refs
        for c in fa_shapes + (live_fa + moe_fa if bf16 else quick_fa):
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
    """Each kernel's launches in one train step, from the layer structure
    and the remat nesting.

    Hybrid, per microbatch: G = n_layers // attn_every groups of attn_every
    Mamba-2 layers, each group followed by the shared attention block, then
    n_layers % attn_every tail layers.  Under remat="full" each group is
    checkpointed and so is each Mamba-2 layer in it (as in the reference),
    so a group's layer runs its forward three times (forward, the group's
    recompute, its own recompute), a tail layer twice and the shared block
    twice; each backward runs once.

    Dense layout (dense and MoE blocks, `pre_layers` included), per
    microbatch: each of the n_layers blocks runs attention forward once,
    twice under remat="full" (each block is checkpointed), and its backward
    once; no SSD kernel."""
    full = cfg.remat == "full"
    if cfg.family != "hybrid":
        per_mb = {"ssd_scan": 0, "ssd_scan_bwd": 0,
                  "flash_attention": cfg.n_layers * (2 if full else 1),
                  "flash_attention_bwd": cfg.n_layers}
        return {name: microbatches * n for name, n in per_mb.items()}
    k = cfg.attn_every
    groups, tail = cfg.n_layers // k, cfg.n_layers % k
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


def _greedy(torch, params, cfg, toks, n_new: int, cache_rows: int):
    """Hybrid serving as the reference serves it (`prefill`, then greedy
    `decode_step`; no engine): prefill the prompts, grow the attention
    cache to `cache_rows` rows, decode n_new - 1 tokens, each to the host
    as the engine takes it.  Returns (the prefill's logits and cache, each
    decode step's logits, the tokens (B, n_new), TTFT s, each decode
    step's s)."""
    from repro_torch.models import decode_step, prefill
    S = toks.shape[1]
    sync = torch.cuda.synchronize if toks.is_cuda else (lambda: None)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(params, toks, cfg)
        pre = (logits, [t.clone() for t in (*cache["mamba"], *cache["attn"])])
        grown = []
        for c in cache["attn"]:
            full = c.new_zeros((*c.shape[:2], cache_rows, *c.shape[3:]))
            full[:, :, :S] = c
            grown.append(full)
        cache["attn"] = tuple(grown)
        tok = logits.argmax(-1)
        out = [tok.tolist()]
        ttft = time.perf_counter() - t0
        steps, step_s = [], []
        for i in range(n_new - 1):
            ts = time.perf_counter()
            logits, cache = decode_step(params, cache, tok[:, None], S + i, cfg)
            tok = logits.argmax(-1)
            out.append(tok.tolist())
            step_s.append(time.perf_counter() - ts)
            steps.append(logits)
    return pre, steps, [list(t) for t in zip(*out)], ttft, step_s


def hybrid_serve_parity(torch):
    """Reduced zamba2 served in f32 on the card (ssd_scan with its final
    state, flash_attention, flash_decode) and on the CPU (the plain
    versions) from the same seeded params: a 64-token prefill (two SSD
    chunks) and 8 greedy decode steps; logits within 1e-4, every cache leaf
    within 1e-4 (atol and rtol: the SSD states grow past 1), tokens equal."""
    import numpy as np
    from repro_torch.configs.reduced import reduced
    from repro_torch.models import init_params

    cfg = reduced("zamba2_1p2b")
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 64)))
    out = {dev: _greedy(torch, p, cfg, toks.to(dev), 9, 72)
           for dev, p in (("cpu", params), ("cuda", _to(params, "cuda")))}
    (cl, cc), csteps, ctoks, _, _ = out["cpu"]
    (gl, gc), gsteps, gtoks, _, _ = out["cuda"]
    err = {"logits": max(float((g.cpu() - c).abs().max())
                         for g, c in zip([gl, *gsteps], [cl, *csteps]))}
    leaf_ok = True
    for name, g, c in zip(("conv_x", "conv_bc", "ssm", "attn_k", "attn_v"), gc, cc):
        err[name] = float((g.cpu() - c).abs().max())
        leaf_ok &= torch.allclose(g.cpu(), c, atol=1e-4, rtol=1e-4)
    print(json.dumps({"hybrid_serve_parity": {"max_abs_err": err,
                                              "tokens_equal": gtoks == ctoks,
                                              "tokens": gtoks[0]}}))
    if not (err["logits"] <= 1e-4 and leaf_ok and gtoks == ctoks):
        raise AssertionError(f"reduced zamba2 serving differs cuda vs cpu: {err}, "
                             f"tokens equal {gtoks == ctoks}")


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


# --------------------------------------------------------- 10. hybrid serve
def _zeroed_counters(fa, fd, ssd):
    """Set every kernel's launch count to 0; returns a function that reads
    them (the SSD forward's final-state launches as ssd_scan_final_state)."""
    counters = {"flash_attention": fa.flash_attention, "flash_decode": fd.flash_decode,
                "ssd_scan": ssd.ssd_scan, "ssd_scan_bwd": ssd._launch_bwd,
                "flash_attention_bwd": fa._launch_bwd}
    for fn in counters.values():
        fn.launches = 0
    ssd.ssd_scan.final_state_launches = 0

    def read():
        out = {name: fn.launches for name, fn in counters.items()}
        out["ssd_scan_final_state"] = ssd.ssd_scan.final_state_launches
        return out
    return read


def full_width_hybrid_serve(torch, fa, fd, ssd):
    """zamba2-1.2b at full width and depth (38 Mamba-2 layers, the shared
    block after every 6), bf16, random weights from seed 0, serving
    HYBRID_BATCH prompts of HYBRID_PROMPT tokens and HYBRID_NEW new tokens
    greedy through `prefill` and `decode_step`.  Counts are zeroed just
    before the first serve and read just after; a second serve of the same
    prompts must give the same tokens.  Returns the launches."""
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import tree_leaves

    gc.collect()                 # what earlier phases left in reference cycles
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cfg = get_config("zamba2_1p2b")
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (HYBRID_BATCH, HYBRID_PROMPT))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zeroed_counters(fa, fd, ssd)
    (logits, cache), steps, tokens, ttft, step_s = _greedy(
        torch, params, cfg, toks, HYBRID_NEW, HYBRID_CACHE)
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in steps)
    state_bytes = sum(t.numel() * t.element_size() for t in cache[:3])
    row_bytes = sum(t.numel() * t.element_size() for t in cache[3:]) // HYBRID_PROMPT
    del steps, cache
    decode_s = sum(step_s)
    n_tok = HYBRID_BATCH * HYBRID_NEW
    stats = {"ttft_s": ttft, "decode_s": decode_s, "tok_per_s": n_tok / (ttft + decode_s),
             "decode_tok_per_s": HYBRID_BATCH * (HYBRID_NEW - 1) / decode_s,
             "decode_step_ms_median": 1e3 * sorted(step_s)[len(step_s) // 2],
             "decode_step_ms_first_last": [1e3 * step_s[0], 1e3 * step_s[-1]],
             "max_memory_allocated": peak, "allocated_before_params": before,
             "phase_peak_bytes": peak - before, "params": n_params,
             "param_bytes": 2 * n_params, "mamba_state_bytes": state_bytes,
             "attn_cache_bytes": row_bytes * HYBRID_CACHE}
    print(json.dumps({"hybrid_serve": stats, "launches": launches,
                      "first_tokens": [t[0] for t in tokens]}), flush=True)
    n_groups = cfg.n_layers // cfg.attn_every
    expected = {"flash_attention": n_groups, "flash_decode": n_groups * (HYBRID_NEW - 1),
                "ssd_scan": cfg.n_layers, "ssd_scan_bwd": 0, "flash_attention_bwd": 0,
                "ssd_scan_final_state": cfg.n_layers}
    print(f"launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    if not (finite and all(len(t) == HYBRID_NEW and all(0 <= v < cfg.vocab for v in t)
                           for t in tokens)):
        raise AssertionError("non-finite logits, or a request without "
                             f"{HYBRID_NEW} tokens in the vocab")
    # a decode step reads every weight, reads and writes every Mamba state
    # and reads the attention cache up to its valid length (on average the
    # prompt and half the new tokens)
    step_bytes = 2 * n_params + 2 * state_bytes + row_bytes * (HYBRID_PROMPT + HYBRID_NEW // 2)
    bound_ms = 1e3 * step_bytes / HBM_BYTES_PER_S
    print(json.dumps({"decode_step_bound_ms": bound_ms}))
    # determinism: the same prompts served again
    again = _greedy(torch, params, cfg, toks, HYBRID_NEW, HYBRID_CACHE)[2]
    print(f"hybrid serve deterministic: {again == tokens}")
    if again != tokens:
        raise AssertionError("a second serve of the same prompts gave other tokens")
    # teacher-forced consistency at full width, as tests/test_archs.py checks
    # the reduced configs: f32 decode within its 5e-2 of f32 forward.  In
    # bf16 the 38 random layers move the forward itself by log-softmax gaps
    # of several units from the f32 forward of the same weights, so bf16
    # decode is held to the f32 forward within 1.5 times the bf16 forward's
    # own gap: decode rounds no worse than the chunked scan does.
    gaps = decode_vs_forward(torch, cfg, params, toks)
    print(json.dumps({"hybrid_decode_vs_forward": gaps}))
    g16 = gaps["bfloat16"]
    if not (max(gaps["float32"]["decode_vs_forward"]) < 5e-2
            and max(g16["decode_vs_f32_forward"]) <= 1.5 * max(g16["forward_vs_f32_forward"])):
        raise AssertionError(f"full-width decode differs from forward: {gaps}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def decode_vs_forward(torch, cfg, params, toks) -> dict:
    """Prefill the first half of each prompt, decode the next 8 true tokens
    (teacher-forced), and compare each step's log-softmax with `forward`
    over the whole prompt at the same position: the largest gap per step,
    the prefill's last logits first.  In cfg's bf16 and in f32 from the same
    params widened exactly; the bf16 forward and decode are also held
    against the f32 forward, which says how much of their gap to each other
    is bf16 rounding."""
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.training.optimizer import tree_map

    half = toks.shape[1] // 2

    def gap(a, b):
        return [float((torch.log_softmax(a[:, i].float(), -1)
                       - torch.log_softmax(b[:, i].float(), -1)).abs().max())
                for i in range(a.shape[1])]

    def run(c, p):
        with torch.no_grad():
            full = forward(p, toks, c)[:, half - 1:half + 8, :c.vocab].float()
            lg, cache = prefill(p, toks[:, :half], c)
            cache["attn"] = tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 8))
                                  for t in cache["attn"])
            outs = [lg]
            for t in range(half, half + 8):
                lg, cache = decode_step(p, cache, toks[:, t:t + 1], t, c)
                outs.append(lg)
        return full, torch.stack(outs, 1).float()

    f32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    full32, dec32 = run(f32, params32)
    del params32
    full16, dec16 = run(cfg, params)
    return {"float32": {"decode_vs_forward": gap(dec32, full32),
                        "max_abs_logit": float(full32.abs().max())},
            "bfloat16": {"decode_vs_forward": gap(dec16, full16),
                         "forward_vs_f32_forward": gap(full16, full32),
                         "decode_vs_f32_forward": gap(dec16, full32)}}


# ------------------------------------------------------ 11. the two launchers
def launchers_on_card(torch, fa, fd, ssd):
    """`repro_torch.launch.quickstart` (20m, f32, QUICK_STEPS steps of
    QUICK_BATCH x QUICK_SEQ) and `repro_torch.launch.ondemand_serving` (the
    demo's two bursts through the service, then its determinism check) on
    the card, each through its `main`.  Counts zeroed just before, read
    just after.  Returns the launches."""
    import gc

    from repro_torch.launch import ondemand_serving, quickstart

    gc.collect()
    torch.cuda.empty_cache()
    counters = _zeroed_counters(fa, fd, ssd)
    q = quickstart.main(["--size", "20m", "--steps", str(QUICK_STEPS), "--batch",
                         str(QUICK_BATCH), "--seq", str(QUICK_SEQ)])
    d = ondemand_serving.main([])
    torch.cuda.synchronize()
    launches = counters()
    print(json.dumps({"quickstart": {k: q[k] for k in ("seconds", "tokens_per_s", "nll",
                                                       "grad_norm")},
                      "ondemand_serving": {k: d[k] for k in ("n_jobs", "n_decisions",
                                                             "decision_p99_ms", "slo_ok",
                                                             "deterministic")},
                      "served": [{k: b[k] for k in ("jid", "prompt_lens", "wall_s",
                                                     "ttfb_ms")} for b in d["batches"]],
                      "launches": launches}), flush=True)
    cfg = quickstart.config("20m")
    nll = q["nll"]
    if not (len(nll) == QUICK_STEPS and all(map(math.isfinite, nll))
            and abs(nll[0] - math.log(cfg.vocab)) < 1.5):
        raise AssertionError(f"quickstart nll {nll}: not {QUICK_STEPS} finite, or the "
                             f"first far from ln {cfg.vocab}")
    shapes = tuple((len(b["prompt_lens"]), max(b["prompt_lens"])) for b in d["batches"])
    if shapes != DEMO_SERVE_SHAPES or not d["deterministic"]:
        raise AssertionError(f"serve demo batches {shapes}, not the {DEMO_SERVE_SHAPES} "
                             f"phase 3 checked, or not deterministic")
    # the demo serves each burst, then the first again (its determinism check)
    demo = ondemand_serving.CFG
    served = [b["tokens"] for b in d["batches"]] + [d["batches"][0]["tokens"]]
    decode_steps = sum(max(len(t) for t in toks) - 1 for toks in served)
    expected = {"flash_attention": cfg.n_layers * QUICK_STEPS + demo.n_layers * len(served),
                "flash_decode": demo.n_layers * decode_steps, "ssd_scan": 0,
                "ssd_scan_bwd": 0, "flash_attention_bwd": cfg.n_layers * QUICK_STEPS,
                "ssd_scan_final_state": 0}
    print(f"launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    return launches


# -------------------------------------------------------- 12. decision sweep
SWEEP_MIXES = ("W1", "W2", "W4", "W5")
#: the reference benchmark's bound on device time per replayed decision
#: (benchmarks/bench_device_sweep.py): it catches a replay that falls apart
#: into per-row or per-cell programs, not noise
SWEEP_BOUND_US = 40.0
SWEEP_THETA_MIN_CALLS = 126_000


def _sweep_cells(result):
    return [(f"{r.spec.mechanism}/{r.spec.workload.notice_mix}/s{r.spec.seed}",
             r.decision_trace) for r in result.runs]


def host_replay_s(D, cells, repeats: int = 3) -> float:
    """Best of `repeats` re-executions of every captured call through the
    port's numpy kernels: the host's cost of the same decisions, without
    the simulator around them."""
    import numpy as np
    fns = {k: getattr(D, k) for k in D.DecisionTrace.KERNELS}
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _label, trace in cells:
            for kernel, calls in trace.calls.items():
                fn = fns[kernel]
                if kernel == "backfill_shadow_filter":
                    # the trace holds the gathered needs/ests rows: replay
                    # them with identity candidates (the same work)
                    for (needs, ests, _cand, budget, now, ts), _out in calls:
                        fn(needs, ests, np.arange(len(needs)), budget, now, ts)
                else:
                    for inputs, _out in calls:
                        fn(*inputs)
        best = min(best, time.perf_counter() - t0)
    return best


def sweep_measure(torch, T, D, cells, dtype: str) -> dict:
    """One grid's replay on the card, measured beside its report: the
    CUDA-event time of one steady `_sweep_program` call (start to end
    event: the device's work and any idle while the host enqueues or reads
    an apportion round's condition), the CUDA operations one call launches
    and their summed device time (torch.profiler, the most of three
    windows, None if none saw a device event; the six costliest by name
    with their counts), the apportion rounds,
    the padded batches' bytes (inputs read once, outputs written once) and
    their byte bound, and the host's numpy replay of the same calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches_np, _index, _pads = T._build_batches(cells, dtype)
    batches = T.to_device(batches_np, "cuda")
    stats = {}
    outs = T._sweep_program(batches, stats)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    T._sweep_program(batches)
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end)
    # the profiler has lost device events in a window late in a long run
    # (fewer operations, or none, for the same program): keep the window of
    # three that recorded the most, and report none seen as not measured
    ops = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            T._sweep_program(batches)
            torch.cuda.synchronize()
        seen = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ops = seen if len(seen) > len(ops) else ops
    by_name = {}
    for e in ops:
        n, us = by_name.get(_kernel_name(e.name), (0, 0.0))
        by_name[_kernel_name(e.name)] = (n + 1, us + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    in_bytes = sum(a.nbytes for b in batches_np.values() for a in b.values())
    out_bytes = sum(t.numel() * t.element_size() for o in outs.values()
                    for t in (o if isinstance(o, tuple) else (o,)))
    return {"event_ms": event_ms, "launches": len(ops) or None,
            "busy_ms": sum(e.device_time_total for e in ops) / 1e3 if ops else None,
            "top_ops_ms": {k: [n, us / 1e3] for k, (n, us) in top},
            **stats, "bytes_in": in_bytes, "bytes_out": out_bytes,
            "bound_ms": 1e3 * (in_bytes + out_bytes) / HBM_BYTES_PER_S,
            "host_replay_ms": 1e3 * host_replay_s(D, cells)}


def decision_sweep(torch) -> list:
    """Phase 12: `Experiment(device="torch")` over every registered
    mechanism on the card, the bench's grid (13 mechanisms x W1/W2/W4/W5 x
    12 seeds, 40 jobs a cell, 32 calls captured a kernel) in float64 and
    float32, then a Theta-scale grid (600 jobs on 4392 nodes, W5, load
    1.15, seeds 0-3, 4096 captured) in float64.  Serial (processes=0):
    the earlier phases started CUDA and torch's thread pools, and forking
    such a process can deadlock.  Fails unless every float64 replay equals
    the numpy engine exactly, float32 meets the reference's invariants,
    the Theta grid drops nothing, each stays within SWEEP_BOUND_US a
    decision, and the bench grid's metrics equal the same grid run without
    the replay.  Returns one row per replay."""
    from repro_torch.core import Experiment, WorkloadConfig, registered_mechanisms
    from repro_torch.core import decision as D
    from repro_torch.core import decision_torch as T
    mechs = registered_mechanisms()
    bench = dict(mechanisms=mechs, seeds=range(12), processes=0,
                 workloads=[WorkloadConfig(n_jobs=40, notice_mix=m) for m in SWEEP_MIXES])
    t0 = time.perf_counter()
    res_a = Experiment(device="torch", device_capture=32, **bench).run()
    sweep_a_s = time.perf_counter() - t0
    plain = Experiment(**bench).run()
    if json.dumps([r.metrics.as_dict() for r in res_a]) != \
            json.dumps([r.metrics.as_dict() for r in plain]):
        raise AssertionError("decision sweep: the replay changed the bench grid's metrics")
    cells_a = _sweep_cells(res_a)
    rep_a32 = T.run_device_sweep(cells_a, dtype="float32")
    t0 = time.perf_counter()
    res_b = Experiment(mechanisms=mechs, seeds=range(4), processes=0, device="torch",
                       device_capture=4096,
                       workloads=[WorkloadConfig(n_jobs=600, notice_mix="W5",
                                                 target_load=1.15)]).run()
    sweep_b_s = time.perf_counter() - t0
    runs = (("bench", res_a.device_report, cells_a, sweep_a_s),
            ("bench", rep_a32, cells_a, None),
            ("theta", res_b.device_report, _sweep_cells(res_b), sweep_b_s))
    rows, bad = [], []
    for grid, rep, cells, sweep_s in runs:
        print(json.dumps({"grid": grid, **rep.summary()}), flush=True)
        row = {"grid": grid, "dtype": rep.dtype, "cells": rep.n_cells,
               "decisions": rep.n_calls, "pads": rep.pad_per_kernel,
               "n_dropped": rep.n_dropped, "parity_ok": rep.parity_ok,
               "device_ms": 1e3 * rep.device_s, "compile_s": rep.compile_s,
               "us_per_decision": rep.device_us_per_call, "sweep_s": sweep_s,
               **sweep_measure(torch, T, D, cells, rep.dtype)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not rep.parity_ok or rep.n_mismatches:
            bad.append(f"{grid} {rep.dtype}: {rep.n_mismatches} mismatches, "
                       f"first {rep.mismatches[:3]}")
        if rep.device_us_per_call > SWEEP_BOUND_US:
            bad.append(f"{grid} {rep.dtype}: {rep.device_us_per_call:.3f} us a decision "
                       f"> {SWEEP_BOUND_US}")
    theta = res_b.device_report
    if theta.n_dropped or theta.n_calls < SWEEP_THETA_MIN_CALLS:
        bad.append(f"theta: {theta.n_calls} decisions, {theta.n_dropped} dropped")
    if bad:
        raise AssertionError("decision sweep: " + "; ".join(bad))
    return rows


# ------------------------------------------------------------ 13. MoE parity
MOE_VARIANTS = ("base", "dropping", "shared_dense")


def moe_variant(cfg, name: str):
    """Reduced olmoe as it is, with capacity factor 0.5 ("dropping"), or
    with a shared expert and a dense first block ("shared_dense")."""
    import dataclasses
    if name == "dropping":
        return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    if name == "shared_dense":
        return cfg.with_(moe=dataclasses.replace(cfg.moe, n_shared=1, first_dense=1,
                                                 d_first_dense=256))
    return cfg


def moe_parity(torch):
    """Reduced olmoe in f32 and its variants, the same seeded params on the
    card and on the CPU: prefill logits within 1e-4, `ServeEngine` tokens
    equal, one train step's loss, grad norm and params within 1e-4."""
    import numpy as np
    from repro_torch.configs.reduced import reduced
    from repro_torch.models import init_params, prefill
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.training import (AdamW, make_train_state, make_train_step,
                                      synthetic_batch)
    from repro_torch.training.optimizer import tree_leaves

    rng = np.random.default_rng(0)
    opt = AdamW(lr=1e-3, eps=1e-3, warmup=1, total_steps=4)
    bad = []
    for name in MOE_VARIANTS:
        cfg = moe_variant(reduced("olmoe_1b_7b"), name)
        prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in (40, 57, 64, 33)]
        toks = torch.from_numpy(np.stack([np.pad(p, (64 - len(p), 0)) for p in prompts]))
        out = {}
        for dev in ("cpu", "cuda"):
            # a fresh copy each: the train step updates its params in place
            p = _to(init_params(cfg, seed=0, device="cpu"), dev)
            logits, _ = prefill(p, toks.to(dev), cfg)
            reqs = [Request(rid=i, prompt=pr, max_new_tokens=16) for i, pr in enumerate(prompts)]
            ServeEngine(cfg, p, max_seq=128, device=dev).serve_batch(reqs)
            state, m = make_train_step(cfg, opt)(make_train_state(p, opt),
                                                 synthetic_batch(cfg, 2, 64, device=dev))
            out[dev] = (logits.cpu(), [r.tokens_out for r in reqs],
                        {k: float(v) for k, v in m.items()}, state.params)
        (lc, tc, mc, pc), (lg, tg, mg, pg) = out["cpu"], out["cuda"]
        step_err = max(abs(mg[k] - mc[k]) / max(1.0, abs(mc[k])) for k in ("loss", "grad_norm"))
        for a, b in zip(tree_leaves(pc), tree_leaves(pg)):
            step_err = max(step_err, float(((b.cpu() - a).abs() / (1 + a.abs())).max()))
        row = {"variant": name, "prefill_logits_max_abs_err": float((lg - lc).abs().max()),
               "tokens_equal": tg == tc, "train_step_max_err": step_err,
               "loss": mg["loss"], "aux": mg["aux"], "first_tokens": tg[0][:8]}
        print(json.dumps({"moe_parity": row}), flush=True)
        if not (row["prefill_logits_max_abs_err"] <= 1e-4 and tg == tc and step_err <= 1e-4):
            bad.append(row)
    if bad:
        raise AssertionError(f"reduced olmoe differs cuda vs cpu: {bad}")


# ------------------------------------------------------------- 14. MoE serve
def profile_call(torch, fn):
    """Run fn once under torch.profiler (CUDA activity) from a synchronised
    device to the device done with it.  Returns (fn's result, {"wall_ms":
    the window on the host clock, "busy_ms": the device time of its CUDA
    operations, "busy_share", "launches", "top_ms": the eight costliest
    operations by name, [count, ms]})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in ops:
        n, us = by_name.get(_kernel_name(e.name), (0, 0.0))
        by_name[_kernel_name(e.name)] = (n + 1, us + e.device_time_total)
    busy_ms = sum(e.device_time_total for e in ops) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return out, {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
                 "launches": len(ops), "top_ms": {k: [n, us / 1e3] for k, (n, us) in top}}


def full_width_moe_serve(torch, fa, fd, ssd):
    """olmoe-1b-7b at full width and depth, bf16, random weights from seed
    0, through `launch.serve.main`: MOE_REQUESTS requests of MOE_PROMPT
    prompt tokens, MOE_NEW new, max_seq MOE_MAX_SEQ.  Counts are zeroed
    just before and read just after; the same requests are then served on
    an engine over the same seeded params (the tokens must be equal), and
    one prefill and one decode step of them run under torch.profiler.
    Returns the launches."""
    import gc

    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import draw_requests
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeEngine
    from repro_torch.training.optimizer import tree_leaves

    gc.collect()                 # what earlier phases left in reference cycles
    torch.cuda.empty_cache()
    print(f"allocated before the phase: {torch.cuda.memory_allocated()} B")
    argv = ["--arch", "olmoe-1b-7b", "--requests", str(MOE_REQUESTS),
            "--prompt-len", str(MOE_PROMPT[1]), "--min-prompt-len", str(MOE_PROMPT[0]),
            "--max-new", str(MOE_NEW), "--max-seq", str(MOE_MAX_SEQ)]
    counters = _zeroed_counters(fa, fd, ssd)
    stats = serve_main(argv)
    launches = counters()
    outputs = stats.pop("outputs")
    print(json.dumps({"moe_serve": stats, "launches": launches}), flush=True)
    cfg = get_config("olmoe_1b_7b")
    expected = {"flash_attention": cfg.n_layers, "flash_decode": cfg.n_layers * (MOE_NEW - 1),
                "ssd_scan": 0, "ssd_scan_bwd": 0, "flash_attention_bwd": 0,
                "ssd_scan_final_state": 0}
    print(f"launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    B, S = moe_serve_batch()
    if (len(stats["prompt_lens"]), max(stats["prompt_lens"])) != (B, S):
        raise AssertionError(f"batch of prompts {stats['prompt_lens']}: not the {B} x {S} "
                             "phase 3 checked")
    if any(len(o) != MOE_NEW or not all(0 <= t < cfg.vocab for t in o) for o in outputs):
        raise AssertionError(f"a request did not return {MOE_NEW} tokens in the vocab")
    if not (math.isfinite(stats["tok_per_s"]) and stats["ttft_s_max"] > 0):
        raise AssertionError(f"bad serve stats {stats}")
    # the same requests again, on an engine over the same seeded params
    params = init_params(cfg, seed=0, device="cuda")
    reqs = draw_requests(cfg.vocab, MOE_REQUESTS, *MOE_PROMPT, MOE_NEW)
    ServeEngine(cfg, params, max_seq=MOE_MAX_SEQ, device="cuda").serve_batch(reqs)
    same = [r.tokens_out for r in reqs] == outputs
    print(f"moe serve deterministic: {same}")
    if not same:
        raise AssertionError("a second serve of the same requests gave other tokens")
    # a decode step reads every weight but the token embedding's table (B
    # of its rows), since the capacity buffer runs every expert, and the
    # k/v cache up to its valid length (S + 32 rows on average over the
    # steps), and writes one k/v row
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    tok = params["embed"]["tok"]
    weight_bytes -= (tok.shape[0] - B) * tok.shape[1] * tok.element_size()
    row_bytes = 2 * cfg.n_layers * B * cfg.n_kv * cfg.d_head * 2
    step_bytes = weight_bytes + row_bytes * (S + MOE_NEW // 2 + 1)
    print(json.dumps({"moe_decode_step": {
        "median_ms": 1e3 * stats["decode_step_s_median"], "bytes": step_bytes,
        "weight_bytes": weight_bytes, "bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S}}))
    # where a prefill's and a decode step's time goes
    toks = torch.zeros((B, S), dtype=torch.long)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = torch.from_numpy(r.prompt)
    toks = toks.cuda()
    with torch.no_grad():
        prefill(params, toks, cfg)                         # warm
        (logits, cache), pre = profile_call(torch, lambda: prefill(params, toks, cfg))
        cache = {n: tuple(F.pad(c, (0, 0, 0, 0, 0, MOE_MAX_SEQ - S)) for c in kv)
                 for n, kv in cache.items()}
        nxt = logits.argmax(-1)[:, None]
        decode_step(params, cache, nxt, S, cfg)            # warm
        _, dec = profile_call(torch, lambda: decode_step(params, cache, nxt, S + 1, cfg))
    print(json.dumps({"moe_profile": {"prefill": pre, "decode_step": dec}}), flush=True)
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- 15. MoE train
def full_width_moe_train(torch, fa, fd, ssd):
    """olmoe-1b-7b at full width cut to MOE_TRAIN_LAYERS layers, bf16,
    remat "full", its 4 microbatches, MOE_TRAIN_STEPS steps of
    MOE_TRAIN_BATCH x MOE_TRAIN_SEQ tokens through `launch.train.main`.
    Counts zeroed just before, read just after.  Returns the launches."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main

    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", "olmoe-1b-7b", "--layers", str(MOE_TRAIN_LAYERS),
            "--steps", str(MOE_TRAIN_STEPS), "--batch", str(MOE_TRAIN_BATCH),
            "--seq", str(MOE_TRAIN_SEQ)]
    counters = _zeroed_counters(fa, fd, ssd)
    stats = train_main(argv)
    launches = counters()
    print(json.dumps({"moe_train": stats, "launches": launches}), flush=True)
    cfg = get_config("olmoe_1b_7b").with_(n_layers=MOE_TRAIN_LAYERS)
    expected = {k: MOE_TRAIN_STEPS * n
                for k, n in train_launches(cfg, cfg.train_microbatches).items()}
    expected.update(flash_decode=0, ssd_scan_final_state=0)
    print(f"launches {launches}, expected {expected} ({MOE_TRAIN_STEPS} steps)")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    losses = stats["losses"]
    if not (len(losses) == MOE_TRAIN_STEPS and all(math.isfinite(x) for x in losses)
            and abs(losses[0] - math.log(cfg.vocab)) < 1.5):
        raise AssertionError(f"losses {losses}: not {MOE_TRAIN_STEPS} finite, or the first "
                             f"far from ln {cfg.vocab} = {math.log(cfg.vocab):.2f}")
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    print(json.dumps({"step_seconds": stats["step_seconds"],
                      "tokens_per_s": stats["tokens_per_s"],
                      "steady_tokens_per_s": tokens / min(stats["step_seconds"][1:]),
                      "max_memory_allocated": stats["max_memory_allocated"]}))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- 16. campaigns
CAMPAIGNS = ("mini", "faulty")
CAMPAIGN_ARTIFACTS = ("rows.json", "report.json", "report.md")
#: calls captured per kernel per cell: the default 256 drops 908 of mini's calls
CAMPAIGN_CAPTURE = 4096


def _campaign_text(out_dir: Path) -> dict:
    """A campaign's three artifacts with provenance.grid_key masked: the
    key hashes repr(RunSpec), which holds the fixture's absolute path, so
    it names the package and the checkout."""
    key = json.loads((out_dir / "rows.json").read_text())["provenance"]["grid_key"]
    return {f: (out_dir / f).read_text().replace(key, "<grid_key>")
            for f in CAMPAIGN_ARTIFACTS}


def campaigns_on_card(torch, fa, fd, ssd) -> tuple:
    """`repro_torch.campaign.run_campaign` over examples/campaigns/mini.toml
    and faulty.toml (offline, serial), then each campaign's grid replayed
    through `core.decision_torch` on the card (`Experiment(device="torch",
    device_capture=CAMPAIGN_CAPTURE)`; f64 for both, and f32 for mini), then
    `repro_torch.launch.fault_sweep` at its defaults.  Counts zeroed just
    before, read just after: the campaigns launch no hand-written kernel.
    Fails unless every artifact equals results/campaigns/<name>/ apart from
    grid_key, each f64 replay is parity_ok with 0 mismatches and 0 dropped
    calls, f32 meets the reference's invariants, the replay leaves the
    metrics of the grid run without it unchanged, each replay takes at most
    SWEEP_BOUND_US of device time a decision, and the fault sweep writes
    results/faults/mtbf_sweep.json byte for byte.  Returns the rows, one
    per replay, and the launches."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.campaign import CampaignSpec, run_campaign
    from repro_torch.core import decision as D
    from repro_torch.core import decision_torch as T
    from repro_torch.launch import fault_sweep

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="campaigns-", dir=ROOT / "build"))
    counters = _zeroed_counters(fa, fd, ssd)
    rows, bad = [], []
    try:
        for name in CAMPAIGNS:
            spec = CampaignSpec.load(str(ROOT / "examples" / "campaigns" / f"{name}.toml"))
            t0 = time.perf_counter()
            run_campaign(spec, out_dir=str(tmp / name), offline=True, processes=0)
            campaign_s = time.perf_counter() - t0
            got = _campaign_text(tmp / name)
            want = _campaign_text(ROOT / "results" / "campaigns" / name)
            bad += [f"{name}/{f} differs from the checked-in one"
                    for f in CAMPAIGN_ARTIFACTS if got[f] != want[f]]
            exp, _regimes = spec.to_experiment(offline=True, processes=0)
            plain = exp.run()
            t0 = time.perf_counter()
            res = dataclasses.replace(exp, device="torch",
                                      device_capture=CAMPAIGN_CAPTURE).run()
            sweep_s = time.perf_counter() - t0
            if json.dumps([r.metrics.as_dict() for r in res]) != \
                    json.dumps([r.metrics.as_dict() for r in plain]):
                bad.append(f"{name}: the replay changed the grid's metrics")
            cells = [(f"{r.spec.mechanism}/{r.spec.workload.label}/s{r.spec.seed}",
                      r.decision_trace) for r in res.runs]
            reps = [res.device_report]
            if name == "mini":
                reps.append(T.run_device_sweep(cells, dtype="float32"))
            for rep in reps:
                print(json.dumps({"campaign": name, **rep.summary()}), flush=True)
                row = {"campaign": name, "dtype": rep.dtype, "cells": rep.n_cells,
                       "calls": rep.n_calls, "n_dropped": rep.n_dropped,
                       "parity_ok": rep.parity_ok, "n_mismatches": rep.n_mismatches,
                       "device_ms": 1e3 * rep.device_s, "compile_s": rep.compile_s,
                       "us_per_call": rep.device_us_per_call, "campaign_s": campaign_s,
                       "sweep_s": sweep_s if rep is res.device_report else None,
                       **sweep_measure(torch, T, D, cells, rep.dtype)}
                row["busy_share"] = None if row["busy_ms"] is None else \
                    row["busy_ms"] / row["event_ms"]
                print(json.dumps(row), flush=True)
                rows.append(row)
                if not rep.parity_ok or rep.n_mismatches or rep.n_dropped:
                    bad.append(f"{name} {rep.dtype}: parity_ok {rep.parity_ok}, "
                               f"{rep.n_mismatches} mismatches, {rep.n_dropped} dropped, "
                               f"first {rep.mismatches[:3]}")
                if rep.device_us_per_call > SWEEP_BOUND_US:
                    bad.append(f"{name} {rep.dtype}: {rep.device_us_per_call:.3f} us a "
                               f"call > {SWEEP_BOUND_US}")
        fault_sweep.main(["--out", str(tmp / "mtbf_sweep.json")])
        if (tmp / "mtbf_sweep.json").read_bytes() != \
                (ROOT / "results" / "faults" / "mtbf_sweep.json").read_bytes():
            bad.append("launch/fault_sweep.py: rows differ from results/faults/mtbf_sweep.json")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = counters()
    print(f"launches {launches}")
    if any(launches.values()):
        bad.append(f"the campaigns launched hand-written kernels: {launches}")
    if bad:
        raise AssertionError("campaigns: " + "; ".join(bad))
    return rows, launches


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

    phase("6. train and serve parity (reduced zamba2, f32 and bf16, cuda vs cpu)")
    train_parity(torch)
    hybrid_serve_parity(torch)

    phase("7. full-width zamba2-1.2b train (bf16, 38 layers, 3 steps)")
    train_launches_seen = full_width_train(torch, fa, ssd)

    phase(f"9. live seam (CUA&SPAA, 8 slots on one card: zamba2-1.2b cut to "
          f"{LIVE_TRAIN_LAYERS} layers x 3 jobs, llama3-8b serving)")
    live_launches = live_seam(torch, fa, fd, ssd)

    phase(f"10. full-width zamba2-1.2b serve (bf16, 38 layers, {HYBRID_BATCH} x "
          f"{HYBRID_PROMPT} prompt tokens, {HYBRID_NEW} new)")
    hybrid_launches = full_width_hybrid_serve(torch, fa, fd, ssd)

    phase("11. the launchers on the card (quickstart 20m, ondemand_serving; f32)")
    launcher_launches = launchers_on_card(torch, fa, fd, ssd)

    phase("12. decision sweep (Experiment(device='torch'): the bench grid in f64 and "
          "f32, a Theta-scale grid in f64)")
    sweep_rows = decision_sweep(torch)

    phase("13. MoE parity (reduced olmoe-1b-7b and two variants, f32, cuda vs cpu)")
    moe_parity(torch)

    phase(f"14. full-width olmoe-1b-7b serve (bf16, 16 layers, {MOE_REQUESTS} x "
          f"{MOE_PROMPT[0]}-{MOE_PROMPT[1]} prompt tokens, {MOE_NEW} new)")
    moe_serve_launches = full_width_moe_serve(torch, fa, fd, ssd)

    phase(f"15. olmoe-1b-7b train (full width, {MOE_TRAIN_LAYERS} layers, bf16, "
          f"{MOE_TRAIN_STEPS} steps of {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ})")
    moe_train_launches = full_width_moe_train(torch, fa, fd, ssd)

    phase("16. campaigns (mini and faulty through repro_torch.campaign; their grids "
          "replayed on the card in f64, mini also in f32; launch/fault_sweep)")
    campaign_rows, campaign_launches = campaigns_on_card(torch, fa, fd, ssd)

    phase("8. kernels")
    main_shape = {
        "flash_attention": ("bfloat16", dict(B=8, S=512, H=32, K=8, D=128)),
        "flash_decode": ("bfloat16", dict(B=8, S=1024, H=32, K=8, D=128, vlen=513)),
        "ssd_scan": ("bfloat16", dict(b=2, s=2048, h=64, p=64, n=64, chunk=256)),
        "ssd_scan_final_state": ("bfloat16", dict(b=HYBRID_BATCH, s=HYBRID_PROMPT, h=64,
                                                  p=64, n=64, chunk=256)),
        "ssd_scan_bwd": ("bfloat16", dict(b=2, s=2048, h=64, p=64, n=64, chunk=256)),
        "flash_attention_bwd": ("bfloat16", dict(B=2, S=2048, H=32, K=32, D=64)),
    }
    csrc = "src/repro_torch/kernels/csrc/"
    meta = {
        "flash_attention": (csrc + "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:85"),
        "flash_decode": (csrc + "flash_decode.cu", "src/repro/kernels/flash_decode.py:70"),
        "ssd_scan": (csrc + "ssd_scan_fwd.cu", "src/repro/kernels/ssd_scan.py:68"),
        "ssd_scan_final_state": (csrc + "ssd_scan_fwd.cu", "src/repro/kernels/ssd_scan.py:68"),
        "ssd_scan_bwd": (csrc + "ssd_scan_bwd.cu", "src/repro/kernels/ssd_scan.py:68"),
        "flash_attention_bwd": (csrc + "flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention.py:85"),
    }
    kernels = []
    for name, (dtn, c) in main_shape.items():
        row = rows[(name, dtn, tuple(sorted(c.items())))]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train": train_launches_seen.get(name, 0),
                   "live": live_launches.get(name, 0),
                   "hybrid_serve": hybrid_launches[name],
                   "launchers": launcher_launches[name],
                   "moe_serve": moe_serve_launches[name],
                   "moe_train": moe_train_launches[name],
                   "campaigns": campaign_launches[name]}
        kernels.append({"name": name, "route": "cuda", "source": meta[name][0],
                        "replaces": meta[name][1], "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        **{k: row[k] for k in ("max_abs_err", "ms", "host_ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms",
                                               "library")}})
    print(smi)
    print(json.dumps({"decision_sweep": sweep_rows}))
    print(json.dumps({"campaign_sweep": campaign_rows}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
