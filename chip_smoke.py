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
                tokens; the attention forward's Dv != D instances (MLA's
                prefill) at phase 21's 8 x 512 tokens of deepseek-v2-236b's
                128 heads (D 192, Dv 128) in bf16, and at phase 20's shapes
                (reduced f32 and bf16, D 48 / Dv 32; full-width bf16 at 2 x
                63); and, in f32,
                at the shapes phase 11 gives them (the serve demo's two
                prefills and decodes over their prompt-long caches,
                quickstart's attention forward and backward); in both
                dtypes at internvl2-1b's heads (H 14 over K 2, D 64: decode's
                8-slot variant with one slot idle) and seamless-m4t-medium's
                (H = K = 16, D 64): phase 23's and 24's prefills and decodes
                at their first and last valid lengths, a ragged prefill, and
                phase 25's attention forward and backward of a microbatch
                (1 x 2048 and 4 x 1024); the attention backward's Dv != D
                instances (MLA's training) in both dtypes at phase 27's 2 x
                512 tokens of deepseek-v2-236b's 128 heads of 192 / 128 and
                at phase 26's reduced 2 x 64 (4 heads of 48 / 32), timed
                beside SDPA's backward on its default backend.  Tolerance: 1e-4 in f32 and 2e-2
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
                Then the causal conv + SiLU, forward and backward, at the
                benchmark's zamba2-1.2b step (8 x 2048 tokens: 4096 and 128
                channels) and at xlstm-350m's 2048 channels, against the
                blocks' plain chain (`plain_ms`: what the kernel replaced).
                Then `expert_mm` (the dropless MoE's grouped GEMMs) forward
                and backward at phase 30's 131,072 rows, d_model 2048 <->
                d_expert 1024 over 64 experts (two empty), against the
                per-expert products in f32 and timed beside the per-expert
                loop.
                Then AdamW's kernels (clip norm and update) at olmoe-train's
                1.07e9-element expert leaf and over zamba2-1.2b's whole tree,
                3 steps from drawn non-zero moments against the plain version
                given the kernels' norm (bit for bit), each timed beside it
                and beside torch's fused AdamW.
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
                seeded params stepped 3 times on one batch on the card
                (kernels) and on the CPU (plain versions): the last loss and
                grad norm, and the params, within 1e-4;
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
  17. xLSTM parity -- reduced xlstm-350m in f32 (TF32 off) at an mLSTM
                chunk of 32, the same seeded params on the card and on the
                CPU: a 64-token prefill (two chunks: the carry and the final
                state) and 8 greedy decode steps (logits, the prefill's and
                the last step's cache leaves within 1e-4, tokens equal); one
                train step (phase 6's checks, f32 and bf16); then
                `ops.mlstm_scan` against `ref.naive_mlstm` at xlstm-350m's
                head shape (4 heads of 512, chunk 256, 2 x 1024 tokens, f32)
                within 1e-4 of the largest magnitude, with the scan's device
                time (`Clock`) beside its bound, max(FLOPs / 67e12, bytes /
                3.35e12).  No hand-written kernel may launch but the mLSTM's
                causal conv (the mLSTM scan and the sLSTM time loop are plain
                torch, as the reference's are jnp).
  18. xLSTM serve -- xlstm-350m at full width and depth (24 blocks: 4
                groups of one sLSTM and 5 mLSTM blocks, d_model 1024), bf16,
                random weights from seed 0, served through `prefill` and
                greedy `decode_step` (the engine refuses recurrent models,
                as the reference's does): 8 prompts of 512 tokens, 64 new.
                Prints TTFT, tok/s, the median decode step, peak memory and
                the step's byte bound (every parameter, from the leaves,
                plus every state read and written), and a `torch.profiler`
                split of one prefill and one decode step; a second serve
                must give the same tokens; no kernel launches but the conv,
                once an mLSTM block in the prefill (decode's one-row conv is
                plain torch).
  19. xLSTM train -- `repro_torch.launch.train.main` at xlstm-350m's full
                width and depth, bf16, remat "full", 4 microbatches, 2 steps
                of 8 x 1024 tokens (the sequence cut from 2048: a step there
                passed 90 s); finite losses, the first near ln(vocab),
                no kernel launches but the conv's, as `train_launches` says.  Prints the step times, tokens/s, peak
                memory, and one sLSTM block's forward and forward + backward
                timed alone at the microbatch's shape, with the share of a
                step they make up (each step runs each sLSTM block per
                microbatch forward, then again with its backward).
  20. MLA parity -- reduced deepseek-v2 (MoE with a dense first block,
                and MLA) in f32 (TF32 off), the same seeded params on the
                card and on the CPU: a 64-token prefill (logits and both
                latent leaves of both stacks) and 8 greedy decode steps
                (logits, the leaves after them) within 1e-4, tokens equal;
                then bf16 MLA on the card against the CPU from the same
                inputs, every block of the reduced model and one layer at
                deepseek-v2-236b's widths (prefill out, c_kv, k_rope, an
                absorbed decode step and the leaves after it), within 2e-2
                of the largest magnitude; the whole reduced model's bf16
                logits gap beside the tokens whose top-k routing flipped
                between card and CPU, held to 2e-2 when none did.  Every
                prefill launches flash_attention's Dv != D instance once a
                layer; no other kernel launches.
  21. MLA serve -- deepseek-v2-236b at full width (d_model 5120, 128 heads,
                kv_lora 512, q_lora 1536, 160 experts top-6 plus 2 shared,
                vocab 102,400) with its depth cut to 8 of 60 layers (the
                dense first block and 7 MoE blocks, 58.39 GB of bf16
                weights: 60 layers are about 470 GB), random weights from
                seed 0, built once; `ServeEngine` serves 8 prompts of
                384-512 tokens padded to 512 (at least kv_lora: a shorter
                batch fails in decode, as the reference's does), 64 new.
                Prints the widths and block sizes, TTFT, tok/s, the median
                decode step, peak memory, the step's byte bound (weights
                but the unused embedding rows, both latent leaves over 576
                rows, one row written), the cache bytes a token and layer
                against GQA's at these heads, and a `torch.profiler` split
                of one prefill and one decode step; a second serve must
                give the same tokens; the first serve launches
                flash_attention's Dv != D instance once a layer (its one
                prefill) and no other kernel.
  22. VLM and audio parity -- reduced internvl2-1b (8 patches) and
                seamless-m4t-medium (32 frames), the same seeded params on
                the card and on the CPU: in f32 a prefill with `extra`
                (logits and every cache leaf, the encoder memory included)
                and 8 greedy decode steps within 1e-4, tokens equal, and a
                train step (phase 6's checks); in bf16 the whole model's
                logits within 2e-2 of the largest magnitude.  The launches
                of flash_attention, its backward and flash_decode held to
                the path's count; the audio encoder and cross-attention
                launch nothing (plain torch, as the reference's are jnp).
  23. VLM serve -- internvl2-1b at full width and depth (24 layers, 14
                heads over 2, vocab 151,655), bf16, random weights from seed
                0, built once: `ServeEngine` on 8 text prompts of 387-510
                tokens padded to 510 (at least d_head 64: under it `_grow`,
                the reference's rule, leaves the cache prompt-long), 64
                new, max_seq 576; then the patch path, `prefill(extra=)`
                with 256 patch embeddings before 8 x 256 text tokens and 64
                greedy tokens over the cache grown to 576 rows.  Prints
                TTFT, tok/s, the median decode step against its byte bound,
                peak memory and a profiler split; asserts flash_attention
                24 and flash_decode 24 x 63 for each, a second run's tokens
                equal.
  24. audio serve -- seamless-m4t-medium at full width and depth (12
                encoder and 12 decoder layers, d_model 1024, 16 heads,
                vocab 256,206): `prefill(extra=frames)` with 8 x 1,024 frame
                embeddings and 8 x 256 text tokens, 64 greedy tokens with
                "self" grown to 320 rows and "enc" left as it is.  The same
                numbers as phase 23, the decode step's byte bound beside the
                operations of the cross k/v it recomputes, and the
                encoder's device time against the decoder's; asserts
                flash_attention 12 and flash_decode 12 x 63.
  25. VLM and audio train -- `launch.train.main` at both models' full
                width and depth, bf16, remat "full", 3 steps each: internvl
                8 x (256 patches + 1,792 text) in 8 microbatches, seamless 8
                x 1,024 tokens over 8 x 1,024 frames in 2; asserts the
                launches of `train_launches`, finite losses (the first near
                ln(vocab)) and grad norms, and that 3 steps on one batch
                lower its loss.  Prints step seconds, tokens/s and peak
                memory.
  26. MLA train parity -- reduced deepseek-v2 on the card against the CPU:
                one f32 train step (loss, grad norm, params within 1e-4),
                then bf16 layer by layer (every reduced block's MLA and one
                at deepseek-v2-236b's widths, forward and backward from the
                same inputs: out and every gradient within 2e-2 of the
                largest magnitude; whole-model bf16 also measures MoE
                routing flips, phase 20).  Asserts the Dv != D forward and
                backward launches, nothing else.
  27. MLA train -- `launch.train.main --arch deepseek-v2-236b --layers 2
                --microbatches 1`: full width, the dense first block and
                one MoE block (5.36e9 params), bf16, remat "full", 3 steps
                of 2 x 512.  Prints step seconds, tokens/s, peak memory, the
                losses and the (192, 128) instances' launches; asserts
                finite losses (the first near ln(vocab)) and that every
                layer's attention launched the Dv != D forward (twice, under
                remat) and backward, and nothing else launched.
  28. dry run -- `launch.dryrun` cells traced in this process on the `fake`
                process-group backend over fake tensors, no card:
                deepseek-v2-236b's train_4k at full width on 16 x 16, depth
                cut to 2, and the reduced olmoe-1b-7b train cell on 4 x 2.
                Prints per-device argument, output and peak bytes, FLOPs and
                collectives (counts from a trace); fails unless both trace.
  29. mesh train -- phase 7's cell through the multi-device path on one
                NCCL rank: `runtime/ranks.py` spawns a rank process on
                cuda:0, which runs `launch.train.main(... "--mesh", "1x1")`
                (the state and batches as DTensors, the kernels through
                `local_map`, AdamW's on each leaf's local shard).  Counts
                zeroed and read in the rank; asserts phase 7's launches, its
                losses within 2e-2 relative and no
                launch in this process; prints both paths' step seconds and
                peak memory, paired.
  30. OLMoE as published -- olmoe-1b-7b with QK-norm, dropless routing
                and ungated top-8 weights, 8 of 16 layers (the benchmark's
                olmoe-train step): one dropless MoE layer at 8 x 2048 tokens
                against the same layer through the per-expert loop (bf16,
                2e-2), then 3 train steps of 8 x 2048 tokens in one
                microbatch, asserting 48 forward and 24 backward grouped
                GEMM calls a step and finite losses; one more step traced
                as the benchmark traces, failing unless every name of
                perfbench/kernels/expert_mm.json ran.  Prints step seconds,
                tokens/s, peak memory and the grouped GEMMs' device time
                beside their bound.
  8. a JSON line {"decision_sweep": [...]} (phase 12's rows), a JSON line
     {"campaign_sweep": [...]} (phase 16's), then a JSON line {"kernels":
     [...]} with each kernel's launches in phases 5, 7, 9, 10, 11, 14, 15,
     16, 18, 19, 21, 23, 24, 25, 27, 29 and 30 and its numbers at its main
     path's shapes.
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
# phase 30: the benchmark's olmoe-train step (perfbench/configs/olmoe-1b-7b-0924.json):
# 8 of the published 16 layers, one microbatch of 8 x 2048 tokens
OLMOE_LAYERS, OLMOE_STEPS, OLMOE_BATCH, OLMOE_SEQ = 8, 3, 8, 2048
# Phase 17's: the reduced xLSTM at an mLSTM chunk of 32 (its 64-token
# prompt runs the inter-chunk carry), and the mLSTM scan at xlstm-350m's
# head shape (4 heads of 512, chunk 256) over 2 x 1024 tokens
XLSTM_PARITY_CHUNK = 32
XLSTM_SCAN = dict(b=2, s=1024, h=4, d=512, chunk=256)
# Phase 18's: full-width xlstm-350m serving 8 prompts of 512 tokens (two
# mLSTM chunks) and 64 new tokens; phase 19's: 2 steps of 8 x 1024, the
# sequence cut from 2048 because a step there passed 90 s (the sLSTM's
# time loop is host-paced: PERF.md section 5); layers and widths are whole
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_NEW = 8, 512, 64
XLSTM_TRAIN_STEPS, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ = 2, 8, 1024
# Phase 20's: reduced deepseek-v2 from a 64-token prompt (its kv_lora) and
# 8 greedy steps; one MLA layer at the full widths from 2 x 64 tokens in
# bf16.  Phase 21's: deepseek-v2-236b at full width cut to MLA_LAYERS
# layers (the dense first block and 7 MoE blocks, 58.39 GB of bf16
# weights; its 60 layers are about 470 GB), MLA_REQUESTS prompts of
# MLA_PROMPT tokens, the first MLA_PROMPT[1] long, so the batch is padded
# to MLA_PROMPT[1]: at least kv_lora (512), under which the engine's `_grow`,
# the reference's rule, leaves c_kv prompt-long and the first decode step
# raises, as the reference's does; MLA_NEW new tokens
MLA_PARITY_PROMPT, MLA_PARITY_NEW = 64, 9
MLA_LAYERS, MLA_REQUESTS, MLA_PROMPT, MLA_NEW = 8, 8, (384, 512), 64
MLA_MAX_SEQ = MLA_PROMPT[1] + MLA_NEW
# MLA prefill's attention heads: deepseek-v2-236b's 128 heads, D = d_nope +
# d_rope = 192 and Dv = d_v = 128, and its reduced sibling's 4 of 48 / 32
MLA_ATTN = dict(H=128, K=128, D=192, Dv=128)
MLA_ATTN_REDUCED = dict(H=4, K=4, D=48, Dv=32)
# Phase 26's: the reduced deepseek-v2 train step from 2 x 64 tokens, and
# its bf16 MLA layers' gradients at 2 x 64.  Phase 27's: deepseek-v2-236b
# trained at full width, cut to MLA_TRAIN_LAYERS layers (the dense first
# block and one MoE block, about 5.36e9 params: at 12 B a param for bf16
# params and grads and f32 AdamW moments, 64.3 GB), one microbatch (more
# would add f32 grad accumulators, 4 B a param, past the card's 80 GB),
# MLA_TRAIN_STEPS steps of MLA_TRAIN_BATCH x MLA_TRAIN_SEQ tokens
MLA_TRAIN_LAYERS = 2
MLA_TRAIN_STEPS = 3
MLA_TRAIN_BATCH, MLA_TRAIN_SEQ = 2, 512
# Phase 28's: deepseek-v2-236b's train_4k dry-run cell at full width on the
# 16 x 16 production mesh, depth cut to DRYRUN_LAYERS (its 60 layers trace
# in about 600 s of one CPU core), and the reduced olmoe-1b-7b train cell
# of tests/test_runtime.py (two microbatches, expert-parallel MoE) on 4 x 2
DRYRUN_LAYERS = 2
# Phase 22's: reduced internvl2-1b (8 patches) and seamless-m4t-medium (32
# frames) on the card against the CPU, 2 x VL_PARITY_TEXT text tokens and
# VL_PARITY_NEW greedy tokens.  Phase 23's: internvl2-1b at full width and
# depth (14 heads over 2, G = 7, D = 64), VLM_REQUESTS text prompts of
# VLM_PROMPT tokens padded to VLM_PROMPT[1] (at least d_head 64 and the 24
# layers: under them the engine's `_grow`, the reference's rule, leaves the
# cache prompt-long and each decode step overwrites the last prompt row),
# VLM_NEW new, max_seq VLM_MAX_SEQ; and the patch path, the config's 256
# patches before VLM_PATCH_TEXT text tokens (512 rows) in the same cache.
# Phase 24's: seamless-m4t-medium (16 = 16 heads, D = 64), AUDIO_BATCH x
# AUDIO_TEXT text tokens over its 1,024 frames, AUDIO_NEW new, "self" grown
# to AUDIO_CACHE rows.  Phase 25's: TRAIN_STEPS steps of TRAIN_BATCH x
# VLM_TRAIN_SEQ text tokens after the 256 patches (2,048 rows) and of
# TRAIN_BATCH x AUDIO_TRAIN_SEQ tokens over the frames, each in its config's
# microbatches (8: one 2,048-row sequence; 2: 4 x 1,024).
VL_PARITY_TEXT, VL_PARITY_NEW = 64, 9
VLM_HEADS = dict(H=14, K=2, D=64)
AUDIO_HEADS = dict(H=16, K=16, D=64)
VLM_PATCHES = 256
VLM_REQUESTS, VLM_PROMPT, VLM_NEW, VLM_MAX_SEQ = 8, (387, 510), 64, 576
VLM_PATCH_TEXT = 256
AUDIO_BATCH, AUDIO_TEXT, AUDIO_NEW = 8, 256, 64
AUDIO_CACHE = AUDIO_TEXT + AUDIO_NEW
TRAIN_STEPS, TRAIN_BATCH, VLM_TRAIN_SEQ, AUDIO_TRAIN_SEQ = 3, 8, 1792, 1024


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
              lib_backward=False, lib_label=None) -> dict:
    """The timing columns of a phase-3 row: kernel, plain version and the
    library call (an SDPA forward call, or None), beside the bound.  With
    lib_backward, `lib` is the backward of an SDPA graph already built on
    the default backend, timed as it is; with lib_label, `lib` is another
    library's call, timed as it is and named so."""
    ms, host_ms = clock(run, iters)
    plain_ms, plain_host_ms = clock(plain, iters)
    label = None
    if lib is None:
        lib_ms, lib_host_ms = None, None
    elif lib_label is not None:
        (lib_ms, lib_host_ms), label = clock(lib, iters), lib_label
    elif lib_backward:
        (lib_ms, lib_host_ms), label = clock(lib, iters), "sdpa:default backward"
    else:
        lib_ms, lib_host_ms, lib_name = sdpa_fastest(torch, clock, lib, iters)
        label = f"sdpa:{lib_name}"
    t_ops, t_bytes = flops / PEAK_FLOPS[dtn], nbytes / HBM_BYTES_PER_S
    return {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "plain_host_ms": plain_host_ms, "library_ms": lib_ms,
            "library_host_ms": lib_host_ms, "library": label,
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
    # MLA's prefill (Dv != D): phase 21's (8 x 512 at deepseek-v2-236b's 128
    # heads of 192 / 128), phase 20's reduced f32 prefill and its bf16 MLA
    # layers (2 x 63 tokens: the prefill before the decode step), reduced
    # and at full width
    cases += [("flash_attention", "bfloat16", dict(MLA_ATTN, B=MLA_REQUESTS, S=MLA_PROMPT[1])),
              ("flash_attention", "float32", dict(MLA_ATTN_REDUCED, B=2, S=MLA_PARITY_PROMPT)),
              ("flash_attention", "bfloat16",
               dict(MLA_ATTN_REDUCED, B=2, S=MLA_PARITY_PROMPT - 1)),
              ("flash_attention", "bfloat16", dict(MLA_ATTN, B=2, S=MLA_PARITY_PROMPT - 1))]
    # phase 23's (internvl2-1b, G = 7: flash_decode's 8-slot variant with one
    # slot idle): the patch path's prefill (8 x 512) and its decode over the
    # 576-row cache at the first and the last valid length, and a ragged
    # prefill; phase 24's (seamless-m4t-medium's decoder, G = 1): the
    # prefill (8 x 256) and its decode over the 320-row cache
    vp = VLM_PATCHES + VLM_PATCH_TEXT
    for dt in ("bfloat16", "float32"):
        cases += [("flash_attention", dt, dict(B=VLM_REQUESTS, S=vp, **VLM_HEADS)),
                  ("flash_attention", dt, dict(B=AUDIO_BATCH, S=AUDIO_TEXT, **AUDIO_HEADS)),
                  ("flash_attention", dt, dict(B=2, S=200, **VLM_HEADS))]
        cases += [("flash_decode", dt, dict(B=VLM_REQUESTS, S=VLM_MAX_SEQ, **VLM_HEADS, vlen=vl))
                  for vl in (vp + 1, vp + VLM_NEW - 1)]
        cases += [("flash_decode", dt, dict(B=AUDIO_BATCH, S=AUDIO_CACHE, **AUDIO_HEADS,
                                            vlen=vl))
                  for vl in (AUDIO_TEXT + 1, AUDIO_CACHE - 1)]
    # the engine's prefill in phase 23 (8 x 510) and its decode's first and
    # last valid length; phase 25's training forwards (a microbatch each)
    cases += [("flash_attention", "bfloat16", dict(B=VLM_REQUESTS, S=VLM_PROMPT[1], **VLM_HEADS))]
    cases += [("flash_decode", "bfloat16", dict(B=VLM_REQUESTS, S=VLM_MAX_SEQ, **VLM_HEADS,
                                                vlen=vl))
              for vl in (VLM_PROMPT[1] + 1, VLM_PROMPT[1] + VLM_NEW - 1)]
    cases += [("flash_attention", "bfloat16",
               dict(B=1, S=VLM_PATCHES + VLM_TRAIN_SEQ, **VLM_HEADS)),
              ("flash_attention", "bfloat16", dict(B=4, S=AUDIO_TRAIN_SEQ, **AUDIO_HEADS))]

    for kname, dtn, c in cases:
        dt = getattr(torch, dtn)
        B, S, H, K, D = c["B"], c["S"], c["H"], c["K"], c["D"]
        Dv = c.get("Dv", D)
        scale = 1.0 / math.sqrt(D)
        vlen = c.get("vlen")
        sq = 1 if kname == "flash_decode" else S
        q, k, v = rnd((B, sq, H, D), dt), rnd((B, S, K, D), dt), rnd((B, S, K, Dv), dt)
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
        flops, nbytes = attention_cost(B, sq, S, H, K, D, Dv, q.element_size(),
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
    fa.flash_attention.mla_launches = fa._launch_bwd.mla_launches = 0
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
    _no_mla_launches(fa, launches, "serve")
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
         lib_backward=False, lib_label=None):
    """Check the relative errors, time the three calls, print and return."""
    err_abs = max(e[0] for e in errs.values())
    err_rel = max(e[1] for e in errs.values())
    if not err_rel <= TOL[dtn]:
        raise AssertionError(f"{kname} {dtn} {c}: relative error {errs} > {TOL[dtn]}")
    row = {"kernel": kname, "dtype": dtn, **c, "max_abs_err": err_abs,
           "max_rel_err": err_rel, "rel_errs": {k: e[1] for k, e in errs.items()},
           **timed_row(torch, clock, run, plain, lib, iters, flops, nbytes, dtn,
                       lib_backward, lib_label)}
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
    # phase 25's: internvl2-1b's microbatch (one 2,048-row sequence, G = 7)
    # in both dtypes; seamless-m4t-medium's decoder microbatch (4 x 1,024)
    # (from a generator of their own, so the draws before them stay)
    vlm_fa = [dict(B=1, S=VLM_PATCHES + VLM_TRAIN_SEQ, **VLM_HEADS)]
    audio_fa = [dict(B=4, S=AUDIO_TRAIN_SEQ, **AUDIO_HEADS)]
    g_vl = torch.Generator(device="cuda")
    g_vl.manual_seed(4)
    # MLA's training (Dv != D), in both dtypes: phase 27's microbatch at
    # deepseek-v2-236b's 128 heads of 192 / 128, and phase 26's reduced
    # train step (4 heads of 48 / 32); from a generator of their own
    mla_fa = [dict(MLA_ATTN, B=MLA_TRAIN_BATCH, S=MLA_TRAIN_SEQ),
              dict(MLA_ATTN_REDUCED, B=2, S=64)]
    g_mla = torch.Generator(device="cuda")
    g_mla.manual_seed(5)
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
        for c in fa_shapes + (live_fa + moe_fa if bf16 else quick_fa) + vlm_fa + \
                (audio_fa if bf16 else []) + mla_fa:
            B, S, H, K, D = (c[k] for k in ("B", "S", "H", "K", "D"))
            Dv = c.get("Dv", D)
            scale = 1.0 / math.sqrt(D)
            gen = g_mla if c in mla_fa else g_vl if c in vlm_fa + audio_fa else g
            q, k = (rnd((B, S, n, D), dt, gen=gen) for n in (H, K))
            v = rnd((B, S, K, Dv), dt, gen=gen)
            do = rnd((B, S, H, Dv), dt, gen=gen)
            o, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=scale)
            got = fa._launch_bwd(q, k, v, o, lse, do, causal=True, scale=scale)
            refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                                causal=True, scale=scale)
            torch.cuda.synchronize()
            errs = {n_: (float((a.float() - r).abs().max()), _rel_err(a, r))
                    for n_, a, r in zip(("dq", "dk", "dv"), got, refs)}
            flops, nbytes = attention_cost(B, S, S, H, K, D, Dv, q.element_size())
            # S, dK and dQ over D, dP and dV over Dv, on the causal pairs
            flops = flops // (D + Dv) * (3 * D + 2 * Dv)
            nbytes += q.element_size() * (B * S * H * (D + Dv) + B * S * K * (D + Dv)) \
                + 4 * B * H * S              # do read, dq written; dk, dv; lse
            live = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o_plain = fa.flash_attention_plain(*live, causal=True, scale=scale)
            o_lib = F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in live), is_causal=True, scale=scale,
                enable_gqa=True).transpose(1, 2)
            lib = lambda: torch.autograd.grad(o_lib, live, do, retain_graph=True)  # noqa: E731
            rows[("flash_attention_bwd", dtn, tuple(sorted(c.items())))] = _row(
                torch, clock, "flash_attention_bwd", dtn, c, errs, flops, nbytes,
                lambda: fa._launch_bwd(q, k, v, o, lse, do, causal=True, scale=scale),
                lambda: torch.autograd.grad(o_plain, live, do, retain_graph=True),
                lib, 10, lib_backward=True)
            del o_plain, o_lib, live
    return rows


# ----------------------------------------- 3c. the causal conv + SiLU
# (B, S, C) of the conv at the benchmark's zamba2-1.2b step (8 x 2048 tokens,
# one microbatch): a Mamba-2 layer's conv_x (expand x d_model, 4096
# channels) and conv_bc (2 d_state, 128); and xlstm-350m's mLSTM conv (2048
# channels); 4 taps each
CONV_SHAPES = [dict(B=8, S=2048, C=4096), dict(B=8, S=2048, C=128),
               dict(B=8, S=2048, C=2048)]


def conv_kernel_cases(torch, clock):
    """The causal conv + SiLU, forward and backward, against its plain
    version (the blocks' shifted multiplies and `F.silu`, the chain they
    ran before the kernel, so `plain_ms` is what the kernel replaced) at
    CONV_SHAPES in both dtypes, errors relative to the largest magnitude of
    the plain version computed in f32; returns the rows keyed like
    kernel_cases'."""
    from perfbench.kernels._conv import cost
    from repro_torch.kernels import causal_conv as cc
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    rows = {}

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)

    def err(a, r):
        return float((a.float() - r).abs().max()), _rel_err(a, r)

    for dtn in ("bfloat16", "float32"):
        dt = getattr(torch, dtn)
        for c in CONV_SHAPES:
            B, S, C = c["B"], c["S"], c["C"]
            x, w, b, dy = rnd((B, S, C), dt), rnd((4, C), dt, 0.5), rnd((C,), dt), \
                rnd((B, S, C), dt)
            live = [t.float().requires_grad_(True) for t in (x, w, b)]
            ref = cc.causal_conv_silu_plain(*live)
            refs = torch.autograd.grad(ref, live, dy.float())
            y = cc.causal_conv_silu(x, w, b)
            got = cc._launch_bwd(x, w, b, dy)
            torch.cuda.synchronize()
            key = tuple(sorted(c.items()))
            flops, nbytes = cost(B, S, C, 4, x.element_size())
            rows[("causal_conv", dtn, key)] = _row(
                torch, clock, "causal_conv", dtn, c, {"y": err(y, ref.detach())}, flops,
                nbytes, lambda: cc.causal_conv_silu(x, w, b),
                lambda: cc.causal_conv_silu_plain(x, w, b), None, 10)
            errs = {k: err(a, r) for k, a, r in zip(("dx", "dw", "db"), got, refs)}
            plain = [t.detach().requires_grad_(True) for t in (x, w, b)]
            y_plain = cc.causal_conv_silu_plain(*plain)
            flops, nbytes = cost(B, S, C, 4, x.element_size(), backward=True)
            rows[("causal_conv_bwd", dtn, key)] = _row(
                torch, clock, "causal_conv_bwd", dtn, c, errs, flops, nbytes,
                lambda: cc._launch_bwd(x, w, b, dy),
                lambda: torch.autograd.grad(y_plain, plain, dy, retain_graph=True), None, 10)
            del live, ref, refs, y, got, plain, y_plain
    return rows


# ------------------------------------------- 3d. the grouped expert GEMMs
# (R, K, N, E) of the dropless MoE's grouped products at phase 30's step (8 x
# 2048 tokens, top-8: 131,072 rows over olmoe's 64 experts): w1 and w3
# (d_model 2048 -> d_expert 1024) and w2 (1024 -> 2048); EXPERT_MM_EMPTY
# are left without rows
EXPERT_MM_SHAPES = [dict(R=131072, K=2048, N=1024, E=64), dict(R=131072, K=1024, N=2048, E=64)]
EXPERT_MM_EMPTY = (3, 62)


def expert_mm_kernel_cases(torch, clock):
    """`expert_mm`, forward and backward (dX and dW), at EXPERT_MM_SHAPES in
    bf16 (the one dtype the grouped GEMM takes), the rows drawn uniformly
    over the experts but EXPERT_MM_EMPTY: errors relative to the largest
    magnitude of the per-expert products in f32 from the same bf16 inputs
    (an empty expert's dW must be exactly 0), timed against the per-expert
    loop `expert_mm_plain` (`plain_ms`: a matmul an expert after a host read
    of the offsets, what the dropless dispatch would run without the
    grouped GEMM; its backward is autograd through the loop).  Returns the
    rows keyed like kernel_cases'."""
    from perfbench.kernels.expert_mm import cost
    from repro_torch.kernels import expert_mm as emm
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    bf = torch.bfloat16
    rows = {}

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    def err(a, r):
        return float((a.float() - r).abs().max()), _rel_err(a, r)

    for c in EXPERT_MM_SHAPES:
        R, K, N, E = c["R"], c["K"], c["N"], c["E"]
        share = torch.ones(E, device="cuda")
        share[list(EXPERT_MM_EMPTY)] = 0.0
        eid = torch.multinomial(share, R, replacement=True, generator=g).sort().values
        offsets = torch.bincount(eid, minlength=E).cumsum(0).to(torch.int32)
        x, w, dy = rnd((R, K)), rnd((E, K, N), K ** -0.5), rnd((R, N))
        ref_y = torch.empty((R, N), device="cuda")
        ref_dx = torch.empty((R, K), device="cuda")
        ref_dw = torch.zeros((E, K, N), device="cuda")
        ends = offsets.tolist()
        for e, (s0, s1) in enumerate(zip([0, *ends[:-1]], ends)):
            xe, we, ge = x[s0:s1].float(), w[e].float(), dy[s0:s1].float()
            ref_y[s0:s1], ref_dx[s0:s1], ref_dw[e] = xe @ we, ge @ we.T, xe.T @ ge
        y = emm.expert_mm(x, w, offsets)
        dx, dw = emm._launch_bwd(x, w, offsets, dy)
        torch.cuda.synchronize()
        if any(float(dw[e].abs().max()) != 0.0 for e in EXPERT_MM_EMPTY):
            raise AssertionError(f"expert_mm {c}: an empty expert's dW is not 0")
        key = tuple(sorted(c.items()))
        flops, nbytes = cost(R, K, N, E, 2)
        rows[("expert_mm", "bfloat16", key)] = _row(
            torch, clock, "expert_mm", "bfloat16", c, {"y": err(y, ref_y)}, flops, nbytes,
            lambda: emm.expert_mm(x, w, offsets), lambda: emm.expert_mm_plain(x, w, offsets),
            None, 10)
        plain = [t.detach().requires_grad_(True) for t in (x, w)]
        y_plain = emm.expert_mm_plain(*plain, offsets)
        flops, nbytes = cost(R, K, N, E, 2, backward=True)
        rows[("expert_mm_bwd", "bfloat16", key)] = _row(
            torch, clock, "expert_mm_bwd", "bfloat16", c,
            {"dx": err(dx, ref_dx), "dw": err(dw, ref_dw)}, flops, nbytes,
            lambda: emm._launch_bwd(x, w, offsets, dy),
            lambda: torch.autograd.grad(y_plain, plain, dy, retain_graph=True), None, 10)
        del x, w, dy, ref_y, ref_dx, ref_dw, y, dx, dw, plain, y_plain
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- 3e. AdamW
# olmoe-train's largest leaf (a stacked expert weight: 8 layers x 64 experts x
# d_model 2048 x d_expert 1024, bf16) and zamba2-1.2b's whole tree (25 leaves,
# bf16 and f32); the gradients drawn at 1e-4, so the clip scales them
ADAMW_CASES = [dict(leaf="olmoe_expert_w1", n=8 * 64 * 2048 * 1024),
               dict(tree="zamba2-1.2b", n=1_170_396_032)]
# steps from one drawn state: the first at this count (bias corrections
# 1 - b^t well away from 1 and from 0), lr 3e-4 past a one-step warmup, so a
# step moves a 0.02 bf16 weight by a few ulps
ADAMW_STEP0, ADAMW_STEPS = 10, 3


def adamw_kernel_cases(torch, clock):
    """AdamW's kernels (the clip norm's sum of squares, the sum of its
    partials, one update a leaf) against the plain version on the card, at
    ADAMW_CASES: ADAMW_STEPS steps from one drawn state (non-zero m and v,
    fresh gradients each step), the plain version clipped by the kernels'
    norm, which must be the f64 norm's within 1e-6.  After every step p, m
    and v must equal the plain version's bit for bit, and the last step must
    have moved most elements of p.  The row's errors are the last step's
    change of p, and m and v, each relative to the plain version's largest
    magnitude.  Then timed, a step each: `plain_ms` the ~20 torch passes a
    leaf the kernels replaced; `library_ms` torch's own fused AdamW as a
    yardstick (`torch._foreach_norm` for the clip, `torch._fused_adamw_`
    taking the clip as its grad scale), on f32 copies of p and g, since it
    keeps its four lists in one dtype: 32 bytes an element and a write of
    g, against the kernels' 24; `bound_ms` the compulsory bytes of
    perfbench/kernels/adamw.py over the HBM bandwidth.  Returns the rows
    keyed like kernel_cases'."""
    import gc

    from perfbench.kernels.adamw import cost
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw
    from repro_torch.models import init_params
    from repro_torch.training import AdamW
    from repro_torch.training.optimizer import tree_leaves

    g = torch.Generator(device="cuda")
    g.manual_seed(8)

    def draw(shape, scale):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def flat(ts):
        return torch.cat([t.flatten().float() for t in ts])

    opt = AdamW(warmup=1)
    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, weight_decay=opt.weight_decay,
                 clip_norm=opt.clip_norm)
    rows = {}
    for c in ADAMW_CASES:
        if "leaf" in c:
            params = [draw(c["n"], 0.02).to(torch.bfloat16)]
        else:
            params = list(tree_leaves(init_params(get_config("zamba2_1p2b"), seed=0,
                                                  device="cuda")))
        assert sum(p.numel() for p in params) == c["n"], c
        grads = [torch.empty_like(p) for p in params]
        quads = [(gr, draw(p.shape, 1e-5), draw(p.shape, 1e-5).square_(), p)
                 for gr, p in zip(grads, params)]
        plain = [(gr, m.clone(), v.clone(), p.clone()) for gr, m, v, p in quads]
        for k in range(ADAMW_STEPS):
            for gr in grads:
                gr.copy_(draw(gr.shape, 1e-4))
            step = torch.full((), ADAMW_STEP0 + k, dtype=torch.int32, device="cuda")
            lr, stepf = opt.lr_at(step), step.to(torch.float32)
            c1, c2 = 1 - opt.b1 ** stepf, 1 - opt.b2 ** stepf
            p_old = flat(params)
            gnorm = adamw.adamw_update(quads, lr, c1, c2, **hyper)
            adamw.adamw_update_plain(plain, lr, c1, c2, gnorm=gnorm, **hyper)
            want = math.sqrt(sum(float(torch.linalg.vector_norm(gr.double()) ** 2)
                                 for gr in grads))
            if not abs(float(gnorm) - want) <= 1e-6 * want:
                raise AssertionError(f"adamw {c}: norm {float(gnorm)} vs f64 {want}")
            for i, name in ((1, "m"), (2, "v"), (3, "p")):
                if not all(torch.equal(a[i], b[i]) for a, b in zip(quads, plain)):
                    raise AssertionError(f"adamw {c}: step {k + 1}: {name} differs from "
                                         f"the plain version's")
        dp = flat(params) - p_old
        dp_plain = flat(q[3] for q in plain) - p_old
        moved = float((dp != 0).float().mean())
        if not moved > 0.5:
            raise AssertionError(f"adamw {c}: the last step moved {moved:.3f} of p")
        errs = {"dp": (float((dp - dp_plain).abs().max()), _rel_err(dp, dp_plain))}
        del dp, dp_plain, p_old
        for i, name in ((1, "m"), (2, "v")):
            got, want_t = flat(q[i] for q in quads), flat(q[i] for q in plain)
            errs[name] = (float((got - want_t).abs().max()), _rel_err(got, want_t))
            del got, want_t
        print(json.dumps({"adamw_steps": {**c, "steps": ADAMW_STEPS, "p_moved": moved,
                                          "norm": float(gnorm)}}), flush=True)
        flops, nbytes = 0, 0
        for p in params:
            f, b = cost(p.numel(), p.element_size())
            flops, nbytes = flops + f, nbytes + b
        torch.cuda.empty_cache()
        lib_p, lib_g = [p.float() for p in params], [gr.float() for gr in grads]
        lib_m, lib_v = [q[1].clone() for q in quads], [q[2].clone() for q in quads]
        lib_steps = [stepf.clone() for _ in params]

        def library():
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(lib_g)))
            unscale = torch.clamp((norm + 1e-9) / opt.clip_norm, min=1.0)
            torch._fused_adamw_(lib_p, lib_g, lib_m, lib_v, [], lib_steps, lr=lr,
                                beta1=opt.b1, beta2=opt.b2, weight_decay=opt.weight_decay,
                                eps=opt.eps, amsgrad=False, maximize=False,
                                grad_scale=unscale, found_inf=None)
        key = tuple(sorted(c.items()))
        rows[("adamw", "bfloat16", key)] = _row(
            torch, clock, "adamw", "bfloat16", c, errs, flops, nbytes,
            lambda: adamw.adamw_update(quads, lr, c1, c2, **hyper),
            lambda: adamw.adamw_update_plain(plain, lr, c1, c2, **hyper), library, 5,
            lib_label="torch._fused_adamw_ (f32 p, g)")
        del params, grads, quads, plain, lib_p, lib_g, lib_m, lib_v
        gc.collect()
        torch.cuda.empty_cache()
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

    Each Mamba-2 forward launches the causal conv twice (x, and B and C),
    each Mamba-2 backward its backward twice.

    xLSTM, per microbatch: groups of an sLSTM block and its mLSTM blocks,
    each group checkpointed and each mLSTM block in it, so under
    remat="full" an mLSTM block runs its conv forward three times, but the
    group's last twice (the group's recompute stops before it: the
    checkpoint saved nothing inside it), and its backward once; no other
    hand-written kernel.

    Dense layout (dense and MoE blocks, `pre_layers` included), per
    microbatch: each of the n_layers blocks runs attention forward once,
    twice under remat="full" (each block is checkpointed), and its backward
    once; no SSD kernel, no conv.  With `moe.dropless`, each MoE block (all
    but the `first_dense`) runs three grouped expert GEMMs a forward and
    three backward calls.  No other layout runs them.

    Once a step, whatever the microbatches: AdamW's update launches once a
    leaf of the params (`adamw`) over all their elements (`adamw_elems`),
    `adamw_launches`."""
    full = cfg.remat == "full"
    if cfg.family == "ssm":
        from repro_torch.models.model import _xlstm_groups
        groups, n_m = _xlstm_groups(cfg)
        per_mb = {"ssd_scan": 0, "ssd_scan_bwd": 0, "flash_attention": 0,
                  "flash_attention_bwd": 0,
                  "causal_conv": groups * (3 * n_m - 1 if full else n_m),
                  "causal_conv_bwd": groups * n_m, "expert_mm": 0, "expert_mm_bwd": 0}
    elif cfg.family != "hybrid":
        n_moe = cfg.n_layers - cfg.moe.first_dense if cfg.moe and cfg.moe.dropless else 0
        per_mb = {"ssd_scan": 0, "ssd_scan_bwd": 0,
                  "flash_attention": cfg.n_layers * (2 if full else 1),
                  "flash_attention_bwd": cfg.n_layers, "causal_conv": 0, "causal_conv_bwd": 0,
                  "expert_mm": 3 * n_moe * (2 if full else 1), "expert_mm_bwd": 3 * n_moe}
    else:
        k = cfg.attn_every
        groups, tail = cfg.n_layers // k, cfg.n_layers % k
        per_mb = {"ssd_scan": groups * k * (3 if full else 1) + tail * (2 if full else 1),
                  "ssd_scan_bwd": cfg.n_layers,
                  "flash_attention": groups * (2 if full else 1),
                  "flash_attention_bwd": groups}
        per_mb.update(causal_conv=2 * per_mb["ssd_scan"], causal_conv_bwd=2 * cfg.n_layers,
                      expert_mm=0, expert_mm_bwd=0)
    return {**{name: microbatches * n for name, n in per_mb.items()}, **adamw_launches(cfg)}


def adamw_launches(cfg, steps: int = 1) -> dict:
    """AdamW's counts over `steps` train steps on the card: one update launch
    a non-empty leaf of the params a step (`adamw`), and their elements
    (`adamw_elems`); the params' shapes from the meta device."""
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import tree_leaves
    sizes = [t.numel() for t in tree_leaves(init_params(cfg, device="meta")) if t.numel()]
    return {"adamw": steps * len(sizes), "adamw_elems": steps * sum(sizes)}


# ------------------------------------------------------------ 6. train parity
def train_parity(torch, cfg, tag: str = "train_parity", bf16: bool = True, steps: int = 1):
    """`steps` train steps of the reduced cfg (f32 params and compute) on one
    batch from the same seeded params on the card and on the CPU: the last
    step's loss and grad norm, and the params, within 1e-4 (past the first
    step AdamW starts from non-zero moments, so every term of its update
    shows); then (with bf16) one step in bf16, loss and grad norm within
    2e-2 relative.  Printed under `tag`."""
    from repro_torch.models import init_params
    from repro_torch.training import (AdamW, make_train_state, make_train_step,
                                      synthetic_batch)
    from repro_torch.training.optimizer import tree_leaves

    # eps 1e-3: Adam's first update g / (|g| + eps) would otherwise divide
    # the f32 noise of near-zero gradient elements by their own size
    opt = AdamW(lr=1e-3, eps=1e-3, warmup=1, total_steps=4)
    out = {}
    for dev in ("cpu", "cuda"):
        state = make_train_state(_to(init_params(cfg, seed=0, device="cpu"), dev), opt)
        batch, step = synthetic_batch(cfg, 2, 64, device=dev), make_train_step(cfg, opt)
        for _ in range(steps):
            state, m = step(state, batch)
        out[dev] = (state.params, {k: float(v) for k, v in m.items()})
    (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
    worst = 0.0
    for k in ("loss", "grad_norm"):
        worst = max(worst, abs(mg[k] - mc[k]) / max(1.0, abs(mc[k])))
    for a, b in zip(tree_leaves(pc), tree_leaves(pg)):
        worst = max(worst, float(((b.cpu() - a).abs() / (1 + a.abs())).max()))
    print(json.dumps({tag: {"cpu": mc, "cuda": mg, "max_err": worst}}))
    if not worst <= 1e-4:
        raise AssertionError(f"reduced {cfg.name} train step differs cuda vs cpu by "
                             f"{worst} > 1e-4")
    if not bf16:
        return

    # bf16: the tensor-core attention kernels round P and dS to bf16 before
    # their products (the plain versions keep f32), and the bf16 step rounds
    # every activation (cuBLAS and the CPU round in another order); 2e-2
    # relative on the loss and the grad norm
    cfg = cfg.with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    out = {}
    for dev in ("cpu", "cuda"):
        params = _to(init_params(cfg, seed=0, device="cpu"), dev)
        _, m = make_train_step(cfg, opt)(make_train_state(params, opt),
                                         synthetic_batch(cfg, 2, 64, device=dev))
        out[dev] = {k: float(v) for k, v in m.items()}
    mc, mg = out["cpu"], out["cuda"]
    worst = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("loss", "grad_norm"))
    print(json.dumps({tag + "_bf16": {"cpu": mc, "cuda": mg, "max_rel_err": worst}}))
    if not worst <= 2e-2:
        raise AssertionError(f"bf16 reduced {cfg.name} train step differs cuda vs cpu by "
                             f"{worst} > 2e-2 relative")


def _greedy(torch, params, cfg, toks, n_new: int, cache_rows: int = 0, extra=None):
    """Serving through `prefill` (with `extra`: a VLM's patch or an audio
    model's frame embeddings), then greedy `decode_step`, as the reference
    serves the models its engine refuses: prefill the prompts, grow the
    self-attention caches (a hybrid model's `attn`; dense, MoE, MLA and VLM
    `pre_layers` and `layers`; audio `self`) from their own rows to
    `cache_rows` rows, leaving every other leaf (audio `enc`) as it is,
    decode n_new - 1 tokens from the prefill's last row on, each to the
    host as the engine takes it.  Returns (the prefill's logits and a copy
    of its cache leaves, each decode step's logits, the tokens (B, n_new),
    TTFT s, each decode step's s, the cache after the last step)."""
    from repro_torch.models import decode_step, prefill
    S = toks.shape[1] + (extra.shape[1] if cfg.family == "vlm" and extra is not None else 0)
    sync = torch.cuda.synchronize if toks.is_cuda else (lambda: None)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(params, toks, cfg, extra=extra)
        pre = (logits, [t.clone() for leaves in cache.values()
                        for t in (leaves if isinstance(leaves, tuple) else (leaves,))])
        for name in ("attn", "pre_layers", "layers", "self"):
            if name in cache:
                grown = []
                for c in cache[name]:
                    full = c.new_zeros((*c.shape[:2], cache_rows, *c.shape[3:]))
                    full[:, :, :c.shape[2]] = c
                    grown.append(full)
                cache[name] = tuple(grown)
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
    return pre, steps, [list(t) for t in zip(*out)], ttft, step_s, cache


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
    (cl, cc), csteps, ctoks, _, _, _ = out["cpu"]
    (gl, gc), gsteps, gtoks, _, _, _ = out["cuda"]
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
# Phase 7's cell, which phase 29 trains again on one NCCL rank under a mesh
TRAIN_ARGV = ["--arch", "zamba2-1.2b", "--steps", "3", "--batch", "8", "--seq", "2048"]


def full_width_train(torch, fa, ssd):
    """Returns (each kernel's launches, `launch.train.main`'s stats)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main

    counters = _zeroed_counters(fa, None, ssd)
    stats = train_main(TRAIN_ARGV)
    launches = counters()
    print(json.dumps({"train": stats, "launches": launches}))
    cfg = get_config("zamba2_1p2b")
    expected = {k: 3 * n for k, n in train_launches(cfg, cfg.train_microbatches).items()}
    expected.update(flash_decode=0, ssd_scan_final_state=0, flash_attention_mla=0,
                    flash_attention_bwd_mla=0)
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
    return launches, stats


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
    jobs = {}
    counters = _zeroed_counters(fa, fd, ssd)
    stats = cluster_main(argv, serve_params=serve_params,
                         on_job=lambda job: jobs.__setitem__(job.jid, job))
    launches = counters()

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
    # each kernel but the dropless MoE's (no MoE runs here), the SSD
    # forward's final state (no hybrid serves) and MLA's: launched in this
    # phase, the training kernels as many times as train_launches says for
    # the steps taken, serving 32 layers a prefill and 32 a decode step
    cfg = get_config("zamba2_1p2b").with_(n_layers=LIVE_TRAIN_LAYERS)
    steps = sum(len(job.step_seconds) for job in jobs.values())
    serves = len(stats["served"])
    decode_steps = sum(max(len(t) for t in s["tokens"]) - 1 for s in stats["served"])
    per_step = train_launches(cfg, 1)
    expected = {name: n * steps for name, n in per_step.items()}
    expected["flash_attention"] += serve_cfg.n_layers * serves
    expected.update(flash_decode=serve_cfg.n_layers * decode_steps, ssd_scan_final_state=0,
                    flash_attention_mla=0, flash_attention_bwd_mla=0)
    idle = {"expert_mm", "expert_mm_bwd", "ssd_scan_final_state", "flash_attention_mla",
            "flash_attention_bwd_mla"}
    print(f"launches {launches}, expected {expected} ({steps} train steps, "
          f"{serves} serve batches, {decode_steps} decode steps)")
    if launches != expected or not all(n for k, n in launches.items() if k not in idle):
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
    them (the SSD forward's final-state launches as ssd_scan_final_state,
    flash_attention's Dv != D launches as flash_attention_mla, and its
    backward's as flash_attention_bwd_mla)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    return launch_counts


def _no_mla_launches(fa, launches: dict, what: str) -> None:
    """A path that runs no MLA: add flash_attention's Dv != D launches,
    forward and backward, zeroed with the path's other counts, to
    `launches`; fail if any."""
    launches["flash_attention_mla"] = fa.flash_attention.mla_launches
    launches["flash_attention_bwd_mla"] = fa._launch_bwd.mla_launches
    if launches["flash_attention_mla"] or launches["flash_attention_bwd_mla"]:
        raise AssertionError(f"{what}: flash_attention launched a Dv != D instance")


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
    (logits, cache), steps, tokens, ttft, step_s, _ = _greedy(
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
                "ssd_scan_final_state": cfg.n_layers, "flash_attention_mla": 0,
                "flash_attention_bwd_mla": 0, "causal_conv": 2 * cfg.n_layers,
                "causal_conv_bwd": 0, "expert_mm": 0, "expert_mm_bwd": 0, "adamw": 0,
                "adamw_elems": 0}
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
                "ssd_scan_final_state": 0, "flash_attention_mla": 0,
                "flash_attention_bwd_mla": 0, "causal_conv": 0, "causal_conv_bwd": 0,
                "expert_mm": 0, "expert_mm_bwd": 0, **adamw_launches(cfg, QUICK_STEPS)}
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
    the window on the host clock, "busy_ms": the time in which any of its
    CUDA operations ran (the union of their intervals, user annotations left
    out), "busy_share", "launches", "top_ms": the eight costliest operations
    by name, [count, ms]})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ops = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    by_name = {}
    for e in ops:
        n, us = by_name.get(_kernel_name(e.name), (0, 0.0))
        by_name[_kernel_name(e.name)] = (n + 1, us + e.device_time_total)
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in ops):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    busy_ms = busy_us / 1e3
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
                "ssd_scan_final_state": 0, "flash_attention_mla": 0,
                "flash_attention_bwd_mla": 0, "causal_conv": 0, "causal_conv_bwd": 0,
                "expert_mm": 0, "expert_mm_bwd": 0, "adamw": 0,
                "adamw_elems": 0}
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
    expected.update(flash_decode=0, ssd_scan_final_state=0, flash_attention_mla=0,
                    flash_attention_bwd_mla=0)
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


# -------------------------------------------------------- 17. xLSTM parity
def _conv_launches_only(launches: dict, what: str, **counts) -> None:
    """xLSTM's one hand-written kernel is the mLSTM's causal conv (the mLSTM
    scan and the sLSTM loop are plain torch, as the reference's are jnp),
    and a train step's AdamW: fail if another launched, if the conv's
    forward did not, or if a count differs from `counts` where given."""
    print(f"launches {launches}, expected the conv's alone {counts or ''}")
    other = {k: n for k, n in launches.items()
             if n and not k.startswith("causal_conv") and k not in counts}
    if other or not launches["causal_conv"] or any(launches[k] != n for k, n in counts.items()):
        raise AssertionError(f"{what}: kernel launches {launches}: not the conv's alone "
                             f"{counts or ''}")


def mlstm_scan_cost(b, s, h, d, chunk):
    """(FLOPs, bytes) of the chunked mLSTM scan in f32: per chunk and head
    the causal (t, u) pairs of q.k and of the weighted scores times v, q
    times the carried C and the chunk's (w.k)^T v; q, k, v and the gates
    read once, y written once."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    flops = b * h * nc * (2 * 2 * pairs * d + 2 * 2 * chunk * d * d)
    nbytes = 4 * (4 * b * s * h * d + 2 * b * s * h)
    return flops, nbytes


def xlstm_parity(torch, fa, fd, ssd):
    """Reduced xlstm-350m in f32 (TF32 off), mLSTM chunk XLSTM_PARITY_CHUNK,
    the same seeded params on the card and on the CPU: a 64-token prefill
    and 8 greedy decode steps (logits, the prefill's and the last step's
    cache leaves within 1e-4, tokens equal), then one train step (phase 6's
    `train_parity`).  Then `ops.mlstm_scan` against `ref.naive_mlstm` at
    XLSTM_SCAN in f32, within 1e-4 of the largest magnitude, and the scan's
    device time beside its bound.  No hand-written kernel launches but the
    mLSTM's causal conv."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.reduced import reduced
    from repro_torch.kernels import ops, ref
    from repro_torch.models import init_params

    cfg = reduced("xlstm_350m")
    cfg = cfg.with_(xlstm=dataclasses.replace(cfg.xlstm, chunk=XLSTM_PARITY_CHUNK))
    counters = _zeroed_counters(fa, fd, ssd)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 64)))
    out = {dev: _greedy(torch, p, cfg, toks.to(dev), 9)
           for dev, p in (("cpu", params), ("cuda", _to(params, "cuda")))}
    (cl, cc), csteps, ctoks, _, _, cfinal = out["cpu"]
    (gl, gc), gsteps, gtoks, _, _, gfinal = out["cuda"]
    err = {"logits": max(float((g.cpu() - c).abs().max())
                         for g, c in zip([gl, *gsteps], [cl, *csteps]))}
    names = [f"{k}.{f}" for k, st in cfinal.items() for f in st._fields]
    finals = ([t for st in gfinal.values() for t in st], [t for st in cfinal.values() for t in st])
    leaf_ok = True
    for when, (gs, cs) in (("prefill", (gc, cc)), ("decoded", finals)):
        for name, g, c in zip(names, gs, cs):
            err[f"{when} {name}"] = float((g.cpu().float() - c.float()).abs().max())
            leaf_ok &= torch.allclose(g.cpu(), c, atol=1e-4, rtol=1e-4)
    print(json.dumps({"xlstm_serve_parity": {"max_abs_err": err, "tokens_equal": gtoks == ctoks,
                                             "tokens": gtoks[0]}}))
    if not (err["logits"] <= 1e-4 and leaf_ok and gtoks == ctoks):
        raise AssertionError(f"reduced xlstm serving differs cuda vs cpu: {err}, "
                             f"tokens equal {gtoks == ctoks}")
    train_parity(torch, cfg, "xlstm_train_parity")

    # the chunked scan at the full model's head shape, against the oracle
    b, s, h, d, chunk = (XLSTM_SCAN[k] for k in ("b", "s", "h", "d", "chunk"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift
    # q and k at the model's dh ** -0.5 scale, forget gates around the
    # model's bias (linspace(3, 6))
    args = (rnd(b, s, h, d, scale=d ** -0.5), rnd(b, s, h, d, scale=d ** -0.5),
            rnd(b, s, h, d), rnd(b, s, h), rnd(b, s, h, scale=2.0, shift=4.5))
    with torch.no_grad():
        y = ops.mlstm_scan(*args, chunk=chunk)
        y_ref = ref.naive_mlstm(*args)
        rel = float((y - y_ref).abs().max() / y_ref.abs().max())
        clock = Clock(torch)
        ms, host_ms = clock(lambda: ops.mlstm_scan(*args, chunk=chunk), 5)
        naive_ms, naive_host_ms = clock(lambda: ref.naive_mlstm(*args), 2)
        del clock
    flops, nbytes = mlstm_scan_cost(b, s, h, d, chunk)
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
    row = {**XLSTM_SCAN, "dtype": "float32", "max_rel_err": rel, "ms": ms,
           "host_ms": host_ms, "naive_ms": naive_ms, "naive_host_ms": naive_host_ms,
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    print(json.dumps({"mlstm_scan_full_width": row}))
    if not rel <= 1e-4:
        raise AssertionError(f"mlstm_scan differs from naive_mlstm by {rel} > 1e-4 relative")
    _conv_launches_only(counters(), "xlstm parity", **adamw_launches(cfg, 2))  # f32, bf16 step


# --------------------------------------------------------- 18. xLSTM serve
def full_width_xlstm_serve(torch, fa, fd, ssd):
    """xlstm-350m at full width and depth (24 blocks in 4 groups of one
    sLSTM and 5 mLSTM blocks, d_model 1024), bf16, random weights from seed
    0, serving XLSTM_BATCH prompts of XLSTM_PROMPT tokens and XLSTM_NEW new
    tokens greedy through `prefill` and `decode_step`.  Counts are zeroed
    just before the first serve and read just after; a second serve of the
    same prompts must give the same tokens; one prefill and one decode step
    run under torch.profiler.  Returns the launches."""
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.model import _xlstm_groups
    from repro_torch.training.optimizer import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cfg = get_config("xlstm_350m")
    params = init_params(cfg, seed=0, device="cuda")
    # the real leaves: the config's param_count() undercounts xLSTM
    n_params = sum(t.numel() for t in tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (XLSTM_BATCH, XLSTM_PROMPT))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zeroed_counters(fa, fd, ssd)
    (logits, _), steps, tokens, ttft, step_s, cache = _greedy(
        torch, params, cfg, toks, XLSTM_NEW)
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in steps)
    leaves = [t for st in cache.values() for t in st]
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    c_bytes = cache["mlstm"].C.numel() * cache["mlstm"].C.element_size()
    del steps
    decode_s = sum(step_s)
    n_tok = XLSTM_BATCH * XLSTM_NEW
    # a decode step reads every weight (the tied embedding is the unembed),
    # reads and writes every state
    step_bytes = param_bytes + 2 * state_bytes
    stats = {"ttft_s": ttft, "decode_s": decode_s, "tok_per_s": n_tok / (ttft + decode_s),
             "decode_tok_per_s": XLSTM_BATCH * (XLSTM_NEW - 1) / decode_s,
             "decode_step_ms_median": 1e3 * sorted(step_s)[len(step_s) // 2],
             "decode_step_ms_first_last": [1e3 * step_s[0], 1e3 * step_s[-1]],
             "max_memory_allocated": peak, "allocated_before_params": before,
             "phase_peak_bytes": peak - before, "params": n_params,
             "param_bytes": param_bytes, "config_param_count": cfg.param_count(),
             "state_bytes": state_bytes, "mlstm_C_bytes": c_bytes,
             "decode_step_bytes": step_bytes,
             "decode_step_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S}
    print(json.dumps({"xlstm_serve": stats, "launches": launches,
                      "first_tokens": [t[0] for t in tokens]}), flush=True)
    n_mlstm = math.prod(_xlstm_groups(cfg))
    _conv_launches_only(launches, "xlstm serve", causal_conv=n_mlstm, causal_conv_bwd=0)
    if not (finite and all(len(t) == XLSTM_NEW and all(0 <= v < cfg.vocab for v in t)
                           for t in tokens)):
        raise AssertionError("non-finite logits, or a request without "
                             f"{XLSTM_NEW} tokens in the vocab")
    again = _greedy(torch, params, cfg, toks, XLSTM_NEW)[2]
    print(f"xlstm serve deterministic: {again == tokens}")
    if again != tokens:
        raise AssertionError("a second serve of the same prompts gave other tokens")
    # where a prefill's and a decode step's time goes
    with torch.no_grad():
        (lg, cache), pre = profile_call(torch, lambda: prefill(params, toks, cfg))
        nxt = lg.argmax(-1)[:, None]
        decode_step(params, cache, nxt, XLSTM_PROMPT, cfg)          # warm
        _, dec = profile_call(torch, lambda: decode_step(params, cache, nxt,
                                                         XLSTM_PROMPT + 1, cfg))
    print(json.dumps({"xlstm_profile": {"prefill": pre, "decode_step": dec}}), flush=True)
    del params, cache, lg
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------- 19. xLSTM train
def slstm_loop_seconds(torch, cfg, batch: int, seq: int) -> dict:
    """Host-clock seconds of one sLSTM block at the train step's
    microbatch shape: its forward without grad (the checkpointed forward)
    and its forward then backward (the recompute and the backward), each
    synced, the median of 3 after one warm-up."""
    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(1)
    lp = {k: v.requires_grad_(True) for k, v in ssm.init_slstm(gen, cfg).items()}
    x = torch.randn((batch, seq, cfg.d_model), device="cuda", dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            ssm.slstm_fwd(lp, x, cfg)

    def fwd_bwd():
        y, _ = ssm.slstm_fwd(lp, x, cfg)
        y.float().sum().backward()

    out = {}
    for name, fn in (("forward", fwd), ("forward_backward", fwd_bwd)):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = sorted(times)[1]
    return out


def full_width_xlstm_train(torch, fa, fd, ssd):
    """xlstm-350m at full width and depth, bf16, remat "full", its 4
    microbatches, XLSTM_TRAIN_STEPS steps of XLSTM_TRAIN_BATCH x
    XLSTM_TRAIN_SEQ through `launch.train.main`.  Counts zeroed just before,
    read just after.  Then one sLSTM block timed alone at the microbatch's
    shape, for the serial loop's share of a step.  Returns the launches."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main

    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", "xlstm-350m", "--steps", str(XLSTM_TRAIN_STEPS),
            "--batch", str(XLSTM_TRAIN_BATCH), "--seq", str(XLSTM_TRAIN_SEQ)]
    counters = _zeroed_counters(fa, fd, ssd)
    stats = train_main(argv)
    launches = counters()
    print(json.dumps({"xlstm_train": stats, "launches": launches}), flush=True)
    cfg = get_config("xlstm_350m")
    _conv_launches_only(launches, "xlstm train", **{
        k: XLSTM_TRAIN_STEPS * n for k, n in train_launches(cfg, cfg.train_microbatches).items()
        if k.startswith(("causal_conv", "adamw"))})
    losses = stats["losses"]
    if not (len(losses) == XLSTM_TRAIN_STEPS and all(math.isfinite(x) for x in losses)
            and abs(losses[0] - math.log(cfg.vocab)) < 1.5):
        raise AssertionError(f"losses {losses}: not {XLSTM_TRAIN_STEPS} finite, or the first "
                             f"far from ln {cfg.vocab} = {math.log(cfg.vocab):.2f}")
    tokens = XLSTM_TRAIN_BATCH * XLSTM_TRAIN_SEQ
    steady = min(stats["step_seconds"][1:])
    # each step runs every sLSTM block, per microbatch, forward without
    # grad (remat), then forward and backward (the recompute, the backward)
    mb = cfg.train_microbatches
    loop = slstm_loop_seconds(torch, cfg, XLSTM_TRAIN_BATCH // mb, XLSTM_TRAIN_SEQ)
    n_slstm = cfg.n_layers // cfg.xlstm.slstm_every
    slstm_s = n_slstm * mb * (loop["forward"] + loop["forward_backward"])
    print(json.dumps({"step_seconds": stats["step_seconds"],
                      "tokens_per_s": stats["tokens_per_s"],
                      "steady_tokens_per_s": tokens / steady,
                      "max_memory_allocated": stats["max_memory_allocated"],
                      "slstm_block_s": loop, "slstm_s_per_step": slstm_s,
                      "slstm_share_of_steady_step": slstm_s / steady}))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------- 20. MLA parity
def mla_layer_cpu_vs_card(torch, p, cfg, seed: int, B: int, S: int) -> dict:
    """One MLA layer (params p on the CPU) on the CPU and on the card from
    the same seeded input x (B, S, d): the prefill of S - 1 tokens (out and
    the latents c_kv, k_rope), the latents in a cache of S rows, then the
    absorbed decode of token S (out and both leaves after it).  Returns
    each output's largest gap over the CPU's largest magnitude."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, cfg.d_model), generator=gen).to(p["wo"].dtype)
    pos = torch.arange(S)[None].expand(B, S)
    out = {}
    for dev in ("cpu", "cuda"):
        pd = {k: v.to(dev) for k, v in p.items()}
        xd, posd = x.to(dev), pos.to(dev)
        with torch.no_grad():
            o, (c, r) = layers.mla_fwd(pd, xd[:, :-1], cfg, positions=posd[:, :-1],
                                       return_kv=True)
            cc, cr = (t.new_zeros((B, S, t.shape[-1])) for t in (c, r))
            cc[:, :-1], cr[:, :-1] = c, r
            od, _ = layers.mla_fwd(pd, xd[:, -1:], cfg, positions=posd[:, -1:],
                                   cache=(cc, cr), cache_index=S - 1)
        out[dev] = [t.cpu() for t in (o, c, r, od, cc, cr)]
    names = ("prefill_out", "c_kv", "k_rope", "decode_out", "c_kv_after", "k_rope_after")
    return {n: _rel_err(g, c) for n, g, c in zip(names, out["cuda"], out["cpu"], strict=True)}


def mla_bf16_whole_model(torch, cfg, params, toks) -> dict:
    """The reduced model's bf16 `forward` on the card and on the CPU from
    the same params (on the CPU) and tokens, each MoE block's top-k expert
    ids recorded: the logits' largest gap over the CPU's largest magnitude,
    over every token and over the tokens routed alike in every block, and
    the tokens whose top-k set differs, block by block."""
    from repro_torch.models import forward, moe

    orig, out = moe._route, {}
    for dev, p in (("cpu", params), ("cuda", _to(params, "cuda"))):
        ids = []

        def record(*a, **kw):
            r = orig(*a, **kw)
            ids.append(r[2].view(-1, cfg.moe.top_k).sort(dim=-1).values.cpu())
            return r
        moe._route = record
        try:
            with torch.no_grad():
                logits = forward(p, toks.to(dev), cfg)
        finally:
            moe._route = orig
        out[dev] = logits.float().cpu(), ids
    (cl, cids), (gl, gids) = out["cpu"], out["cuda"]
    if not bool(torch.isfinite(gl).all()):
        raise AssertionError("non-finite bf16 logits on the card")
    flips = [(g != c).any(dim=-1) for g, c in zip(gids, cids, strict=True)]
    flipped = torch.stack(flips).any(dim=0).view(toks.shape)
    gap = (gl - cl).abs().amax(dim=-1)                     # (B, S)
    mag = float(cl.abs().max()) + 1e-6
    alike = gap[~flipped]
    return {"max_rel_err": float(gap.max()) / mag,
            "max_rel_err_routed_alike": float(alike.max()) / mag if alike.numel() else None,
            "tokens": toks.numel(), "tokens_flipped": int(flipped.sum()),
            "flipped_by_block": [int(f.sum()) for f in flips]}


def _mla_launches(launches: dict, n: int, what: str) -> None:
    """MLA runs one hand-written kernel: flash_attention's Dv != D instance,
    once a layer and prefill (its decode is the absorbed einsums).  Fail
    unless it launched n times and no other kernel launched."""
    _expect_launches(launches, what, flash_attention=n, flash_attention_mla=n)


def mla_parity(torch, fa, fd, ssd):
    """Reduced deepseek-v2 (MoE with a dense first block, and MLA) in f32
    (TF32 off), the same seeded params on the card and on the CPU: a
    MLA_PARITY_PROMPT-token prefill (logits and both latent leaves of both
    stacks) and 8 greedy decode steps (logits, the leaves after them)
    within 1e-4, tokens equal.  Then bf16, within 2e-2 of the largest
    magnitude: every block's MLA of the reduced model, and one MLA layer at
    deepseek-v2-236b's widths, on the card and on the CPU from the same
    inputs (`mla_layer_cpu_vs_card`).  bf16 is held layer by layer: a
    rounding gap that each layer keeps small can flip one token's top-k
    expert further down the stack, which moves that token's logits by far
    more than 2e-2, so whole-model bf16 logits measure routing as well as
    MLA.  The whole model's bf16 gap is printed beside the tokens whose
    routing flipped (`mla_bf16_whole_model`), and held to 2e-2 when none
    did.  Every prefill on the card launches flash_attention's Dv != D
    instance once a layer; nothing else launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models import init_params, layers
    from repro_torch.models.model import _layer

    cfg = reduced("deepseek_v2_236b")
    counters = _zeroed_counters(fa, fd, ssd)
    params = init_params(cfg, seed=0, device="cpu")
    S = MLA_PARITY_PROMPT
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, S)))
    rows = S + MLA_PARITY_NEW - 1
    out = {dev: _greedy(torch, p, cfg, toks.to(dev), MLA_PARITY_NEW, rows)
           for dev, p in (("cpu", params), ("cuda", _to(params, "cuda")))}
    (cl, cc), csteps, ctoks, _, _, cfinal = out["cpu"]
    (gl, gc), gsteps, gtoks, _, _, gfinal = out["cuda"]
    err = {"logits": max(float((g.cpu() - c).abs().max())
                         for g, c in zip([gl, *gsteps], [cl, *csteps], strict=True))}
    names = [f"{n}.{leaf}" for n in cfinal for leaf in ("c_kv", "k_rope")]
    finals = ([t for kv in gfinal.values() for t in kv], [t for kv in cfinal.values() for t in kv])
    for when, (gs, cs) in (("prefill", (gc, cc)), ("decoded", finals)):
        for name, g, c in zip(names, gs, cs, strict=True):
            err[f"{when} {name}"] = float((g.cpu() - c).abs().max())
    ok = max(err.values()) <= 1e-4 and gtoks == ctoks
    print(json.dumps({"mla_serve_parity": {"max_abs_err": err, "tokens_equal": gtoks == ctoks,
                                           "tokens": gtoks[0]}}), flush=True)
    if not ok:
        raise AssertionError(f"reduced deepseek-v2 serving differs cuda vs cpu: {err}, "
                             f"tokens equal {gtoks == ctoks}")

    bad = []
    bf = cfg.with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    bparams = init_params(bf, seed=0, device="cpu")
    cases = [(f"{name}[{i}]", bf, _layer(bparams[name]["attn"], i))
             for name in ("pre_layers", "layers")
             for i in range(bparams[name]["attn"]["wo"].shape[0])]
    full = get_config("deepseek_v2_236b")
    cases.append(("full width", full, layers.init_mla(torch.Generator().manual_seed(0), full)))
    for seed, (what, c, p) in enumerate(cases):
        rel = mla_layer_cpu_vs_card(torch, p, c, seed, 2, S)
        print(json.dumps({"mla_layer_bf16": {"layer": what, "max_rel_err": rel}}), flush=True)
        if not max(rel.values()) <= 2e-2:
            bad.append((what, rel))
    if bad:
        raise AssertionError(f"bf16 MLA differs cuda vs cpu by more than 2e-2: {bad}")
    whole = mla_bf16_whole_model(torch, bf, bparams, toks)
    print(json.dumps({"mla_model_bf16": whole}), flush=True)
    if whole["tokens_flipped"] == 0 and not whole["max_rel_err"] <= 2e-2:
        raise AssertionError(f"bf16 reduced deepseek-v2 differs cuda vs cpu by more than "
                             f"2e-2 with every token routed alike: {whole}")
    _mla_launches(counters(), 2 * cfg.n_layers + len(cases), "mla parity")


# ----------------------------------------------------------- 21. MLA serve
def padded_requests(vocab: int, n: int, prompt, new: int):
    """n requests from numpy's generator (seed 0): the first prompt[1]
    tokens long, so the batch is padded to prompt[1], and the others of a
    length drawn from prompt, each asking for `new` tokens."""
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    lens = [prompt[1], *(int(x) for x in rng.integers(prompt[0], prompt[1] + 1, n - 1))]
    return [Request(rid=i, prompt=rng.integers(0, vocab, x, dtype=np.int32),
                    max_new_tokens=new) for i, x in enumerate(lens)]


def mla_requests(vocab: int):
    """Phase 21's requests: MLA_REQUESTS prompts padded to MLA_PROMPT[1],
    MLA_NEW new tokens each."""
    return padded_requests(vocab, MLA_REQUESTS, MLA_PROMPT, MLA_NEW)


def mla_decode_step_bytes(cfg, params, batch: int, rows: int) -> dict:
    """A decode step's least bytes: every weight read once but the token
    embedding's unused rows (the unembedding is its own table, read
    whole; the capacity buffer runs every expert), both latent leaves read
    over `rows` rows, one row of each written."""
    from repro_torch.models import torch_dtype
    from repro_torch.training.optimizer import tree_leaves

    weight = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    tok = params["embed"]["tok"]
    weight -= (tok.shape[0] - batch) * tok.shape[1] * tok.element_size()
    m = cfg.mla
    row = cfg.n_layers * batch * (m.kv_lora + m.d_rope) * torch_dtype(cfg.compute_dtype).itemsize
    return {"weight_bytes": weight, "cache_read_bytes": row * rows, "row_bytes": row,
            "bytes": weight + row * rows + row}


def full_width_mla_serve(torch, fa, fd, ssd):
    """deepseek-v2-236b at full width cut to MLA_LAYERS layers, bf16,
    random weights from seed 0, built once, serving `mla_requests` through
    `ServeEngine` (max_seq MLA_MAX_SEQ).  Counts are zeroed just before the
    first serve and read just after; a second serve of the same requests on
    the same params must give the same tokens (two copies of the weights do
    not fit); one prefill and one decode step run under torch.profiler.
    Returns the launches."""
    import gc

    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill, torch_dtype
    from repro_torch.serving import ServeEngine
    from repro_torch.training.optimizer import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cfg = get_config("deepseek_v2_236b").with_(n_layers=MLA_LAYERS)
    m, mo = cfg.mla, cfg.moe
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    n_moe = cfg.n_layers - mo.first_dense
    esize = torch_dtype(cfg.compute_dtype).itemsize
    model = {"d_model": cfg.d_model, "heads": cfg.n_heads, "kv_lora": m.kv_lora,
             "q_lora": m.q_lora, "d_nope": m.d_nope, "d_rope": m.d_rope, "d_v": m.d_v,
             "experts": mo.n_experts, "top_k": mo.top_k, "shared": mo.n_shared,
             "d_expert": mo.d_expert, "d_first_dense": mo.d_first_dense, "vocab": cfg.vocab,
             "layers": cfg.n_layers, "moe_layers": n_moe,
             "params": sum(t.numel() for t in tree_leaves(params)),
             "param_bytes": nbytes(params), "embed_bytes": nbytes(params["embed"]),
             "dense_block_bytes": nbytes(params["pre_layers"]),
             "moe_block_bytes": nbytes(params["layers"]) / n_moe,
             "allocated_before_params": before, "init_s": init_s,
             "cache_bytes_per_token_per_layer": (m.kv_lora + m.d_rope) * esize,
             "gqa_cache_bytes_per_token_per_layer_at_these_heads":
                 2 * cfg.n_kv * cfg.d_head * esize}
    print(json.dumps({"mla_model": model}), flush=True)
    engine = ServeEngine(cfg, params, max_seq=MLA_MAX_SEQ, device="cuda")

    def serve():
        reqs = mla_requests(cfg.vocab)
        t0 = time.perf_counter()
        engine.serve_batch(reqs)
        torch.cuda.synchronize()
        return reqs, time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zeroed_counters(fa, fd, ssd)
    reqs, seconds = serve()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    step_s = list(engine.step_seconds)
    outputs = [r.tokens_out for r in reqs]
    n_tok = sum(len(o) for o in outputs)
    ttft = max(r.first_token_at - r.submitted_at for r in reqs)
    B, S = len(reqs), max(len(r.prompt) for r in reqs)
    stats = {"requests": B, "prompt_lens": [len(r.prompt) for r in reqs], "padded_prompt": S,
             "max_seq": MLA_MAX_SEQ, "tokens": n_tok, "seconds": seconds,
             "ttft_s_max": ttft, "tok_per_s": n_tok / seconds,
             "decode_tok_per_s": B * len(step_s) / sum(step_s),
             "decode_step_ms_median": 1e3 * sorted(step_s)[len(step_s) // 2],
             "decode_step_ms_first_last": [1e3 * step_s[0], 1e3 * step_s[-1]],
             "max_memory_allocated": peak, "phase_peak_bytes": peak - before}
    print(json.dumps({"mla_serve": stats, "launches": launches,
                      "first_tokens": [o[:8] for o in outputs]}), flush=True)
    _mla_launches(launches, cfg.n_layers, "mla serve")
    if (B, S) != (MLA_REQUESTS, MLA_PROMPT[1]) or len(step_s) != MLA_NEW - 1:
        raise AssertionError(f"served {B} x {S} in {len(step_s)} decode steps, not "
                             f"{MLA_REQUESTS} x {MLA_PROMPT[1]} in {MLA_NEW - 1}")
    if any(len(o) != MLA_NEW or not all(0 <= t < cfg.vocab for t in o) for o in outputs):
        raise AssertionError(f"a request did not return {MLA_NEW} tokens in the vocab")
    if not (math.isfinite(stats["tok_per_s"]) and ttft > 0):
        raise AssertionError(f"bad serve stats {stats}")
    again = [r.tokens_out for r in serve()[0]]
    print(f"mla serve deterministic: {again == outputs}")
    if again != outputs:
        raise AssertionError("a second serve of the same requests gave other tokens")
    step = mla_decode_step_bytes(cfg, params, B, MLA_MAX_SEQ)
    print(json.dumps({"mla_decode_step": {
        "median_ms": stats["decode_step_ms_median"], **step,
        "bound_ms": 1e3 * step["bytes"] / HBM_BYTES_PER_S,
        "formula": "weights but the unused token-embedding rows + both bf16 latent "
                   f"leaves over {MLA_MAX_SEQ} rows + one row written"}}), flush=True)
    # where a prefill's and a decode step's time goes
    toks = torch.zeros((B, S), dtype=torch.long)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = torch.from_numpy(r.prompt)
    toks = toks.cuda()
    with torch.no_grad():
        (logits, cache), pre = profile_call(torch, lambda: prefill(params, toks, cfg))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite prefill logits")
        cache = {n: tuple(F.pad(c, (0, 0, 0, MLA_MAX_SEQ - S)) for c in kv)
                 for n, kv in cache.items()}
        nxt = logits.argmax(-1)[:, None]
        decode_step(params, cache, nxt, S, cfg)            # warm
        _, dec = profile_call(torch, lambda: decode_step(params, cache, nxt, S + 1, cfg))
    print(json.dumps({"mla_profile": {"prefill": pre, "decode_step": dec}}), flush=True)
    del params, engine, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- 22. VLM and audio parity
def _expect_launches(launches: dict, what: str, **counts) -> None:
    """Fail unless each kernel launched as `counts` says, 0 for the others."""
    expected = {name: 0 for name in launches}
    expected.update(counts)
    print(f"launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"{what}: kernel launches {launches} != {expected}")


def _leaves(cache) -> list:
    """A cache's leaves in its own order (tuples opened, tensors as they are)."""
    return [t for leaf in cache.values() for t in (leaf if isinstance(leaf, tuple) else (leaf,))]


def vlm_audio_parity(torch, fa, fd, ssd):
    """Reduced internvl2-1b and seamless-m4t-medium, the same seeded params
    on the card and on the CPU.  f32 (TF32 off): a prefill with `extra`
    (logits and every cache leaf: the VLM's layers over patches and text,
    the audio model's self-attention k/v and its encoder memory) and
    VL_PARITY_NEW - 1 greedy decode steps (logits, the leaves after them)
    within 1e-4, tokens equal; one train step (phase 6's checks: f32 loss,
    grad norm and params within 1e-4, bf16 loss and grad norm within 2e-2).
    bf16: the whole model's logits within 2e-2 of the largest magnitude
    (nothing routes, so no flip excuses a miss).  Launches: flash_attention
    once a (decoder) layer and prefill or forward, flash_decode once a layer
    and step, flash_attention_bwd once a layer and train step; the audio
    encoder and every cross-attention launch nothing."""
    from repro_torch.configs.reduced import reduced
    from repro_torch.models import forward, init_params
    from repro_torch.training import synthetic_batch

    counters = _zeroed_counters(fa, fd, ssd)
    n_fa = n_fd = n_bwd = 0
    opt_counts = {"adamw": 0, "adamw_elems": 0}
    for arch in ("internvl2_1b", "seamless_m4t_medium"):
        cfg = reduced(arch)
        L = cfg.n_layers
        params = init_params(cfg, seed=0, device="cpu")
        batch = synthetic_batch(cfg, 2, VL_PARITY_TEXT, seed=5, device="cpu")
        rows = VL_PARITY_TEXT + VL_PARITY_NEW - 1 + (cfg.n_patches if cfg.family == "vlm" else 0)
        out = {dev: _greedy(torch, p, cfg, batch.tokens.to(dev), VL_PARITY_NEW, rows,
                            extra=batch.extra.to(dev))
               for dev, p in (("cpu", params), ("cuda", _to(params, "cuda")))}
        n_fa += L
        n_fd += L * (VL_PARITY_NEW - 1)
        (cl, cc), csteps, ctoks, _, _, cfinal = out["cpu"]
        (gl, gc), gsteps, gtoks, _, _, gfinal = out["cuda"]
        err = {"logits": max(float((g.cpu() - c).abs().max())
                             for g, c in zip([gl, *gsteps], [cl, *csteps], strict=True))}
        names = [f"{n}[{i}]" for n, leaf in cfinal.items()
                 for i in range(len(leaf) if isinstance(leaf, tuple) else 1)]
        for when, (gs, cs) in (("prefill", (gc, cc)),
                               ("decoded", (_leaves(gfinal), _leaves(cfinal)))):
            for name, g, c in zip(names, gs, cs, strict=True):
                err[f"{when} {name}"] = float((g.cpu() - c).abs().max())
        ok = max(err.values()) <= 1e-4 and gtoks == ctoks
        print(json.dumps({"vl_serve_parity": {"arch": cfg.name, "max_abs_err": err,
                                              "tokens_equal": gtoks == ctoks,
                                              "tokens": gtoks[0]}}), flush=True)
        if not ok:
            raise AssertionError(f"reduced {cfg.name} serving differs cuda vs cpu: {err}, "
                                 f"tokens equal {gtoks == ctoks}")
        train_parity(torch, cfg, tag=f"{cfg.name}_train_parity")
        n_fa += 2 * L                     # the f32 and the bf16 step, remat "none"
        n_bwd += 2 * L
        for k, n in adamw_launches(cfg, 2).items():
            opt_counts[k] += n
        bf = cfg.with_(param_dtype="bfloat16", compute_dtype="bfloat16")
        bparams = init_params(bf, seed=0, device="cpu")
        with torch.no_grad():
            lc = forward(bparams, batch.tokens, bf, batch.extra).float()
            lg = forward(_to(bparams, "cuda"), batch.tokens.cuda(), bf,
                         batch.extra.cuda()).float().cpu()
        n_fa += L
        rel = float((lg - lc).abs().max()) / float(lc.abs().max())
        print(json.dumps({"vl_model_bf16": {"arch": cfg.name, "max_rel_err": rel,
                                            "max_abs_logit": float(lc.abs().max())}}),
              flush=True)
        if not rel <= 2e-2:
            raise AssertionError(f"bf16 reduced {cfg.name} logits differ cuda vs cpu by "
                                 f"{rel} > 2e-2 of the largest")
    _expect_launches(counters(), "vlm / audio parity", flash_attention=n_fa,
                     flash_decode=n_fd, flash_attention_bwd=n_bwd, **opt_counts)


# ----------------------------------------------------------- 23. VLM serve
def decode_step_bytes(params, batch: int, unused=(), cache_read: int = 0,
                      row: int = 0) -> dict:
    """A decode step's least bytes: every weight it uses read once (all but
    the top-level `unused` params and the token embedding's unused rows; the
    unembedding is its own table, read whole), `cache_read` bytes of cache
    and memory read, `row` bytes written."""
    from repro_torch.training.optimizer import tree_leaves

    weight = sum(t.numel() * t.element_size() for name, p in params.items()
                 if name not in unused for t in tree_leaves(p))
    tok = params["embed"]["tok"]
    weight -= (tok.shape[0] - batch) * tok.shape[1] * tok.element_size()
    return {"weight_bytes": weight, "cache_read_bytes": cache_read, "row_bytes": row,
            "bytes": weight + cache_read + row}


def _serve_stats(step_s, ttft: float, n_tok: int, peak: int, before: int) -> dict:
    decode_s = sum(step_s)
    return {"ttft_s": ttft, "decode_s": decode_s, "tok_per_s": n_tok / (ttft + decode_s),
            "decode_step_ms_median": 1e3 * sorted(step_s)[len(step_s) // 2],
            "decode_step_ms_first_last": [1e3 * step_s[0], 1e3 * step_s[-1]],
            "max_memory_allocated": peak, "phase_peak_bytes": peak - before}


def full_width_vlm_serve(torch, fa, fd, ssd):
    """internvl2-1b at full width and depth (24 layers, d_model 896, 14
    heads over 2, vocab 151,655), bf16, random weights from seed 0, built
    once.  `ServeEngine` serves VLM_REQUESTS text prompts padded to
    VLM_PROMPT[1] (the reference's engine passes no patches); then the
    patch path: `prefill(extra=patches)` with `synthetic_batch`'s 256 patch
    embeddings before VLM_PATCH_TEXT text tokens, and greedy `decode_step`
    over the cache grown to VLM_MAX_SEQ rows.  Counts are zeroed just
    before each and read just after; a second run of each must give the
    same tokens.  Returns the launches of both."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeEngine
    from repro_torch.training import synthetic_batch
    from repro_torch.training.optimizer import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cfg = get_config("internvl2_1b")
    L = cfg.n_layers
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    engine = ServeEngine(cfg, params, max_seq=VLM_MAX_SEQ, device="cuda")

    def serve():
        reqs = padded_requests(cfg.vocab, VLM_REQUESTS, VLM_PROMPT, VLM_NEW)
        engine.serve_batch(reqs)
        torch.cuda.synchronize()
        return reqs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zeroed_counters(fa, fd, ssd)
    t0 = time.perf_counter()
    reqs = serve()
    seconds = time.perf_counter() - t0
    engine_launches = counters()
    outputs = [r.tokens_out for r in reqs]
    B, S = len(reqs), max(len(r.prompt) for r in reqs)
    step_s = list(engine.step_seconds)
    ttft = max(r.first_token_at - r.submitted_at for r in reqs)
    stats = {"requests": B, "prompt_lens": [len(r.prompt) for r in reqs], "padded_prompt": S,
             "max_seq": VLM_MAX_SEQ, "seconds": seconds, "params": n_params,
             **_serve_stats(step_s, ttft, sum(len(o) for o in outputs),
                            torch.cuda.max_memory_allocated(), before)}
    print(json.dumps({"vlm_serve_engine": stats, "launches": engine_launches,
                      "first_tokens": [o[:8] for o in outputs]}), flush=True)
    _expect_launches(engine_launches, "vlm serve (engine)", flash_attention=L,
                     flash_decode=L * (VLM_NEW - 1))
    if (B, S) != (VLM_REQUESTS, VLM_PROMPT[1]) or len(step_s) != VLM_NEW - 1:
        raise AssertionError(f"served {B} x {S} in {len(step_s)} decode steps")
    if any(len(o) != VLM_NEW or not all(0 <= t < cfg.vocab for t in o) for o in outputs):
        raise AssertionError(f"a request did not return {VLM_NEW} tokens in the vocab")
    again = [r.tokens_out for r in serve()]
    print(f"vlm engine serve deterministic: {again == outputs}")
    if again != outputs:
        raise AssertionError("a second serve of the same requests gave other tokens")
    row = 2 * L * B * cfg.n_kv * cfg.d_head * 2          # one bf16 k/v row, every layer
    vlen = S + VLM_NEW // 2                              # the median step's valid rows
    step = decode_step_bytes(params, B, ("patch_proj",), row * vlen, row)
    print(json.dumps({"vlm_engine_decode_step": {
        "median_ms": stats["decode_step_ms_median"], **step,
        "bound_ms": 1e3 * step["bytes"] / HBM_BYTES_PER_S,
        "formula": "weights but patch_proj and the unused token-embedding rows + the bf16 "
                   f"k/v cache over {vlen} rows + one row written"}}), flush=True)

    # the patch path
    batch = synthetic_batch(cfg, VLM_REQUESTS, VLM_PATCH_TEXT, seed=0, device="cuda")
    rows = VLM_PATCHES + VLM_PATCH_TEXT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zeroed_counters(fa, fd, ssd)
    (logits, _), steps, tokens, ttft, step_s, cache = _greedy(
        torch, params, cfg, batch.tokens, VLM_NEW, VLM_MAX_SEQ, extra=batch.extra)
    torch.cuda.synchronize()
    patch_launches = counters()
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in steps)
    stats = {"batch": VLM_REQUESTS, "patches": VLM_PATCHES, "text": VLM_PATCH_TEXT,
             "rows": rows, "cache_rows": cache["layers"][0].shape[2],
             **_serve_stats(step_s, ttft, VLM_REQUESTS * VLM_NEW,
                            torch.cuda.max_memory_allocated(), before)}
    print(json.dumps({"vlm_serve_patches": stats, "launches": patch_launches,
                      "first_tokens": [t[:8] for t in tokens]}), flush=True)
    _expect_launches(patch_launches, "vlm serve (patches)", flash_attention=L,
                     flash_decode=L * (VLM_NEW - 1))
    if not (finite and stats["cache_rows"] == VLM_MAX_SEQ
            and all(len(t) == VLM_NEW and all(0 <= v < cfg.vocab for v in t) for t in tokens)):
        raise AssertionError(f"non-finite logits, or a sequence without {VLM_NEW} tokens "
                             "in the vocab")
    del steps, cache
    again = _greedy(torch, params, cfg, batch.tokens, VLM_NEW, VLM_MAX_SEQ,
                    extra=batch.extra)[2]
    print(f"vlm patch serve deterministic: {again == tokens}")
    if again != tokens:
        raise AssertionError("a second serve of the same patches and prompts gave other "
                             "tokens")
    vlen = rows + VLM_NEW // 2
    step = decode_step_bytes(params, VLM_REQUESTS, ("patch_proj",), row * vlen, row)
    print(json.dumps({"vlm_patch_decode_step": {
        "median_ms": stats["decode_step_ms_median"], **step,
        "bound_ms": 1e3 * step["bytes"] / HBM_BYTES_PER_S}}), flush=True)
    # where a prefill's and a decode step's time goes
    with torch.no_grad():
        (logits, cache), pre = profile_call(
            torch, lambda: prefill(params, batch.tokens, cfg, extra=batch.extra))
        cache = {n: tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, VLM_MAX_SEQ - rows))
                          for c in kv) for n, kv in cache.items()}
        nxt = logits.argmax(-1)[:, None]
        decode_step(params, cache, nxt, rows, cfg)            # warm
        _, dec = profile_call(torch, lambda: decode_step(params, cache, nxt, rows + 1, cfg))
    print(json.dumps({"vlm_profile": {"prefill": pre, "decode_step": dec}}), flush=True)
    del params, engine, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {k: engine_launches[k] + patch_launches[k] for k in engine_launches}


# --------------------------------------------------------- 24. audio serve
def full_width_audio_serve(torch, fa, fd, ssd):
    """seamless-m4t-medium at full width and depth (12 encoder and 12
    decoder layers, d_model 1024, 16 heads, vocab 256,206), bf16, random
    weights from seed 0: `prefill(extra=frames)` with `synthetic_batch`'s
    AUDIO_BATCH x 1,024 frame embeddings and AUDIO_TEXT text tokens, then
    greedy `decode_step` with "self" grown to AUDIO_CACHE rows and "enc"
    left as it is (the engine refuses enc-dec models, as the reference's
    does).  Counts are zeroed just before and read just after; a second
    run must give the same tokens.  Prints the encoder's and the decoder's
    device time in a prefill.  Returns the launches."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, model, prefill
    from repro_torch.training import synthetic_batch
    from repro_torch.training.optimizer import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cfg = get_config("seamless_m4t_medium")
    L = cfg.n_layers
    params = init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = synthetic_batch(cfg, AUDIO_BATCH, AUDIO_TEXT, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zeroed_counters(fa, fd, ssd)
    (logits, pre_leaves), steps, tokens, ttft, step_s, cache = _greedy(
        torch, params, cfg, batch.tokens, AUDIO_NEW, AUDIO_CACHE, extra=batch.extra)
    torch.cuda.synchronize()
    launches = counters()
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in steps)
    enc_kept = torch.equal(cache["enc"], pre_leaves[-1])
    stats = {"batch": AUDIO_BATCH, "frames": cfg.enc_len, "text": AUDIO_TEXT,
             "self_rows": cache["self"][0].shape[2], "enc": list(cache["enc"].shape),
             "params": n_params,
             **_serve_stats(step_s, ttft, AUDIO_BATCH * AUDIO_NEW,
                            torch.cuda.max_memory_allocated(), before)}
    print(json.dumps({"audio_serve": stats, "launches": launches,
                      "first_tokens": [t[:8] for t in tokens]}), flush=True)
    _expect_launches(launches, "audio serve", flash_attention=L,
                     flash_decode=L * (AUDIO_NEW - 1))
    if not (finite and enc_kept and stats["self_rows"] == AUDIO_CACHE
            and stats["enc"] == [AUDIO_BATCH, cfg.enc_len, cfg.d_model]
            and all(len(t) == AUDIO_NEW and all(0 <= v < cfg.vocab for v in t)
                    for t in tokens)):
        raise AssertionError(f"non-finite logits, a changed or regrown encoder memory "
                             f"(kept {enc_kept}), or a sequence without {AUDIO_NEW} tokens")
    del steps, cache, pre_leaves
    again = _greedy(torch, params, cfg, batch.tokens, AUDIO_NEW, AUDIO_CACHE,
                    extra=batch.extra)[2]
    print(f"audio serve deterministic: {again == tokens}")
    if again != tokens:
        raise AssertionError("a second serve of the same frames and prompts gave other "
                             "tokens")
    # a decode step reads the decoder's weights, the encoder memory and the
    # self-attention cache up to its valid length, writes one k/v row, and
    # projects k and v from the memory again in every layer (its operations)
    row = 2 * L * AUDIO_BATCH * cfg.n_kv * cfg.d_head * 2
    vlen = AUDIO_TEXT + AUDIO_NEW // 2
    mem = AUDIO_BATCH * cfg.enc_len * cfg.d_model * 2
    step = decode_step_bytes(params, AUDIO_BATCH, ("enc_layers", "ln_enc"),
                             row * vlen + mem, row)
    cross_kv_flops = L * 2 * 2 * AUDIO_BATCH * cfg.enc_len * cfg.d_model * cfg.n_kv * cfg.d_head
    print(json.dumps({"audio_decode_step": {
        "median_ms": stats["decode_step_ms_median"], **step,
        "bound_ms": 1e3 * step["bytes"] / HBM_BYTES_PER_S,
        "cross_kv_flops": cross_kv_flops,
        "cross_kv_ops_ms": 1e3 * cross_kv_flops / PEAK_FLOPS["bfloat16"],
        "formula": "decoder weights but the unused token-embedding rows + the encoder "
                   f"memory + the bf16 self k/v over {vlen} rows + one row written; the "
                   "cross k/v recomputed from the memory every step"}}), flush=True)
    # where a prefill's time goes: the encoder alone, then the whole prefill
    with torch.no_grad():
        prefill(params, batch.tokens, cfg, extra=batch.extra)     # warm
        _, enc = profile_call(torch, lambda: model._encode(params, batch.extra, cfg,
                                                           remat=False))
        (logits, cache), pre = profile_call(
            torch, lambda: prefill(params, batch.tokens, cfg, extra=batch.extra))
        cache["self"] = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, AUDIO_NEW))
                              for c in cache["self"])
        nxt = logits.argmax(-1)[:, None]
        decode_step(params, cache, nxt, AUDIO_TEXT, cfg)            # warm
        _, dec = profile_call(torch, lambda: decode_step(params, cache, nxt,
                                                         AUDIO_TEXT + 1, cfg))
    print(json.dumps({"audio_profile": {
        "encoder": enc, "prefill": pre, "decoder_busy_ms": pre["busy_ms"] - enc["busy_ms"],
        "decode_step": dec}}), flush=True)
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------- 25. VLM and audio train
def one_batch_losses(torch, cfg, seq: int) -> list:
    """TRAIN_STEPS steps of `launch.train.main`'s model and optimizer (seed
    0, AdamW at its lr 3e-4, warmup and schedule) on its first batch,
    TRAIN_BATCH x seq, every step: the losses before each step and after
    the last."""
    from repro_torch.models import init_params, loss_fn
    from repro_torch.training import (AdamW, make_train_state, make_train_step,
                                      synthetic_batch)

    opt = AdamW(lr=3e-4, warmup=min(100, TRAIN_STEPS // 10 + 1), total_steps=TRAIN_STEPS)
    state = make_train_state(init_params(cfg, seed=0, device="cuda"), opt)
    step = make_train_step(cfg, opt, microbatches=cfg.train_microbatches)
    batch = synthetic_batch(cfg, TRAIN_BATCH, seq, step=0, device="cuda")
    losses = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    mb = cfg.train_microbatches
    with torch.no_grad():                   # the last loss, in the same microbatches
        last = sum(float(loss_fn(state.params, type(batch)(*(
            None if x is None else x[i * TRAIN_BATCH // mb:(i + 1) * TRAIN_BATCH // mb]
            for x in batch)), cfg)[0]) for i in range(mb)) / mb
    return losses + [last]


def full_width_vlm_audio_train(torch, fa, fd, ssd):
    """internvl2-1b and seamless-m4t-medium at full width and depth, bf16,
    remat "full", each in its config's microbatches, through
    `launch.train.main`: TRAIN_STEPS steps of TRAIN_BATCH x VLM_TRAIN_SEQ
    text tokens after 256 patches, and of TRAIN_BATCH x AUDIO_TRAIN_SEQ
    tokens over 1,024 frames.  Counts zeroed just before each, read just
    after and held to `train_launches`; the losses finite, the first near
    ln(vocab), the grad norms finite.  Each step draws a new batch (a
    random walk from a new random base token), so those losses are of
    different data; that training lowers the loss is held on one batch:
    the same model and optimizer, TRAIN_STEPS steps on the first batch,
    whose last loss must be below its first (`one_batch_losses`).  Returns
    the launches of each ({"vlm": ..., "audio": ...})."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main

    out = {}
    for key, arch, seq, rows in (("vlm", "internvl2-1b", VLM_TRAIN_SEQ,
                                  VLM_PATCHES + VLM_TRAIN_SEQ),
                                 ("audio", "seamless-m4t-medium", AUDIO_TRAIN_SEQ,
                                  AUDIO_TRAIN_SEQ)):
        gc.collect()
        torch.cuda.empty_cache()
        argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                "--seq", str(seq)]
        counters = _zeroed_counters(fa, fd, ssd)
        stats = train_main(argv)
        launches = counters()
        print(json.dumps({f"{key}_train": stats, "launches": launches}), flush=True)
        cfg = get_config(arch)
        per_step = train_launches(cfg, cfg.train_microbatches)
        _expect_launches(launches, f"{arch} train",
                         **{k: TRAIN_STEPS * n for k, n in per_step.items()})
        losses, gnorms = stats["losses"], stats["grad_norms"]
        if not (len(losses) == TRAIN_STEPS
                and all(math.isfinite(x) for x in losses + gnorms)
                and abs(losses[0] - math.log(cfg.vocab)) < 1.5):
            raise AssertionError(f"{arch}: losses {losses}, grad norms {gnorms}: not "
                                 f"{TRAIN_STEPS} finite, or the first far from ln {cfg.vocab}")
        gc.collect()
        torch.cuda.empty_cache()
        same = one_batch_losses(torch, cfg, seq)
        print(json.dumps({f"{key}_one_batch_losses": same}), flush=True)
        if not (all(math.isfinite(x) for x in same) and same[-1] < same[0]):
            raise AssertionError(f"{arch}: {TRAIN_STEPS} steps on one batch did not lower its "
                                 f"loss: {same}")
        step_s = stats["step_seconds"]
        print(json.dumps({f"{key}_train_rates": {
            "step_seconds": step_s, "microbatches": cfg.train_microbatches,
            "rows_per_step": TRAIN_BATCH * rows, "text_tokens_per_step": TRAIN_BATCH * seq,
            "tokens_per_s": stats["tokens_per_s"],
            "steady_text_tokens_per_s": TRAIN_BATCH * seq / min(step_s[1:]),
            "steady_rows_per_s": TRAIN_BATCH * rows / min(step_s[1:]),
            "max_memory_allocated": stats["max_memory_allocated"]}}), flush=True)
        out[key] = launches
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------- 26. MLA train parity
def mla_layer_grads_cpu_vs_card(torch, p, cfg, seed: int, B: int, S: int) -> dict:
    """One MLA layer (params p on the CPU) run forward and backward in its
    training form on the CPU and on the card, from the same seeded input x
    (B, S, d) and upstream gradient: out, dx and each param's gradient,
    each as its largest gap over the CPU's largest magnitude."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(seed)
    x, dy = (torch.randn((B, S, cfg.d_model), generator=gen).to(p["wo"].dtype)
             for _ in range(2))
    pos = torch.arange(S)[None].expand(B, S)
    names = ["out", "dx", *(f"d{k}" for k in p)]
    out = {}
    for dev in ("cpu", "cuda"):
        pd = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        xd = x.to(dev).requires_grad_(True)
        o, _ = layers.mla_fwd(pd, xd, cfg, positions=pos.to(dev))
        grads = torch.autograd.grad(o, [xd, *pd.values()], dy.to(dev), allow_unused=True)
        out[dev] = [o.detach().cpu(), *(None if g is None else g.cpu() for g in grads)]
    return {n: _rel_err(g, c) for n, g, c in zip(names, out["cuda"], out["cpu"], strict=True)
            if c is not None}


def mla_train_parity(torch, fa, fd, ssd):
    """Reduced deepseek-v2 trained on the card against the CPU: one f32
    train step (TF32 off) from the same seeded params, loss, grad norm and
    params within 1e-4 (`train_parity`); then bf16 layer by layer (whole-
    model bf16 measures MoE routing flips as well, phase 20): every reduced
    block's MLA and one MLA layer at deepseek-v2-236b's widths, forward and
    backward from the same inputs on both, out and every gradient within
    2e-2 of the largest magnitude.  Every attention call launches the
    Dv != D forward and backward instances ((48, 32), and (192, 128) for
    the full-width layer); nothing else launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.models import init_params, layers
    from repro_torch.models.model import _layer

    cfg = reduced("deepseek_v2_236b")
    counters = _zeroed_counters(fa, fd, ssd)
    train_parity(torch, cfg, "mla_train_parity", bf16=False)
    bf = cfg.with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    bparams = init_params(bf, seed=0, device="cpu")
    cases = [(f"{name}[{i}]", bf, _layer(bparams[name]["attn"], i))
             for name in ("pre_layers", "layers")
             for i in range(bparams[name]["attn"]["wo"].shape[0])]
    full = get_config("deepseek_v2_236b")
    cases.append(("full width", full, layers.init_mla(torch.Generator().manual_seed(0), full)))
    bad = []
    for seed, (what, c, p) in enumerate(cases):
        rel = mla_layer_grads_cpu_vs_card(torch, p, c, seed, 2, 64)
        print(json.dumps({"mla_layer_grads_bf16": {"layer": what, "max_rel_err": rel}}),
              flush=True)
        if not max(rel.values()) <= 2e-2:
            bad.append((what, rel))
    if bad:
        raise AssertionError(f"bf16 MLA gradients differ cuda vs cpu by more than 2e-2: {bad}")
    step = train_launches(cfg, 1)
    n_fa, n_bwd = step["flash_attention"] + len(cases), step["flash_attention_bwd"] + len(cases)
    _expect_launches(counters(), "mla train parity", flash_attention=n_fa,
                     flash_attention_mla=n_fa, flash_attention_bwd=n_bwd,
                     flash_attention_bwd_mla=n_bwd, adamw=step["adamw"],
                     adamw_elems=step["adamw_elems"])


# ---------------------------------------------------------- 27. MLA train
def full_width_mla_train(torch, fa, fd, ssd):
    """deepseek-v2-236b at full width cut to MLA_TRAIN_LAYERS layers, bf16,
    remat "full", one microbatch, MLA_TRAIN_STEPS steps of MLA_TRAIN_BATCH
    x MLA_TRAIN_SEQ tokens through `launch.train.main`.  Counts zeroed just
    before, read just after: every layer's attention runs the (192, 128)
    forward (twice under remat) and backward instances, nothing else
    launches.  Returns the launches."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main

    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", "deepseek-v2-236b", "--layers", str(MLA_TRAIN_LAYERS),
            "--microbatches", "1", "--steps", str(MLA_TRAIN_STEPS),
            "--batch", str(MLA_TRAIN_BATCH), "--seq", str(MLA_TRAIN_SEQ)]
    torch.cuda.reset_peak_memory_stats()
    counters = _zeroed_counters(fa, fd, ssd)
    stats = train_main(argv)
    launches = counters()
    print(json.dumps({"mla_train": stats, "launches": launches}), flush=True)
    cfg = get_config("deepseek_v2_236b").with_(n_layers=MLA_TRAIN_LAYERS,
                                               train_microbatches=1)
    step = train_launches(cfg, 1)
    _expect_launches(launches, "mla train",
                     flash_attention=MLA_TRAIN_STEPS * step["flash_attention"],
                     flash_attention_mla=MLA_TRAIN_STEPS * step["flash_attention"],
                     flash_attention_bwd=MLA_TRAIN_STEPS * step["flash_attention_bwd"],
                     flash_attention_bwd_mla=MLA_TRAIN_STEPS * step["flash_attention_bwd"],
                     **adamw_launches(cfg, MLA_TRAIN_STEPS))
    losses = stats["losses"]
    if not (len(losses) == MLA_TRAIN_STEPS and all(math.isfinite(x) for x in losses)
            and abs(losses[0] - math.log(cfg.vocab)) < 1.5):
        raise AssertionError(f"losses {losses}: not {MLA_TRAIN_STEPS} finite, or the first "
                             f"far from ln {cfg.vocab} = {math.log(cfg.vocab):.2f}")
    tokens = MLA_TRAIN_BATCH * MLA_TRAIN_SEQ
    print(json.dumps({"step_seconds": stats["step_seconds"], "losses": losses,
                      "tokens_per_s": stats["tokens_per_s"],
                      "steady_tokens_per_s": tokens / min(stats["step_seconds"][1:]),
                      "max_memory_allocated": stats["max_memory_allocated"],
                      "mla_launches": {"forward": launches["flash_attention_mla"],
                                       "backward": launches["flash_attention_bwd_mla"]}}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- 28. dry run
def dry_run_cells(torch, fa, fd, ssd) -> list:
    """Two dry-run cells traced in this process on the `fake` process-group
    backend, over fake tensors (no memory, no card): deepseek-v2-236b's
    train_4k at full width on the 16 x 16 mesh, depth cut to
    DRYRUN_LAYERS, and the reduced olmoe-1b-7b train cell on 4 x 2.  Each
    must trace with its per-device argument bytes, FLOPs and collectives
    positive, the MoE cell with all-reduces (its experts' outputs summed
    over `model`); no kernel launches.  Returns the cells (counts from a
    trace, not device measurements)."""
    import torch.distributed as tdist
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models.config import ShapeSpec

    counters = _zeroed_counters(fa, fd, ssd)
    cells = []
    try:
        t0 = time.perf_counter()
        cells.append(dryrun.run_cell("deepseek_v2_236b", "train_4k", False,
                                     overrides={"n_layers": DRYRUN_LAYERS}))
        fake_world(8)
        t1 = time.perf_counter()
        mini = dryrun.trace_cell(reduced("olmoe_1b_7b").with_(train_microbatches=2),
                                 ShapeSpec("t", 64, 16, "train"),
                                 make_mesh((4, 2), ("data", "model")))
        cells.append({"arch": "olmoe_1b_7b (reduced)", "shape": "t 64 x 16 train",
                      "mesh": {"data": 4, "model": 2}, "status": "ok",
                      "trace_s": round(time.perf_counter() - t1, 1), **mini})
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    print(json.dumps({"dry_run": cells, "seconds": time.perf_counter() - t0}), flush=True)
    for c in cells:
        ok = (c["status"] == "ok" and c["memory"]["argument_bytes"] > 0
              and c["cost"]["flops"] > 0 and c["collectives"]["total_bytes"] > 0)
        if not ok:
            raise AssertionError(f"dry-run cell {c['arch']} {c['shape']}: {c}")
    if not cells[1]["collectives"].get("all-reduce", {}).get("count"):
        raise AssertionError("the MoE dry-run cell issued no all-reduce")
    _expect_launches(counters(), "dry run")
    return cells


# ------------------------------------------------------ 29. train on a rank
MESH_TRAIN_REL = 2e-2   # bf16 losses, the mesh path against phase 7's


def mesh_train(torch, fa, fd, ssd, one_launches: dict, one_stats: dict) -> dict:
    """Phase 7's cell again through the multi-device path, on one NCCL
    rank: `runtime/ranks.py` spawns a rank process on cuda:0 (the spawn, the
    TCPStore rendezvous and NCCL's initialisation on the card), which runs
    `launch.train.main(TRAIN_ARGV + ["--mesh", "1x1"])`: the state placed as
    DTensors by `tree_shardings`, each batch by `batch_sharding`, the kernels
    reached through `local_map` (a kernel's wrapper refuses a DTensor).
    The rank's counts are zeroed just before and read just after, in the
    rank; this process launches nothing.  Fails unless the launches equal
    phase 7's (so every attention and SSD call, and AdamW once a leaf,
    launched its kernel on the rank's shards: on the card no plain version
    is reachable) and the losses are phase 7's within
    MESH_TRAIN_REL.  Prints both paths' step seconds and peak memory, paired:
    DTensor's host overhead is recorded, not claimed.  Returns the launches."""
    import gc

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import main as train_main
    from repro_torch.runtime.ranks import RankGroup

    gc.collect()
    torch.cuda.empty_cache()     # the rank's own process needs phase 7's memory
    here = _zeroed_counters(fa, fd, ssd)
    t0 = time.perf_counter()
    with RankGroup(["cuda:0"], timeout=600.0) as rank:
        start_s = time.perf_counter() - t0
        rank.call(reset_launch_counts)
        stats = rank.call(train_main, TRAIN_ARGV + ["--mesh", "1x1"])
        launches = rank.call(launch_counts)
    _expect_launches(here(), "mesh train (the calling process)")
    print(json.dumps({"mesh_train": stats, "launches": launches, "rank_start_s": start_s}),
          flush=True)
    print(json.dumps({"paired": {
        "step_seconds": {"one_device": one_stats["step_seconds"],
                         "mesh_1x1": stats["step_seconds"]},
        "max_memory_allocated": {"one_device": one_stats["max_memory_allocated"],
                                 "mesh_1x1": stats["max_memory_allocated"]},
        "losses": {"one_device": one_stats["losses"], "mesh_1x1": stats["losses"]}}}),
        flush=True)
    if stats["mesh"] != {"data": 1, "model": 1}:
        raise AssertionError(f"mesh train ran on {stats['mesh']}, not 1 x 1")
    _expect_launches(launches, "mesh train", **one_launches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(stats["losses"], one_stats["losses"]))
    print(f"losses {stats['losses']} vs phase 7's {one_stats['losses']}: rel {rel:.3e}")
    if len(stats["losses"]) != len(one_stats["losses"]) or not rel <= MESH_TRAIN_REL:
        raise AssertionError(f"mesh train losses {stats['losses']} vs phase 7's "
                             f"{one_stats['losses']}: rel {rel} > {MESH_TRAIN_REL}")
    return launches


# ------------------------------------------- 30. OLMoE as published, trained
def olmoe_published_cfg():
    """olmoe-1b-7b with the published options on (QK-norm, dropless
    routing, ungated top-8 weights), cut to OLMOE_LAYERS layers and one
    microbatch: the program config the benchmark's olmoe-train runs."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config("olmoe_1b_7b")
    return cfg.with_(n_layers=OLMOE_LAYERS, qk_norm=True, train_microbatches=1,
                     moe=dataclasses.replace(cfg.moe, dropless=True, norm_topk=False))


def dropless_layer_vs_loop(torch, cfg, tokens: int) -> dict:
    """One dropless MoE layer at full width over `tokens` tokens, bf16,
    forward and backward: the grouped GEMMs against the same layer with
    `ops.expert_mm` swapped for the per-expert loop on the card.  Returns
    each output's error relative to the loop's largest magnitude; fails
    above 2e-2 or unless the grouped GEMMs launched 3 forward and 3
    backward calls."""
    from repro_torch.kernels import expert_mm as emm
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import ops as kops
    from repro_torch.models import moe
    from repro_torch.models.moe import init_moe

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    p = init_moe(gen, cfg)
    x = torch.randn((tokens // 2048, 2048, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    out = {}
    for how in ("grouped", "loop"):
        live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xi = x.detach().requires_grad_(True)
        n0 = launch_counts()
        swap = kops.expert_mm
        if how == "loop":
            kops.expert_mm = emm.expert_mm_plain
        try:
            y, aux = moe.moe_fwd(live, xi, cfg)
            torch.autograd.backward([y, aux], [dy, torch.ones_like(aux)])
        finally:
            kops.expert_mm = swap
        n1 = launch_counts()
        out[how] = ({"y": y.detach(), "dx": xi.grad,
                     **{f"d{k}": t.grad for k, t in live.items()}},
                    (n1["expert_mm"] - n0["expert_mm"], n1["expert_mm_bwd"] - n0["expert_mm_bwd"]))
    (got, n_got), (want, n_want) = out["grouped"], out["loop"]
    rel = {k: _rel_err(got[k], want[k]) for k in want}
    print(json.dumps({"dropless_layer_vs_loop": {"tokens": tokens, "max_rel_err": rel,
                                                 "launches": [n_got, n_want]}}), flush=True)
    if n_got != (3, 3) or n_want != (0, 0):
        raise AssertionError(f"dropless layer: grouped GEMM launches {n_got} (loop {n_want}), "
                             f"not 3 forward and 3 backward")
    if not max(rel.values()) <= TOL["bfloat16"]:
        raise AssertionError(f"dropless layer: grouped GEMMs differ from the per-expert loop "
                             f"by {rel} > {TOL['bfloat16']}")
    return rel


def olmoe_published_train(torch, fa, fd, ssd):
    """The benchmark's olmoe-train step outside the harness: one dropless
    MoE layer against the per-expert loop (`dropless_layer_vs_loop`, at
    the step's 8 x 2048 tokens), then `olmoe_published_cfg` at full width,
    bf16, remat "full", OLMOE_STEPS train steps of OLMOE_BATCH x OLMOE_SEQ
    tokens from seeded params, counts zeroed just before and read just
    after: per step, attention forward 2 and backward 1 a layer, the
    grouped GEMMs 6 forward (3, recomputed once) and 3 backward calls a
    layer (48 / 24), AdamW once a leaf (15), nothing else.  Losses finite, the
    first near ln(vocab).
    Then one more step under `torch.profiler` reduced as the benchmark
    reduces its traces (`perfbench.trace`): every trace name of
    `perfbench/kernels/expert_mm.json` and of `perfbench/kernels/adamw.json`
    must be there, or `expert_mm_roofline.train` or `adamw_roofline.train`
    would read nothing.  Prints step seconds, tokens/s, peak memory and the
    grouped GEMMs' and AdamW's device time with its bound.  Returns the timed
    steps' launches."""
    import gc

    from perfbench import readers
    from perfbench.kernels.expert_mm import cost
    from perfbench.trace import Stretch
    from repro_torch.models import init_params
    from repro_torch.training import AdamW, make_train_state, make_train_step, synthetic_batch

    gc.collect()
    torch.cuda.empty_cache()
    cfg = olmoe_published_cfg()
    dropless_layer_vs_loop(torch, cfg, OLMOE_BATCH * OLMOE_SEQ)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamW()
    state = make_train_state(init_params(cfg, seed=0, device="cuda"), opt)
    step = make_train_step(cfg, opt, microbatches=1)
    batch = synthetic_batch(cfg, OLMOE_BATCH, OLMOE_SEQ, device="cuda")
    torch.cuda.synchronize()
    counters = _zeroed_counters(fa, fd, ssd)
    losses, step_s = [], []
    for _ in range(OLMOE_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    per_step = train_launches(cfg, 1)
    print(json.dumps({"olmoe_train": {"step_seconds": step_s, "losses": losses,
                                      "tokens_per_s": OLMOE_BATCH * OLMOE_SEQ / min(step_s[1:]),
                                      "max_memory_allocated": peak},
                      "launches": launches}), flush=True)
    _expect_launches(launches, "olmoe published train",
                     **{k: OLMOE_STEPS * n for k, n in per_step.items()})
    if not (all(math.isfinite(x) for x in losses) and abs(losses[0] - math.log(cfg.vocab)) < 1.5):
        raise AssertionError(f"losses {losses}: not finite, or the first far from "
                             f"ln {cfg.vocab} = {math.log(cfg.vocab):.2f}")
    with Stretch(torch.device("cuda")) as st:
        state, m = step(state, batch)
    kernel_s = st.reduce()["kernel_s"]
    names = readers.kernel_names("expert_mm")
    # the CUTLASS names share their first hundreds of characters: shown by index
    short = {n: n if len(n) <= 60 else f"cutlass_grouped_gemm_{i}"
             for i, n in enumerate(sorted(names))}
    missing = sorted(short[n] for n in names if n not in kernel_s)
    R = OLMOE_BATCH * OLMOE_SEQ * cfg.moe.top_k
    shape = (R, cfg.d_model, cfg.moe.d_expert, cfg.moe.n_experts, 2)
    bound_s = 0.0
    for count, (flops, nbytes) in ((per_step["expert_mm"], cost(*shape)),
                                   (per_step["expert_mm_bwd"], cost(*shape, backward=True))):
        bound_s += count * max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
    dev_s = sum(kernel_s.get(n, 0.0) for n in names)
    print(json.dumps({"olmoe_expert_mm": {
        "device_ms": 1e3 * dev_s, "bound_ms": 1e3 * bound_s,
        "roofline_pct": 100.0 * bound_s / dev_s if dev_s else None,
        "by_name_ms": {short[n]: 1e3 * kernel_s.get(n, 0.0) for n in sorted(names)},
        "step_device_ms": 1e3 * sum(kernel_s.values())}}), flush=True)
    if missing:
        raise AssertionError(f"a traced olmoe step ran none of {missing} "
                             "(perfbench/kernels/expert_mm.json): the grouped GEMMs go by other "
                             "names, and expert_mm_roofline.train would read nothing")
    from perfbench.kernels.adamw import cost as adamw_cost
    names = readers.kernel_names("adamw")
    adamw_s = sum(kernel_s.get(n, 0.0) for n in names)
    adamw_bound_s = adamw_cost(per_step["adamw_elems"], 2)[1] / HBM_BYTES_PER_S
    print(json.dumps({"olmoe_adamw": {
        "device_ms": 1e3 * adamw_s, "bound_ms": 1e3 * adamw_bound_s,
        "roofline_pct": 100.0 * adamw_bound_s / adamw_s if adamw_s else None,
        "by_name_ms": {n: 1e3 * kernel_s.get(n, 0.0) for n in sorted(names)}}}), flush=True)
    missing = sorted(n for n in names if n not in kernel_s)
    if missing:
        raise AssertionError(f"a traced olmoe step ran none of {missing} "
                             "(perfbench/kernels/adamw.json): adamw_roofline.train would read "
                             "nothing")
    del state, step, batch, m
    gc.collect()
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

    from repro_torch.configs.reduced import reduced
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
    rows.update(conv_kernel_cases(torch, clock))
    rows.update(expert_mm_kernel_cases(torch, clock))
    rows.update(adamw_kernel_cases(torch, clock))
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
    train_parity(torch, reduced("zamba2_1p2b"), steps=3)
    hybrid_serve_parity(torch)

    phase("7. full-width zamba2-1.2b train (bf16, 38 layers, 3 steps)")
    train_launches_seen, train_stats = full_width_train(torch, fa, ssd)

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

    phase(f"17. xLSTM parity (reduced xlstm-350m, f32 and bf16, cuda vs cpu; the mLSTM "
          f"scan at dh {XLSTM_SCAN['d']} against naive_mlstm)")
    xlstm_parity(torch, fa, fd, ssd)

    phase(f"18. full-width xlstm-350m serve (bf16, 24 layers, {XLSTM_BATCH} x "
          f"{XLSTM_PROMPT} prompt tokens, {XLSTM_NEW} new)")
    xlstm_serve_launches = full_width_xlstm_serve(torch, fa, fd, ssd)

    phase(f"19. full-width xlstm-350m train (bf16, 24 layers, {XLSTM_TRAIN_STEPS} steps of "
          f"{XLSTM_TRAIN_BATCH} x {XLSTM_TRAIN_SEQ}: the sequence cut from 2048, "
          "where a step passed 90 s)")
    xlstm_train_launches = full_width_xlstm_train(torch, fa, fd, ssd)

    phase("20. MLA parity (reduced deepseek-v2, f32 cuda vs cpu; bf16 MLA layers, reduced "
          "and at full width)")
    mla_parity(torch, fa, fd, ssd)

    phase(f"21. full-width deepseek-v2-236b serve (bf16, depth cut to {MLA_LAYERS} of 60 "
          f"layers: 60 are about 470 GB; {MLA_REQUESTS} x {MLA_PROMPT[0]}-{MLA_PROMPT[1]} "
          f"prompt tokens padded to {MLA_PROMPT[1]}, {MLA_NEW} new)")
    mla_serve_launches = full_width_mla_serve(torch, fa, fd, ssd)

    phase("22. VLM and audio parity (reduced internvl2-1b and seamless-m4t-medium, f32 and "
          "bf16, cuda vs cpu)")
    vlm_audio_parity(torch, fa, fd, ssd)

    phase(f"23. full-width internvl2-1b serve (bf16, 24 layers; the engine on "
          f"{VLM_REQUESTS} x {VLM_PROMPT[0]}-{VLM_PROMPT[1]} prompt tokens padded to "
          f"{VLM_PROMPT[1]}, and {VLM_PATCHES} patches + {VLM_PATCH_TEXT} text tokens; "
          f"{VLM_NEW} new, {VLM_MAX_SEQ} rows)")
    vlm_serve_launches = full_width_vlm_serve(torch, fa, fd, ssd)

    phase(f"24. full-width seamless-m4t-medium serve (bf16, 12 + 12 layers, {AUDIO_BATCH} x "
          f"1024 frames and {AUDIO_TEXT} text tokens, {AUDIO_NEW} new)")
    audio_serve_launches = full_width_audio_serve(torch, fa, fd, ssd)

    phase(f"25. full-width internvl2-1b and seamless-m4t-medium train (bf16, {TRAIN_STEPS} "
          f"steps of {TRAIN_BATCH} x ({VLM_PATCHES} + {VLM_TRAIN_SEQ}) and {TRAIN_BATCH} x "
          f"{AUDIO_TRAIN_SEQ} over 1024 frames)")
    vl_train_launches = full_width_vlm_audio_train(torch, fa, fd, ssd)

    phase("26. MLA train parity (reduced deepseek-v2: a train step f32 cuda vs cpu; bf16 "
          "MLA layers' gradients, reduced and at full width)")
    mla_train_parity(torch, fa, fd, ssd)

    phase(f"27. deepseek-v2-236b train (full width, {MLA_TRAIN_LAYERS} layers, bf16, one "
          f"microbatch, {MLA_TRAIN_STEPS} steps of {MLA_TRAIN_BATCH} x {MLA_TRAIN_SEQ})")
    mla_train_launches = full_width_mla_train(torch, fa, fd, ssd)

    phase(f"28. dry run (fake process group, fake tensors: deepseek-v2-236b train_4k at full "
          f"width, {DRYRUN_LAYERS} layers, on 16 x 16; reduced olmoe-1b-7b train on 4 x 2)")
    dry_run_cells(torch, fa, fd, ssd)

    phase("29. phase 7's cell on one NCCL rank under a 1 x 1 mesh (runtime/ranks.py, "
          "launch/train.py --mesh 1x1)")
    mesh_train_launches = mesh_train(torch, fa, fd, ssd, train_launches_seen, train_stats)

    phase(f"30. olmoe-1b-7b-0924 as published (QK-norm, dropless, ungated top-8; full width, "
          f"{OLMOE_LAYERS} layers, bf16, {OLMOE_STEPS} steps of {OLMOE_BATCH} x {OLMOE_SEQ})")
    olmoe_train_launches = olmoe_published_train(torch, fa, fd, ssd)

    phase("8. kernels")
    main_shape = {
        "flash_attention": ("bfloat16", dict(B=8, S=512, H=32, K=8, D=128)),
        "flash_decode": ("bfloat16", dict(B=8, S=1024, H=32, K=8, D=128, vlen=513)),
        "ssd_scan": ("bfloat16", dict(b=2, s=2048, h=64, p=64, n=64, chunk=256)),
        "ssd_scan_final_state": ("bfloat16", dict(b=HYBRID_BATCH, s=HYBRID_PROMPT, h=64,
                                                  p=64, n=64, chunk=256)),
        "ssd_scan_bwd": ("bfloat16", dict(b=2, s=2048, h=64, p=64, n=64, chunk=256)),
        "flash_attention_bwd": ("bfloat16", dict(B=2, S=2048, H=32, K=32, D=64)),
        "flash_attention_mla": ("bfloat16", dict(MLA_ATTN, B=MLA_REQUESTS, S=MLA_PROMPT[1])),
        "flash_attention_bwd_mla": ("bfloat16", dict(MLA_ATTN, B=MLA_TRAIN_BATCH,
                                                     S=MLA_TRAIN_SEQ)),
        "causal_conv": ("bfloat16", CONV_SHAPES[0]),
        "causal_conv_bwd": ("bfloat16", CONV_SHAPES[0]),
        "expert_mm": ("bfloat16", EXPERT_MM_SHAPES[0]),
        "expert_mm_bwd": ("bfloat16", EXPERT_MM_SHAPES[0]),
        "adamw": ("bfloat16", ADAMW_CASES[0]),
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
        "flash_attention_mla": (csrc + "flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:85"),
        "flash_attention_bwd_mla": (csrc + "flash_attention_bwd.cu",
                                    "src/repro/kernels/flash_attention.py:85"),
        "causal_conv": (csrc + "causal_conv.cu",
                        "none: the jnp `_causal_conv` + silu, src/repro/models/ssm.py:57"),
        "causal_conv_bwd": (csrc + "causal_conv.cu",
                            "none: autodiff of src/repro/models/ssm.py:57"),
        "expert_mm": ("src/repro_torch/kernels/expert_mm.py: torch._grouped_mm",
                      "none: the reference has no dropless MoE"),
        "expert_mm_bwd": ("src/repro_torch/kernels/expert_mm.py: torch._grouped_mm",
                          "none: the reference has no dropless MoE"),
        "adamw": (csrc + "adamw.cu",
                  "none: the reference's AdamW is jnp, src/repro/training/optimizer.py"),
    }
    kernels = []
    for name, (dtn, c) in main_shape.items():
        case = name.removesuffix("_mla")  # phase 3's row
        row = rows[(case, dtn, tuple(sorted(c.items())))]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train": train_launches_seen.get(name, 0),
                   "live": live_launches.get(name, 0),
                   "hybrid_serve": hybrid_launches[name],
                   "launchers": launcher_launches[name],
                   "moe_serve": moe_serve_launches[name],
                   "moe_train": moe_train_launches[name],
                   "campaigns": campaign_launches[name],
                   "xlstm_serve": xlstm_serve_launches[name],
                   "xlstm_train": xlstm_train_launches[name],
                   "mla_serve": mla_serve_launches[name],
                   "vlm_serve": vlm_serve_launches[name],
                   "audio_serve": audio_serve_launches[name],
                   "vlm_train": vl_train_launches["vlm"][name],
                   "audio_train": vl_train_launches["audio"][name],
                   "mla_train": mla_train_launches[name],
                   "mesh_train": mesh_train_launches[name],
                   "olmoe_train": olmoe_train_launches[name]}
        f32 = rows.get((case, "float32", tuple(sorted(c.items()))))
        kernels.append({"name": name, "route": "cuda", "source": meta[name][0],
                        "replaces": meta[name][1], "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        **{k: row[k] for k in ("max_abs_err", "ms", "host_ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms",
                                               "library")},
                        **({"max_abs_err_f32": f32["max_abs_err"]} if f32 else {})})
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
