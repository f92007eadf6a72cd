"""On-demand serving: an open loop into `ServeEngine.serve_batch`.

Set-up makes the weights from the seed, builds the engine and serves two
warm-up batches (the most requests a batch takes at the schedule's longest
prompt, then one request at its shortest), which loads every kernel
library and grows the allocator to its peak.  The window then replays the
mix's schedule: each request is due at its time after the window opens
(its `submitted_at`), and whenever the engine is free the requests due by
then, first in first out and at most `max_batch` of them, go to one
`serve_batch`.  Every request falls due inside the window; those still
waiting when it closes are served after it, for at most `DRAIN_S` more
seconds, and their waits count in full.  A request never answered ranks
above every answered one in the tails, and counts as failed.

A probe around the engine's `decode_step` keeps the tokens each step is
fed (every row's, including rows whose request is done), so the reference
can route each decode step's batch exactly as the engine did.

The check, once every request is answered and the memory peak is read:
the batch with the longest prompt, and batches drawn from the seed until
at least `check_tokens` served tokens are in them, are run again by the
plain reference (its prefill over the padded batch, then its decode steps
fed the same tokens), and each token a request was served is judged by
how far its reference logit lies below the reference's best at that
position.  The number held to a limit is the 99th percentile of those
gaps: the widest gap swings with the rare routing flips of bfloat16 (one
token's k-th expert changes) and reads as high as the fp8 control's on
some seeds (PERF.md).
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import traffic, weights
from ..harness import Run, check_layout, power_limit, program_config
from ..reference.common import EXACT, Matmul, exact_matmuls
from ..trace import Stretch

DRAIN_S = 60.0   # how long past the close the window's last requests may wait


class Probe:
    """Keeps the token argument of every call of the wrapped function."""

    def __init__(self, fn):
        self.fn, self.fed = fn, []

    def __call__(self, params, cache, tokens, pos, cfg):
        self.fed.append(tokens)
        return self.fn(params, cache, tokens, pos, cfg)


def _launches():
    from repro_torch.kernels import launch_counts
    return launch_counts()


def build(run: Run):
    """(cfg, weights, engine, probe) of the run's configuration and seed."""
    from repro_torch.serving import engine as engine_mod
    cfg = program_config(run)
    params = weights.make(run.cell.reference().param_specs(run.model), run.seed, run.device)
    check_layout(params, cfg)
    if not isinstance(engine_mod.decode_step, Probe):
        engine_mod.decode_step = Probe(engine_mod.decode_step)
    engine = engine_mod.ServeEngine(cfg, params, max_seq=run.cell.mix["max_seq"],
                                    device=run.device)
    return cfg, params, engine, engine_mod.decode_step


def warm(engine, mix: dict, arrivals, vocab: int, seed: int) -> None:
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed + 1)
    longest = max(len(a.prompt) for a in arrivals)
    shortest = min(len(a.prompt) for a in arrivals)
    for n, S in ((min(mix["max_batch"], len(arrivals)), longest), (1, shortest)):
        engine.serve_batch([Request(i, rng.integers(0, vocab, S, dtype=np.int32), 2)
                            for i in range(n)])
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def serve_window(run: Run, engine, probe: Probe, arrivals, *, trace_at: float = None,
                 trace_units: int = 0, drain: bool = True):
    """Replay `arrivals` into the engine until the window closes and, with
    `drain`, until every request is served or `DRAIN_S` seconds more have
    passed; returns (every request, the batch records, the window's
    seconds, the profiled stretch or None).  Requests never handed to the
    engine have no first token."""
    from repro_torch.serving import Request
    mix = run.cell.mix
    t0 = time.monotonic()
    reqs = [Request(a.rid, a.prompt, a.max_new, submitted_at=t0 + a.due_s) for a in arrivals]
    close = t0 + run.seconds
    stop = close + DRAIN_S if drain else close
    batches: List[Dict] = []
    stretch, i, n = None, 0, len(reqs)
    while i < n:
        now = time.monotonic()
        if now >= stop:
            break
        if reqs[i].submitted_at > now:
            time.sleep(min(reqs[i].submitted_at, close) - now)
            continue
        j = i
        while j < n and j - i < mix["max_batch"] and reqs[j].submitted_at <= now:
            j += 1
        batch, i = reqs[i:j], j
        traced = (trace_at is not None and now - t0 >= trace_at * run.seconds
                  and (stretch is None or len(stretch.units) < trace_units))
        if traced and stretch is None:
            stretch = Stretch(run.device).__enter__()
        before = _launches() if traced else None
        probe.fed = []
        t_call = time.monotonic()
        engine.serve_batch(batch)
        t_done = time.monotonic()
        rec = {"B": len(batch), "S": max(len(r.prompt) for r in batch),
               "steps": len(engine.step_seconds), "t_call": t_call - t0,
               "prefill_s": batch[0].first_token_at - t_call, "dur_s": t_done - t_call,
               "step_s": list(engine.step_seconds), "traced": traced,
               "reqs": batch, "fed": probe.fed,
               "prompts": [len(r.prompt) for r in batch],
               "outs": [len(r.tokens_out) for r in batch]}
        batches.append(rec)
        if traced:
            after = _launches()
            stretch.units.append({"B": rec["B"], "S": rec["S"], "steps": rec["steps"],
                                  "launches": {k: after[k] - before[k] for k in after}})
            if len(stretch.units) == trace_units:
                stretch.__exit__(None, None, None)
    window_s = min(time.monotonic(), close) - t0
    if stretch is not None and stretch.wall_s is None:
        stretch.__exit__(None, None, None)
    probe.fed = []
    return reqs, batches, window_s, stretch


def judge(run: Run, params: dict, batch: Dict, control: bool = False) -> Dict:
    """Run the reference over one served batch.  Returns {"max_gap": the
    widest gap of a served token, "tokens": how many were judged,
    "fed_mismatch": decode inputs that were not the tokens served before,
    and with control the widest gap of the fp8 reference's own first
    choice at the same positions}."""
    ref = run.cell.reference()
    m = run.model
    reqs, S, steps = batch["reqs"], batch["S"], batch["steps"]
    toks = torch.zeros((len(reqs), S), dtype=torch.long)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = torch.from_numpy(r.prompt.astype(np.int64))
    toks = toks.to(run.device)
    fed = [t[:, 0].to(run.device) for t in batch["fed"]]
    rows = S + steps + 1
    out = {"max_gap": 0.0, "tokens": 0, "fed_mismatch": 0, "not_best": 0, "gaps": []}
    mms = {"exact": EXACT}
    if control:
        mms["fp8"] = Matmul(fp8=True)
        out["control_gap"], out["control_not_best"], out["control_gaps"] = 0.0, 0, []
    logits = {}
    with torch.no_grad():
        for key, mm in mms.items():
            lg, cache = ref.prefill(params, toks, m, rows, mm)
            seq = [lg]
            for j in range(1, steps + 1):
                seq.append(ref.decode_step(params, cache, fed[j - 1], S + j - 1, m, mm))
            logits[key] = seq
            del cache
    fed_host = torch.stack(fed).cpu().tolist() if fed else []
    for j in range(steps + 1):
        rows_j = [(i, r.tokens_out[j]) for i, r in enumerate(reqs) if j < len(r.tokens_out)]
        if not rows_j:
            continue
        idx = torch.tensor([i for i, _ in rows_j], device=run.device)
        tok = torch.tensor([t for _, t in rows_j], device=run.device)
        exact = logits["exact"][j][idx]
        best = exact.max(dim=-1).values
        at = torch.arange(len(idx), device=run.device)
        gaps = best - exact[at, tok]
        out["max_gap"] = max(out["max_gap"], float(gaps.max()))
        out["not_best"] += int((gaps > 0).sum())
        out["gaps"] += [(j, g) for g in gaps.tolist()]
        out["tokens"] += len(rows_j)
        if j >= 1:
            out["fed_mismatch"] += sum(fed_host[j - 1][i] != reqs[i].tokens_out[j - 1]
                                       for i, _ in rows_j)
        if control:
            pick = logits["fp8"][j][idx].argmax(dim=-1)
            cgaps = best - exact[at, pick]
            out["control_gap"] = max(out["control_gap"], float(cgaps.max()))
            out["control_not_best"] += int((cgaps > 0).sum())
            out["control_gaps"] += [(j, g) for g in cgaps.tolist()]
    return out


def pick_batches(batches: List[Dict], seed: int, tokens: int) -> List[Dict]:
    """The batch with the longest prompt, then batches drawn from the seed
    until the picked ones served at least `tokens` tokens (or all are)."""
    first = max(range(len(batches)), key=lambda b: (batches[b]["S"], -b))
    rest = [b for b in range(len(batches)) if b != first]
    rest = [rest[i] for i in np.random.default_rng(seed + 2).permutation(len(rest))]
    picked, n = [], 0
    for b in [first, *rest]:
        if n >= tokens:
            break
        picked.append(batches[b])
        n += sum(batches[b]["outs"])
    return picked


def gap_p99(readings: List[Dict]) -> float:
    """Nearest-rank 99th percentile of the judged tokens' gaps."""
    gaps = sorted(g for r in readings for _, g in r["gaps"])
    return gaps[max(0, math.ceil(0.99 * len(gaps)) - 1)]


def malformed(reqs, vocab: int) -> int:
    """Served requests answered with another number of tokens than asked,
    or a token outside the vocabulary."""
    return sum(1 for r in reqs if len(r.tokens_out) != r.max_new_tokens
               or any(not 0 <= t < vocab for t in r.tokens_out))


def run(run: Run):
    mix, m = run.cell.mix, run.model
    _, params, engine, probe = build(run)
    arrivals = traffic.serve_schedule(mix, run.seed, run.seconds, m["vocab"])
    warm(engine, mix, arrivals, m["vocab"], run.seed)
    from ..harness import assert_no_forbidden, settle
    assert_no_forbidden("after set-up")
    settle()
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    run.rec["setup_s"] = time.perf_counter() - run.t_start
    reqs, batches, window_s, stretch = serve_window(
        run, engine, probe, arrivals, trace_at=mix["trace_at"] if run.trace else None,
        trace_units=mix["trace_units"])
    peak = (torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda"
            else 0)
    served = [r for b in batches for r in b["reqs"]]
    bad = malformed(served, m["vocab"])
    run.rec.update(
        kind="serve", reference=run.cell.config["reference"], model=m, window_s=window_s,
        tokens=sum(len(r.tokens_out) for r in served), due=len(reqs),
        ttft_s=[_since(r.first_token_at, r) for r in reqs],
        latency_s=[_since(r.done_at, r) for r in reqs],
        batches=[{k: v for k, v in b.items() if k not in ("reqs", "fed")} for b in batches],
        card=power_limit() if run.device.type == "cuda" else None)
    if stretch is not None:
        run.rec["trace"] = stretch.reduce()
    del engine
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    exact_matmuls()
    t_check = time.perf_counter()
    readings = [judge(run, params, b) for b in pick_batches(batches, run.seed,
                                                               mix["check_tokens"])]
    run.check("malformed", bad, 0)
    run.check("fed_mismatch", sum(r["fed_mismatch"] for r in readings), 0)
    run.check("logit_gap_p99", gap_p99(readings), run.cell.limits["logit_gap_p99"])
    run.rec["judged_tokens"] = sum(r["tokens"] for r in readings)
    run.rec["max_logit_gap"] = max(r["max_gap"] for r in readings)
    run.rec["check_s"] = time.perf_counter() - t_check
    return len(reqs), bad + len(reqs) - len(served), peak


def _since(t, req):
    """Seconds from the request's due time to t, None if t never came."""
    return None if t is None else t - req.submitted_at
