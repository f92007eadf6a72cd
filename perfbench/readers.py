"""What the metric readers share: percentiles, peaks, rooflines, shares.

Each reader in `metrics/` reads the run's record (the dict a driver
fills) and returns a number, or None where the record holds nothing for it
(the harness then leaves the metric out).  A share of a peak or a roofline
is None, never 0, where nothing was measured.
"""
from __future__ import annotations

import importlib
import json
import math
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent


def peaks(rec: dict) -> Optional[dict]:
    """The data-sheet peaks of the card the run used, or None."""
    table = json.loads((BENCH_DIR / "peaks.json").read_text())
    return table.get(rec.get("device_kind"))


def p90(values: List[Optional[float]]) -> float:
    """Nearest-rank 90th percentile; None (a request never answered) ranks
    above every number and reads as infinite."""
    xs = sorted(math.inf if v is None else v for v in values)
    return xs[max(0, math.ceil(0.9 * len(xs)) - 1)]


def untraced(rec: dict, units: str) -> list:
    return [u for u in rec[units] if not u["traced"]]


def kernel_names(op: str) -> set:
    """The trace names of every implementation of op: the union of
    `kernels/<op>.json` and `kernels/<op>.<impl>.json`."""
    names = set()
    for f in [BENCH_DIR / "kernels" / f"{op}.json",
              *sorted((BENCH_DIR / "kernels").glob(f"{op}.*.json"))]:
        if f.exists():
            names.update(json.loads(f.read_text())["kernels"])
    return names


def roofline(rec: dict, op: str) -> Optional[float]:
    """Percent: the least time the card could take for the op's calls in
    the traced units (the larger of FLOPs over the bf16 peak and bytes over
    the HBM bandwidth, call by call) over the device time of its kernels."""
    tr, pk = rec.get("trace"), peaks(rec)
    if not tr or pk is None:
        return None
    mod = importlib.import_module(f"perfbench.kernels.{op}")
    t = sum(tr["kernel_s"].get(n, 0.0) for n in kernel_names(op))
    bound = 0.0
    for unit in tr["units"]:
        for count, flops, nbytes in mod.calls(rec["model"], unit,
                                              unit["launches"].get(mod.COUNTER, 0)):
            bound += count * max(flops / pk["bf16_flops_per_s"],
                                 nbytes / pk["hbm_bytes_per_s"])
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t


def idle_share(rec: dict) -> Optional[float]:
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def reference(rec: dict):
    return importlib.import_module(f"perfbench.reference.{rec['reference']}")


def serve_flops(rec: dict, batch: dict) -> float:
    """Model FLOPs of the real tokens of a served batch: each request's
    prompt (its logits once) and each decode step that served it a token,
    every token at its real context; pads count for nothing."""
    m, f = rec["model"], reference(rec).model_flops_per_token
    a, b = f(m, 0, False), f(m, 1, False) - f(m, 0, False)
    logits = f(m, 0, True) - a
    total = 0.0
    for p, n in zip(batch["prompts"], batch["outs"]):
        total += p * a + b * p * (p + 1) / 2 + logits
        total += (n - 1) * (a + logits) + b * sum(p + j for j in range(1, n))
    return total


def mfu_serve(rec: dict) -> Optional[float]:
    pk = peaks(rec)
    bs = untraced(rec, "batches")
    busy = sum(b["dur_s"] for b in bs)
    if pk is None or busy <= 0:
        return None
    return 100.0 * sum(serve_flops(rec, b) for b in bs) / (busy * pk["bf16_flops_per_s"])


def mfu_train(rec: dict) -> Optional[float]:
    pk = peaks(rec)
    steps = untraced(rec, "steps")
    busy = sum(s["s"] for s in steps)
    if pk is None or busy <= 0:
        return None
    per_token = reference(rec).model_flops_per_token(rec["model"], rec["seq"])
    return 100.0 * len(steps) * rec["tokens_per_step"] * per_token / (
        busy * pk["bf16_flops_per_s"])
