"""The one traffic generator: it reads a mix's data file and the run's seed.

A mix file (`traffic/<mix>.json`) names its `driver` and holds its
parameters.

`serve` mixes are open loops of `n = round(expected arrivals)` requests,
due over the window at the rate `rate_per_s`, raised `factor` times for
`for_s` seconds of every `every_s` where the mix has `bursts`.  Every
seed asks for the same set of sizes and gaps, in another order: the gaps
are the n + 1 quantiles of the unit exponential (a Poisson process's gaps,
stratified), the prompt and output lengths the n quantiles of their
distributions (`lognormal`: median, sigma in log space, clipped to [min,
max]; `uniform`: whole numbers on [min, max]), and the run's seed draws
the order of each of the three, and the prompt tokens.  The gaps are
scaled to fill the window and bent through the rate's profile, so the
load over the window is the same in every run and which request comes
when, with which lengths, is the seed's.  Runs with different seeds then
differ little more than runs of one seed do.

`train` mixes are a job's step stream: batch b of step i is the program's
documented synthetic stream (numpy's generator seeded with seed *
1,000,003 + i: a start token per row, then a walk of steps in [-32, 32],
folded into the vocabulary), drawn here again so that the reference is
handed the tokens without taking them from the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np


@dataclass
class Arrival:
    rid: int
    due_s: float          # seconds after the window opens
    prompt: np.ndarray    # (S,) int32
    max_new: int


def _levels(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _lengths(spec: dict, n: int) -> np.ndarray:
    """The n quantiles of a length distribution, in increasing order."""
    q = _levels(n)
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in q])
        x = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
        return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    if spec["dist"] == "uniform":
        lo, hi = spec["min"], spec["max"]
        return np.minimum(lo + np.floor(q * (hi - lo + 1)), hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _rate_profile(mix: dict, seconds: float):
    """(times, expected arrivals by each time) on a millisecond grid."""
    t = np.linspace(0.0, seconds, max(2, int(seconds * 1000) + 1))
    rate = np.full_like(t, mix["rate_per_s"])
    if "bursts" in mix:
        b = mix["bursts"]
        rate[np.mod(t, b["every_s"]) < b["for_s"]] *= b["factor"]
    lam = np.concatenate([[0.0], np.cumsum(0.5 * (rate[1:] + rate[:-1]) * np.diff(t))])
    return t, lam


def serve_schedule(mix: dict, seed: int, seconds: float, vocab: int) -> List[Arrival]:
    """The requests due in a window of `seconds`, in due order."""
    t, lam = _rate_profile(mix, seconds)
    n = max(1, int(round(lam[-1])))
    rng = np.random.default_rng(seed)
    gaps = -np.log1p(-_levels(n + 1))[rng.permutation(n + 1)]
    prompts = _lengths(mix["prompt"], n)[rng.permutation(n)]
    outs = _lengths(mix["output"], n)[rng.permutation(n)]
    due = np.interp(lam[-1] * np.cumsum(gaps)[:n] / gaps.sum(), lam, t)
    return [Arrival(i, float(due[i]),
                    rng.integers(0, vocab, size=int(prompts[i]), dtype=np.int32),
                    int(outs[i])) for i in range(n)]


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int):
    """(tokens, labels), each (batch, seq) int64, of step `step`."""
    rng = np.random.default_rng((seed * 1_000_003 + step) % (2 ** 63))
    base = rng.integers(0, vocab, size=(batch, 1), dtype=np.int64)
    drift = rng.integers(-32, 33, size=(batch, seq + 1), dtype=np.int64)
    toks = np.abs(base + np.cumsum(drift, axis=1)) % vocab
    return toks[:, :-1], toks[:, 1:]
