"""Streaming O(1)-state accumulators (Welford mean/variance, P² quantile).

Split out of :mod:`repro.core.metrics` so the simulator itself can hold a
sketch (the streaming decision-latency p99) without importing the metrics
module — metrics imports the simulator, so the sketches must live below
both.  ``repro.core.metrics`` re-exports both classes; existing imports
keep working.

``P2Quantile.add`` is a named hot frame of the million-job replay profile
(benchmarks/bench_profile.py): a streaming sink feeds six sketches per
retired record, so the marker update below is unrolled and localized —
same arithmetic, same float operations, bit-identical estimates to the
straightforward transcription of Jain & Chlamtac (1985).
"""
from __future__ import annotations

from typing import List

import numpy as np


class Welford:
    """Numerically stable streaming mean/variance (Welford 1962)."""

    __slots__ = ("n", "mean", "_m2")

    def __init__(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self._m2 += delta * (x - self.mean)

    @property
    def variance(self) -> float:
        return self._m2 / self.n if self.n else float("nan")

    def result(self) -> float:
        return self.mean if self.n else float("nan")


class P2Quantile:
    """The P² streaming quantile estimator (Jain & Chlamtac 1985).

    Five markers track the running ``p``-quantile in O(1) memory; exact
    below five observations, approximate after (parabolic marker
    adjustment).  Accuracy is excellent for the mid quantiles and
    degrades gracefully in the tails — the docs carry the caveat.

    Marker positions stay *strictly increasing*: an adjustment moves a
    marker by ±1 only when the gap on that side exceeds 1, so every
    denominator below is at least 1 in magnitude and the classic P²
    divide-by-zero (implementations that let adjacent markers collide on
    duplicate-heavy streams) cannot occur.  The linear fallback keeps a
    defensive gap guard anyway — it costs nothing and turns a violated
    invariant into a no-op adjustment instead of a crash.
    """

    __slots__ = ("p", "_q", "_n", "_np", "_dn", "count")

    def __init__(self, p: float):
        assert 0.0 < p < 1.0
        self.p = p
        self.count = 0
        self._q: List[float] = []           # marker heights
        self._n = [0, 1, 2, 3, 4]           # marker positions (0-based)
        self._np = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]  # desired positions
        self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]

    def add(self, x: float) -> None:
        self.count += 1
        q = self._q
        if self.count <= 5:
            q.append(x)
            q.sort()
            return
        n = self._n
        # locate cell k, clamp the extremes, and bump the marker
        # positions above the cell (the loop pair of the textbook
        # transcription, unrolled: one comparison chain per sample)
        if x < q[2]:
            if x < q[0]:
                q[0] = x
                n[1] += 1; n[2] += 1; n[3] += 1; n[4] += 1  # noqa: E702
            elif x < q[1]:
                n[1] += 1; n[2] += 1; n[3] += 1; n[4] += 1  # noqa: E702
            else:
                n[2] += 1; n[3] += 1; n[4] += 1             # noqa: E702
        elif x < q[3]:
            n[3] += 1; n[4] += 1                            # noqa: E702
        else:
            if x >= q[4]:
                q[4] = x
            n[4] += 1
        np_, dn = self._np, self._dn
        np_[1] += dn[1]; np_[2] += dn[2]; np_[3] += dn[3]   # noqa: E702
        np_[4] += 1.0
        # adjust the three middle markers toward their desired positions
        for i in (1, 2, 3):
            d = np_[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or \
                    (d <= -1 and n[i - 1] - n[i] < -1):
                d = 1 if d > 0 else -1
                # parabolic (P²) candidate, linear fallback
                qi = q[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (q[i + 1] - q[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1])
                    / (n[i] - n[i - 1]))
                if not q[i - 1] < qi < q[i + 1]:
                    gap = n[i + d] - n[i]
                    if gap == 0:  # unreachable per the invariant; defensive
                        continue
                    qi = q[i] + d * (q[i + d] - q[i]) / gap
                q[i] = qi
                n[i] += d

    def result(self) -> float:
        if self.count == 0:
            return float("nan")
        if self.count <= 5:
            return float(np.percentile(np.asarray(self._q), self.p * 100))
        return self._q[2]
