"""Vectorized decision kernels (paper §II-C "quick decision making").

The hot decisions — PAA victim selection, SPAA shrink apportionment, the
EASY shadow-window computation, and the backfill candidate prefilter —
are O(running jobs) / O(queue window) numpy operations so a full-system
decision stays well under the paper's 10 ms bound (Obs. 10) even on
month-scale traces; benchmarked in bench_decision.py.

These numpy kernels are the *bit-for-bit references* for the jitted JAX
ports in :mod:`repro.core.decision_jax` (sweeps-on-device; see
docs/performance.md).  The :func:`capture` context manager records every
kernel call's raw inputs and outputs into a :class:`DecisionTrace` so a
whole sweep cell's decision stream can be replayed — and parity-checked
— as one batched device program.  Capture is a single module-global
``None`` check per call when inactive (the hot path pays nothing).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


# ------------------------------------------------------- decision capture
class DecisionTrace:
    """Bounded per-kernel capture of decision calls (inputs + outputs).

    One trace records one simulation's decision stream: for each kernel a
    list of ``(inputs..., output)`` tuples, truncated at ``limit`` calls
    per kernel (a deterministic prefix — the device replay and its parity
    gate cover exactly the captured prefix).  Arrays are copied at record
    time so later caller-side mutation cannot corrupt the trace; traces
    are plain numpy + scalars, hence picklable across process fan-out.
    """

    KERNELS = ("easy_shadow", "select_preemption_victims",
               "apportion_shrink", "backfill_prefilter",
               "backfill_shadow_filter")

    def __init__(self, limit: int = 256):
        self.limit = limit
        self.calls: Dict[str, list] = {k: [] for k in self.KERNELS}
        self.n_dropped: Dict[str, int] = {k: 0 for k in self.KERNELS}

    def record(self, kernel: str, inputs: tuple, output) -> None:
        lst = self.calls[kernel]
        if len(lst) < self.limit:
            lst.append((inputs, output))
        else:
            self.n_dropped[kernel] += 1

    def n_calls(self) -> int:
        return sum(len(v) for v in self.calls.values())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        per = {k: len(v) for k, v in self.calls.items() if v}
        return f"<DecisionTrace {self.n_calls()} calls {per}>"


_ACTIVE_TRACE: Optional[DecisionTrace] = None


@contextmanager
def capture(limit: int = 256) -> Iterator[DecisionTrace]:
    """Record every decision-kernel call made inside the block.

    Nestable (the inner capture wins, the outer resumes after); used by
    ``Experiment(device=...)`` workers to ship each cell's decision
    stream back for batched on-device replay.
    """
    global _ACTIVE_TRACE
    prev, trace = _ACTIVE_TRACE, DecisionTrace(limit)
    _ACTIVE_TRACE = trace
    try:
        yield trace
    finally:
        _ACTIVE_TRACE = prev


def select_preemption_victims(
    sizes: Sequence[int],
    overheads: Sequence[float],
    need: int,
) -> Tuple[List[int], int]:
    """PAA victim selection.

    Sort candidates by ascending preemption overhead (node-seconds wasted)
    and take a prefix until the freed nodes cover `need`.

    Returns (victim indices in preemption order, surplus nodes beyond need).
    If the total supply cannot cover `need`, returns ([], 0) — the paper
    then queues the on-demand job at the front instead of preempting.
    """
    sizes_a = np.asarray(sizes, dtype=np.int64)
    over_a = np.asarray(overheads, dtype=np.float64)
    if sizes_a.sum() < need or need <= 0:
        out: Tuple[List[int], int] = ([], 0)
    else:
        order = np.argsort(over_a, kind="stable")
        csum = np.cumsum(sizes_a[order])
        cut = int(np.searchsorted(csum, need)) + 1
        victims = order[:cut]
        surplus = int(csum[cut - 1]) - need
        out = ([int(i) for i in victims], surplus)
    if _ACTIVE_TRACE is not None:
        _ACTIVE_TRACE.record("select_preemption_victims",
                             (sizes_a.copy(), over_a.copy(), int(need)), out)
    return out


def apportion_shrink(
    cur_sizes: Sequence[int],
    min_sizes: Sequence[int],
    need: int,
) -> List[int]:
    """SPAA: shrink running malleables "evenly" to free `need` nodes.

    Each job contributes proportionally to its shrinkable slack
    (cur - min), integerized by largest remainder so that the total equals
    `need` exactly.  Returns per-job nodes to shed; empty list if the slack
    cannot cover `need` (caller falls back to PAA, paper §III-B2).

    The largest-remainder pass is hardened two ways.  First, the
    historical quota expression ``need * slack / supply`` overflows the
    int64 product once ``need * max(slack)`` exceeds 2**63-1, wrapping
    into garbage quotas whose clamped floors leave a shortfall far
    larger than the number of jobs with remaining fractional slack —
    the old single top-`short` pass then promoted ``-inf`` entries past
    their per-job slack cap and tripped the sum assert.  The product is
    now guarded: the exact-product expression is kept bit-for-bit
    whenever it cannot overflow (every realistic node count), else the
    overflow-safe ``need * (slack / supply)`` is used.  Second, the
    rounding pass is iterative in both directions: each round hands one
    node to (or retracts one from) the ``min(|short|, eligible)``
    extreme remainders; supply >= need guarantees an eligible job
    exists while any shortfall remains, so the loops terminate with the
    sum exact.  For the common case (short <= eligible, no overflow)
    round one is bit-identical to the historical single pass.
    """
    cur = np.asarray(cur_sizes, dtype=np.int64)
    mn = np.asarray(min_sizes, dtype=np.int64)
    slack = np.maximum(cur - mn, 0)
    supply = int(slack.sum())
    if supply < need or need <= 0:
        out: List[int] = [] if need > 0 else [0] * len(cur)
        if _ACTIVE_TRACE is not None:
            _ACTIVE_TRACE.record("apportion_shrink",
                                 (cur.copy(), mn.copy(), int(need)), out)
        return out
    max_slack = int(slack.max())
    if max_slack > 0 and need > (2**63 - 1) // max_slack:
        quota = need * (slack / supply)
    else:
        quota = need * slack / supply
    base = np.clip(np.floor(quota).astype(np.int64), 0, slack)
    short = need - int(base.sum())
    while short > 0:
        eligible = slack > base
        frac = np.where(eligible, quota - base, -np.inf)
        # largest remainders get the leftover node each
        take = min(short, int(eligible.sum()))
        top = np.argsort(-frac, kind="stable")[:take]
        base[top] += 1
        short -= take
    while short < 0:
        # floats >= 2**53: floored quotas can overshoot need; retract
        # from the most over-granted jobs
        granted = base > 0
        frac = np.where(granted, quota - base, np.inf)
        take = min(-short, int(granted.sum()))
        bottom = np.argsort(frac, kind="stable")[:take]
        base[bottom] -= 1
        short += take
    assert int(base.sum()) == need and np.all(base <= slack)
    out = [int(x) for x in base]
    if _ACTIVE_TRACE is not None:
        _ACTIVE_TRACE.record("apportion_shrink",
                             (cur.copy(), mn.copy(), int(need)), out)
    return out


def easy_shadow(
    avail: int,
    need: int,
    est_end_bases: Sequence[float],
    sizes: Sequence[int],
    now: float,
) -> Tuple[float, int]:
    """EASY shadow window: when can the blocked queue head start?

    ``est_end_bases`` / ``sizes`` are the incrementally maintained
    per-running-job estimated-end bases (clamped to ``now`` here, exactly
    like ``Simulator._est_end``) and current sizes.  Accumulates releases
    in ascending (est_end, size) order — the order the legacy Python
    ``sorted()`` loop used — until ``avail`` covers ``need``.

    Returns ``(t_shadow, extra)``: the head's reservation start and the
    spare nodes at that moment.  ``(now, avail - need)`` when the
    already-free supply covers ``need`` with no release at all — in
    particular when the running set is empty, where the cumsum is empty
    and a bare ``searchsorted`` would walk off the end and misreport an
    immediately-startable head as ``(inf, 0)``.  ``(inf, 0)`` when the
    running set cannot ever cover the head (its kill-time estimates are
    finite, so this only happens for a head larger than the machine's
    usable pool).
    """
    if avail >= need:
        out = (float(now), int(avail) - int(need))
        if _ACTIVE_TRACE is not None:
            _ACTIVE_TRACE.record(
                "easy_shadow",
                (int(avail), int(need),
                 np.asarray(est_end_bases, dtype=np.float64).copy(),
                 np.asarray(sizes, dtype=np.int64).copy(), float(now)), out)
        return out
    ends = np.maximum(np.asarray(est_end_bases, dtype=np.float64), now)
    szs = np.asarray(sizes, dtype=np.int64)
    order = np.lexsort((szs, ends))
    csum = avail + np.cumsum(szs[order])
    i = int(np.searchsorted(csum, need))
    if i >= len(csum):
        out = (math.inf, 0)
    else:
        out = (float(ends[order[i]]), int(csum[i]) - need)
    if _ACTIVE_TRACE is not None:
        _ACTIVE_TRACE.record(
            "easy_shadow",
            (int(avail), int(need),
             np.asarray(est_end_bases, dtype=np.float64).copy(),
             np.asarray(sizes, dtype=np.int64).copy(), float(now)), out)
    return out


def backfill_prefilter(
    need_mins: Sequence[float],
    supply_bound: float,
) -> np.ndarray:
    """Stage-1 backfill prefilter: supply-feasible candidate indices.

    ``need_mins`` is the queue window's cached minimum start sizes
    (``inf`` for on-demand jobs, which never backfill); ``supply_bound``
    is an upper bound on any candidate's visible supply (free pool +
    every idle noticed reservation).  Supply only shrinks while the
    backfill loop starts jobs, so every index dropped here is one the
    legacy per-candidate scan would have ``continue``-d over.  An empty
    result lets the caller skip the shadow-window computation entirely.

    Candidates holding returned-lease nodes see more supply than the
    bound; the caller re-adds those few by hand (the hold book is
    per-job and tiny).
    """
    needs = np.asarray(need_mins, dtype=np.float64)
    out = np.flatnonzero(needs <= supply_bound)
    if _ACTIVE_TRACE is not None:
        _ACTIVE_TRACE.record("backfill_prefilter",
                             (needs.copy(), float(supply_bound)), out.copy())
    return out


def backfill_shadow_filter(
    need_mins: np.ndarray,
    est_remainings: np.ndarray,
    candidates: np.ndarray,
    spare_budget: int,
    now: float,
    t_shadow: float,
) -> np.ndarray:
    """Stage-2 backfill prefilter against the EASY shadow window.

    Applies only when there are no reservations to borrow from and only
    to candidates without returned-lease holds: such a candidate starts
    entirely from the free pool, so it must either fit the shadow hole
    at its fastest (full-size) estimate — ``est_remaining`` exactly, for
    rigid and malleable alike — or fit its minimum size inside the
    head's spare budget (``extra``); both bounds only tighten as the
    loop starts jobs, so dropped candidates are exactly legacy
    ``continue``-s.  Survivors then run the exact legacy checks.
    """
    needs = need_mins[candidates]
    ests = est_remainings[candidates]
    out = candidates[(needs <= spare_budget) | (now + ests <= t_shadow)]
    if _ACTIVE_TRACE is not None:
        _ACTIVE_TRACE.record(
            "backfill_shadow_filter",
            (np.asarray(needs, dtype=np.float64).copy(),
             np.asarray(ests, dtype=np.float64).copy(),
             np.asarray(candidates).copy(), int(spare_budget), float(now),
             float(t_shadow)), np.asarray(out).copy())
    return out


def expected_releases_before(
    est_ends: Sequence[float],
    sizes: Sequence[int],
    horizon: float,
) -> int:
    """CUP planning: nodes expected to free up before `horizon`."""
    ends = np.asarray(est_ends, dtype=np.float64)
    szs = np.asarray(sizes, dtype=np.int64)
    return int(szs[ends <= horizon].sum())
