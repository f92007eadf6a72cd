"""Sweeps on the card: batched torch ports of the decision kernels.

The numpy kernels in :mod:`repro_torch.core.decision` are the bit-for-bit
references; this module recasts each of them as a **fixed-shape padded**
row-wise kernel over ``(N, P)`` tensors (mask-padded est-end/size arrays,
``torch.where`` sentinels instead of ragged inputs): one row is one
captured decision, and no Python loop runs over rows.
:func:`run_device_sweep` replays every decision a whole `Experiment` grid
captured (see :func:`repro_torch.core.decision.capture`) as **one call**
of :func:`_sweep_program` evaluating every captured decision of every
cell, and parity-checks the outputs against the recorded numpy results.
Process fan-out stays the identity baseline: the numbers the sweep
reports come from the numpy engine, the device program must reproduce
its decisions job for job.

Numerical contract:

* ``dtype="float64"`` (the default, and the parity gate): inputs are
  float64/int64 and every kernel is **exactly** equal to its numpy
  reference — the same IEEE expressions over the same operands,
  including stable sort order and subnormal inputs (nothing here flushes
  denormals to zero).
* ``dtype="float32"``: inputs round to float32/int32.  Continuous
  outputs (``t_shadow``) agree within ``FLOAT32_RTOL``; discrete
  outputs (victim sets, sheds, filter masks) may legitimately differ
  where rounding crosses a comparison or reorders a sort, but the
  structural invariants still hold (sheds sum exactly to ``need`` and
  respect per-job slack; victim prefixes cover ``need``).

Padding contract: valid entries occupy a prefix of each row, the mask
marks them, and padded lanes carry identity sentinels (size 0,
est-end/overhead/need ``+inf``) that cannot alter a cumsum, win a sort
tie against a valid lane, or pass a filter.  ``+inf`` need_mins
(on-demand jobs) are fine — they are compared, never summed.

The whole grid runs without a host sync except the apportion loops:
each round of largest-remainder growing or shrinking reads once whether
any row still has a shortfall.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .decision import DecisionTrace

#: documented float32 tolerance for continuous outputs (t_shadow): the
#: selected release time is one of the float32-rounded inputs, so it can
#: differ from the float64 pick by at most ~1 ulp of the input scale —
#: unless two releases are closer than that, in which case either is a
#: correct answer and the parity suite only checks feasibility.
FLOAT32_RTOL = 1e-6


def _dtypes(dtype: str):
    """The (float, int) numpy dtypes of a mode's inputs."""
    if dtype == "float64":
        return np.float64, np.int64
    if dtype == "float32":
        return np.float32, np.int32
    raise ValueError(f"dtype must be 'float64' or 'float32', got {dtype!r}")


def check_device(device) -> torch.device:
    """The replay's torch device; a CUDA device on a host without a card
    raises (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to replay the decision sweep on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------- kernels
# Row-wise over (N, P) tensors; each mirrors the numpy reference
# expression-for-expression.  Comments call out only where the padding or
# torch's typing changes the derivation.

def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1, stable=True).indices


def _easy_shadow_kernel(avail, need, bases, sizes, valid, now):
    P = bases.shape[1]
    inf = float("inf")   # scalars ride along as kernel arguments: no copy
    ends = torch.where(valid, torch.maximum(bases, now[:, None]), inf)
    szs = torch.where(valid, sizes, 0)
    # np.lexsort((szs, ends)): stable by size, then stable by end.  The
    # size key of a padded lane is the dtype's max, so padding sorts after
    # every valid lane even where a valid end is +inf
    size_key = torch.where(valid, sizes, torch.iinfo(sizes.dtype).max)
    by_size = _stable_argsort(size_key)
    order = torch.gather(by_size, 1,
                         _stable_argsort(torch.gather(ends, 1, by_size)))
    ends_s = torch.gather(ends, 1, order)
    csum = avail[:, None] + torch.cumsum(torch.gather(szs, 1, order), 1,
                                         dtype=szs.dtype)
    i = torch.searchsorted(csum, need[:, None])
    # padded lanes keep csum at the total supply, so a crossing (if any)
    # happens at a valid lane: i < n_valid <=> the numpy i < len(csum)
    found = i[:, 0] < valid.sum(1)
    ic = torch.clamp(i, 0, P - 1)
    covered_now = avail >= need
    t = torch.where(covered_now, now,
                    torch.where(found, torch.gather(ends_s, 1, ic)[:, 0], inf))
    extra = torch.where(covered_now, avail - need,
                        torch.where(found, torch.gather(csum, 1, ic)[:, 0] - need,
                                    0))
    return t, extra


def _victims_kernel(sizes, overheads, valid, need):
    P = sizes.shape[1]
    szs = torch.where(valid, sizes, 0)
    over = torch.where(valid, overheads, float("inf"))
    order = _stable_argsort(over)
    csum = torch.cumsum(torch.gather(szs, 1, order), 1, dtype=szs.dtype)
    supply = csum[:, P - 1]
    cut = torch.searchsorted(csum, need[:, None])[:, 0] + 1
    ok = (need > 0) & (supply >= need)
    k = torch.where(ok, cut, 0)
    at = torch.clamp(cut - 1, 0, P - 1)[:, None]
    surplus = torch.where(ok, torch.gather(csum, 1, at)[:, 0] - need, 0)
    return order, k, surplus


def _apportion_kernel(cur, mn, valid, need, stats: Optional[dict] = None):
    P = cur.shape[1]
    idt = cur.dtype
    fdt = torch.float64 if idt == torch.int64 else torch.float32
    slack = torch.where(valid, torch.clamp(cur - mn, min=0), 0)
    supply = slack.sum(1, dtype=idt)
    ok = (supply >= need) & (need > 0)
    supply_s = torch.where(supply > 0, supply, 1)
    # mirror the numpy overflow guard: the exact-product expression is
    # bit-identical whenever need * max(slack) fits the int dtype; the
    # wrapped product computed on the overflow branch is discarded.
    # Integer true division goes through the mode's float dtype
    # explicitly: torch would otherwise divide into its default float32
    top = slack.max(1).values
    max_slack = torch.clamp(top, min=1)
    imax = torch.iinfo(idt).max
    overflow = (top > 0) & (need > imax // max_slack)
    need_c = need[:, None]
    quota = torch.where(
        overflow[:, None],
        need_c.to(fdt) * (slack.to(fdt) / supply_s[:, None].to(fdt)),
        (need_c * slack).to(fdt) / supply_s[:, None].to(fdt))
    base = torch.minimum(torch.clamp(torch.floor(quota).to(idt), min=0), slack)
    base = torch.where(ok[:, None], base, 0)
    short0 = torch.where(ok, need - base.sum(1, dtype=idt), 0)
    lanes = torch.arange(P, device=cur.device)

    # largest-remainder rounds, one node per eligible job per round — the
    # same iteration the hardened numpy reference runs.  A row whose loop
    # condition is false has a take <= 0, which selects no lane, so its
    # base stays (under vmap the reference keeps its carry); each round
    # reads the condition once on the host
    short, grow_rounds = short0, 0
    while bool((short > 0).any()):
        grow_rounds += 1
        eligible = slack > base
        frac = torch.where(eligible, quota - base, -float("inf"))
        order = _stable_argsort(-frac)
        take = torch.minimum(short, eligible.sum(1, dtype=idt))
        inc = (lanes < take[:, None]).to(idt)
        base = base.scatter_add(1, order, inc)
        short = short - take

    # float32 only: rounded-up quotas can overshoot (floor lands above the
    # exact float64 floor), leaving short0 < 0; retract from the most
    # over-granted jobs so the sum is exact in every dtype
    short, shrink_rounds = short0, 0
    while bool((short < 0).any()):
        shrink_rounds += 1
        granted = base > 0
        frac = torch.where(granted, quota - base, float("inf"))
        order = _stable_argsort(frac)
        take = torch.minimum(-short, granted.sum(1, dtype=idt))
        dec = (lanes < take[:, None]).to(idt)
        base = base.scatter_add(1, order, -dec)
        short = short + take
    if stats is not None:
        stats["apportion_grow_rounds"] = grow_rounds
        stats["apportion_shrink_rounds"] = shrink_rounds
    return ok, base


def _prefilter_kernel(needs, valid, bound):
    return valid & (needs <= bound[:, None])


def _shadow_filter_kernel(needs_c, ests_c, valid, budget, now, t_shadow):
    return valid & ((needs_c <= budget[:, None])
                    | (now[:, None] + ests_c <= t_shadow[:, None]))


def _sweep_program(batches, stats: Optional[dict] = None):
    """The whole grid's decisions in one call.

    ``batches`` is a dict keyed by kernel name of dicts of tensors on one
    device (see :func:`_build_batches`).  Nothing here reads a result back
    to the host except the apportion loops' per-round condition.
    ``stats``, when given, receives the rounds each apportion loop ran."""
    out = {}
    if "easy_shadow" in batches:
        b = batches["easy_shadow"]
        out["easy_shadow"] = _easy_shadow_kernel(
            b["avail"], b["need"], b["bases"], b["sizes"], b["valid"],
            b["now"])
    if "select_preemption_victims" in batches:
        b = batches["select_preemption_victims"]
        out["select_preemption_victims"] = _victims_kernel(
            b["sizes"], b["overheads"], b["valid"], b["need"])
    if "apportion_shrink" in batches:
        b = batches["apportion_shrink"]
        out["apportion_shrink"] = _apportion_kernel(
            b["cur"], b["mn"], b["valid"], b["need"], stats)
    if "backfill_prefilter" in batches:
        b = batches["backfill_prefilter"]
        out["backfill_prefilter"] = _prefilter_kernel(
            b["needs"], b["valid"], b["bound"])
    if "backfill_shadow_filter" in batches:
        b = batches["backfill_shadow_filter"]
        out["backfill_shadow_filter"] = _shadow_filter_kernel(
            b["needs"], b["ests"], b["valid"], b["budget"], b["now"],
            b["t_shadow"])
    return out


def to_device(batches_np, device) -> dict:
    """numpy batches (from :func:`_build_batches`) as tensors on ``device``."""
    dev = torch.device(device)
    return {k: {name: torch.as_tensor(a).to(dev) for name, a in b.items()}
            for k, b in batches_np.items()}


def to_numpy(outs) -> dict:
    """Program outputs back on the host, as numpy arrays."""
    return {k: (tuple(t.cpu().numpy() for t in o) if isinstance(o, tuple)
                else o.cpu().numpy())
            for k, o in outs.items()}


# ------------------------------------------------- single-call wrappers
# Same signatures and return conventions as the numpy kernels, plus the
# torch device — these are what the parity suite drives directly.

def _pad(arr, P, fill, dt):
    a = np.asarray(arr, dtype=dt)
    out = np.full(P, fill, dtype=dt)
    out[:a.size] = a
    return out


def _row(x, dev, dt=None):
    """One decision's input as a batch of one: a scalar becomes shape (1,),
    a padded array shape (1, P)."""
    return torch.as_tensor(np.asarray(x, dtype=dt)[None]).to(dev)


def easy_shadow_torch(avail: int, need: int, est_end_bases, sizes,
                      now: float, dtype: str = "float64",
                      device="cuda") -> Tuple[float, int]:
    fdt, idt = _dtypes(dtype)
    dev = check_device(device)
    n = len(est_end_bases)
    P = max(n, 1)
    t, extra = _easy_shadow_kernel(
        _row(avail, dev, idt), _row(need, dev, idt),
        _row(_pad(est_end_bases, P, np.inf, fdt), dev),
        _row(_pad(sizes, P, 0, idt), dev),
        _row(np.arange(P) < n, dev), _row(now, dev, fdt))
    return float(t[0]), int(extra[0])


def select_preemption_victims_torch(sizes, overheads, need: int,
                                    dtype: str = "float64", device="cuda"
                                    ) -> Tuple[List[int], int]:
    fdt, idt = _dtypes(dtype)
    dev = check_device(device)
    n = len(sizes)
    P = max(n, 1)
    order, k, surplus = _victims_kernel(
        _row(_pad(sizes, P, 0, idt), dev),
        _row(_pad(overheads, P, np.inf, fdt), dev),
        _row(np.arange(P) < n, dev), _row(need, dev, idt))
    return ([int(i) for i in order[0, :int(k[0])].cpu().numpy()],
            int(surplus[0]))


def apportion_shrink_torch(cur_sizes, min_sizes, need: int,
                           dtype: str = "float64", device="cuda"
                           ) -> List[int]:
    _fdt, idt = _dtypes(dtype)
    dev = check_device(device)
    n = len(cur_sizes)
    P = max(n, 1)
    if need <= 0:
        return [0] * n
    ok, base = _apportion_kernel(
        _row(_pad(cur_sizes, P, 0, idt), dev),
        _row(_pad(min_sizes, P, 0, idt), dev),
        _row(np.arange(P) < n, dev), _row(need, dev, idt))
    if not bool(ok[0]):
        return []
    return [int(x) for x in base[0, :n].cpu().numpy()]


def backfill_prefilter_torch(need_mins, supply_bound: float,
                             dtype: str = "float64",
                             device="cuda") -> np.ndarray:
    fdt, _idt = _dtypes(dtype)
    dev = check_device(device)
    n = len(need_mins)
    P = max(n, 1)
    mask = _prefilter_kernel(_row(_pad(need_mins, P, np.inf, fdt), dev),
                             _row(np.arange(P) < n, dev),
                             _row(supply_bound, dev, fdt))
    return np.flatnonzero(mask[0, :n].cpu().numpy())


def backfill_shadow_filter_torch(need_mins, est_remainings, candidates,
                                 spare_budget: int, now: float,
                                 t_shadow: float, dtype: str = "float64",
                                 device="cuda") -> np.ndarray:
    fdt, idt = _dtypes(dtype)
    dev = check_device(device)
    cand = np.asarray(candidates)
    needs_c = np.asarray(need_mins, dtype=np.float64)[cand]
    ests_c = np.asarray(est_remainings, dtype=np.float64)[cand]
    n = cand.size
    P = max(n, 1)
    mask = _shadow_filter_kernel(
        _row(_pad(needs_c, P, np.inf, fdt), dev),
        _row(_pad(ests_c, P, np.inf, fdt), dev),
        _row(np.arange(P) < n, dev), _row(spare_budget, dev, idt),
        _row(now, dev, fdt), _row(t_shadow, dev, fdt))
    return cand[mask[0, :n].cpu().numpy()]


# --------------------------------------------- batched grid evaluation
@dataclass
class DeviceSweepReport:
    """What one batched device replay of a sweep grid proved."""

    n_cells: int
    n_calls: int
    calls_per_kernel: Dict[str, int]
    pad_per_kernel: Dict[str, int]
    n_dropped: int                      # calls beyond each cell's capture cap
    dtype: str
    parity_ok: bool
    #: (cell label, kernel, call index, expected, got) — first N only
    mismatches: List[tuple] = field(default_factory=list)
    n_mismatches: int = 0
    build_s: float = 0.0                # host-side padding/stacking
    compile_s: float = 0.0              # first program call (lazy CUDA init)
    device_s: float = 0.0               # fastest steady program call
    n_programs: int = 1                 # always 1: the whole grid is one call

    @property
    def device_us_per_call(self) -> float:
        return 1e6 * self.device_s / max(self.n_calls, 1)

    def summary(self) -> dict:
        return {"n_cells": self.n_cells, "n_calls": self.n_calls,
                "calls_per_kernel": dict(self.calls_per_kernel),
                "pad_per_kernel": dict(self.pad_per_kernel),
                "n_dropped": self.n_dropped, "dtype": self.dtype,
                "parity_ok": self.parity_ok,
                "n_mismatches": self.n_mismatches,
                "n_programs": self.n_programs,
                "build_s": round(self.build_s, 4),
                "compile_s": round(self.compile_s, 4),
                "device_s": round(self.device_s, 6),
                "device_us_per_call": round(self.device_us_per_call, 3)}


def _build_batches(cells: Sequence[Tuple[object, DecisionTrace]],
                   dtype: str):
    """Stack every captured call of every cell into per-kernel padded
    batches.  Returns (numpy batches, per-kernel index lists of
    (cell_label, call_idx, inputs, expected_output), per-kernel pads)."""
    fdt_np, idt_np = _dtypes(dtype)
    index: Dict[str, list] = {k: [] for k in DecisionTrace.KERNELS}
    for label, trace in cells:
        for kernel, calls in trace.calls.items():
            for ci, (inputs, output) in enumerate(calls):
                index[kernel].append((label, ci, inputs, output))
    batches: Dict[str, Dict[str, np.ndarray]] = {}
    pads: Dict[str, int] = {}

    def stack(rows, P, fill, dt):
        out = np.full((len(rows), P), fill, dtype=dt)
        for i, r in enumerate(rows):
            a = np.asarray(r, dtype=dt)
            out[i, :a.size] = a
        return out

    def masks(lens, P):
        return np.arange(P)[None, :] < np.asarray(lens)[:, None]

    rows = index["easy_shadow"]
    if rows:
        P = max(max(len(inp[2]) for _, _, inp, _ in rows), 1)
        pads["easy_shadow"] = P
        batches["easy_shadow"] = {
            "avail": np.asarray([inp[0] for _, _, inp, _ in rows], idt_np),
            "need": np.asarray([inp[1] for _, _, inp, _ in rows], idt_np),
            "bases": stack([inp[2] for _, _, inp, _ in rows], P, np.inf,
                           fdt_np),
            "sizes": stack([inp[3] for _, _, inp, _ in rows], P, 0, idt_np),
            "valid": masks([len(inp[2]) for _, _, inp, _ in rows], P),
            "now": np.asarray([inp[4] for _, _, inp, _ in rows], fdt_np)}
    rows = index["select_preemption_victims"]
    if rows:
        P = max(max(len(inp[0]) for _, _, inp, _ in rows), 1)
        pads["select_preemption_victims"] = P
        batches["select_preemption_victims"] = {
            "sizes": stack([inp[0] for _, _, inp, _ in rows], P, 0, idt_np),
            "overheads": stack([inp[1] for _, _, inp, _ in rows], P, np.inf,
                               fdt_np),
            "valid": masks([len(inp[0]) for _, _, inp, _ in rows], P),
            "need": np.asarray([inp[2] for _, _, inp, _ in rows], idt_np)}
    rows = index["apportion_shrink"]
    if rows:
        P = max(max(len(inp[0]) for _, _, inp, _ in rows), 1)
        pads["apportion_shrink"] = P
        batches["apportion_shrink"] = {
            "cur": stack([inp[0] for _, _, inp, _ in rows], P, 0, idt_np),
            "mn": stack([inp[1] for _, _, inp, _ in rows], P, 0, idt_np),
            "valid": masks([len(inp[0]) for _, _, inp, _ in rows], P),
            "need": np.asarray([inp[2] for _, _, inp, _ in rows], idt_np)}
    rows = index["backfill_prefilter"]
    if rows:
        P = max(max(len(inp[0]) for _, _, inp, _ in rows), 1)
        pads["backfill_prefilter"] = P
        batches["backfill_prefilter"] = {
            "needs": stack([inp[0] for _, _, inp, _ in rows], P, np.inf,
                           fdt_np),
            "valid": masks([len(inp[0]) for _, _, inp, _ in rows], P),
            "bound": np.asarray([inp[1] for _, _, inp, _ in rows], fdt_np)}
    rows = index["backfill_shadow_filter"]
    if rows:
        P = max(max(len(inp[0]) for _, _, inp, _ in rows), 1)
        pads["backfill_shadow_filter"] = P
        batches["backfill_shadow_filter"] = {
            "needs": stack([inp[0] for _, _, inp, _ in rows], P, np.inf,
                           fdt_np),
            "ests": stack([inp[1] for _, _, inp, _ in rows], P, np.inf,
                          fdt_np),
            "valid": masks([len(inp[0]) for _, _, inp, _ in rows], P),
            "budget": np.asarray([inp[3] for _, _, inp, _ in rows], idt_np),
            "now": np.asarray([inp[4] for _, _, inp, _ in rows], fdt_np),
            "t_shadow": np.asarray([inp[5] for _, _, inp, _ in rows],
                                   fdt_np)}
    return batches, index, pads


def _check_parity(kernel: str, rows, outs, exact: bool) -> List[tuple]:
    """Compare one kernel's device outputs to the recorded numpy outputs.
    ``exact`` (float64) demands equality; float32 checks the documented
    tolerance/invariants instead."""
    bad = []
    if kernel == "easy_shadow":
        t_b, extra_b = (np.asarray(o) for o in outs)
        for i, (label, ci, inp, expected) in enumerate(rows):
            t, extra = float(t_b[i]), int(extra_b[i])
            et, eextra = expected
            if exact:
                ok = (t == et or (np.isinf(t) and np.isinf(et))) \
                    and extra == eextra
            else:
                ok = (np.isinf(t) and np.isinf(et)) or \
                    (np.isfinite(t) and np.isfinite(et)
                     and abs(t - et) <= FLOAT32_RTOL * max(abs(et), 1.0))
            if not ok:
                bad.append((label, kernel, ci, expected, (t, extra)))
    elif kernel == "select_preemption_victims":
        order_b, k_b, surplus_b = (np.asarray(o) for o in outs)
        for i, (label, ci, inp, expected) in enumerate(rows):
            victims = [int(x) for x in order_b[i, :int(k_b[i])]]
            got = (victims, int(surplus_b[i]))
            if exact:
                ok = got == expected
            else:
                sizes, _over, need = inp
                covered = sum(int(sizes[v]) for v in victims) - got[1]
                ok = (not victims and not expected[0]) or \
                    (bool(victims) and covered == need)
            if not ok:
                bad.append((label, kernel, ci, expected, got))
    elif kernel == "apportion_shrink":
        ok_b, base_b = (np.asarray(o) for o in outs)
        for i, (label, ci, inp, expected) in enumerate(rows):
            cur, mn, need = inp
            n = len(cur)
            if need <= 0:
                got: List[int] = [0] * n
            elif not bool(ok_b[i]):
                got = []
            else:
                got = [int(x) for x in base_b[i, :n]]
            if exact:
                ok = got == expected
            else:
                slack = np.maximum(np.asarray(cur) - np.asarray(mn), 0)
                ok = (got == [] and expected == []) or \
                    (sum(got) == (need if need > 0 else 0)
                     and all(0 <= g <= s for g, s in zip(got, slack)))
            if not ok:
                bad.append((label, kernel, ci, expected, got))
    elif kernel == "backfill_prefilter":
        mask_b = np.asarray(outs)
        for i, (label, ci, inp, expected) in enumerate(rows):
            n = len(inp[0])
            got = np.flatnonzero(mask_b[i, :n])
            if not np.array_equal(got, expected):
                bad.append((label, kernel, ci, expected.tolist(),
                            got.tolist()))
    elif kernel == "backfill_shadow_filter":
        mask_b = np.asarray(outs)
        for i, (label, ci, inp, expected) in enumerate(rows):
            cand = inp[2]
            got = np.asarray(cand)[mask_b[i, :len(cand)]]
            if not np.array_equal(got, expected):
                bad.append((label, kernel, ci, expected.tolist(),
                            got.tolist()))
    return bad


def run_device_sweep(cells: Sequence[Tuple[object, DecisionTrace]],
                     dtype: str = "float64",
                     max_mismatches: int = 20,
                     repeats: int = 3,
                     device="cuda") -> DeviceSweepReport:
    """Replay every cell's captured decision stream as ONE program call on
    ``device`` and parity-check it against the recorded numpy outputs.

    ``cells`` is a sequence of (label, DecisionTrace); the float64 mode
    demands exact equality (the sweep gate), float32 checks the
    documented tolerance.  ``repeats`` re-runs the program and keeps the
    fastest call, each ending in a device synchronize, for ``device_s``;
    the host-to-device copy lies outside every timed window.
    """
    _dtypes(dtype)  # validate early
    dev = check_device(device)
    t0 = time.perf_counter()
    batches_np, index, pads = _build_batches(cells, dtype)
    n_calls = sum(len(v) for v in index.values())
    calls_per_kernel = {k: len(v) for k, v in index.items() if v}
    n_dropped = sum(sum(t.n_dropped.values()) for _, t in cells)
    build_s = time.perf_counter() - t0
    if not batches_np:
        return DeviceSweepReport(
            n_cells=len(cells), n_calls=0, calls_per_kernel={},
            pad_per_kernel={}, n_dropped=n_dropped, dtype=dtype,
            parity_ok=True, build_s=build_s, compile_s=0.0, device_s=0.0)
    batches = to_device(batches_np, dev)
    _sync(dev)
    t0 = time.perf_counter()
    outs = _sweep_program(batches)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    device_s = compile_s
    for _ in range(max(repeats - 1, 0)):
        t0 = time.perf_counter()
        outs = _sweep_program(batches)
        _sync(dev)
        device_s = min(device_s, time.perf_counter() - t0)
    outs = to_numpy(outs)
    mismatches: List[tuple] = []
    for kernel, rows in index.items():
        if rows:
            mismatches += _check_parity(kernel, rows, outs[kernel],
                                        exact=dtype == "float64")
    return DeviceSweepReport(
        n_cells=len(cells), n_calls=n_calls,
        calls_per_kernel=calls_per_kernel, pad_per_kernel=pads,
        n_dropped=n_dropped, dtype=dtype, parity_ok=not mismatches,
        mismatches=mismatches[:max_mismatches],
        n_mismatches=len(mismatches), build_s=build_s,
        compile_s=compile_s, device_s=device_s)
