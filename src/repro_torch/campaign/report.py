"""Regime reports: which mechanism wins under which workload regime.

The campaign runner streams one compact row per completed cell
(regime keys + mechanism + seed + metrics).  This module aggregates
those rows into the deliverable — per-regime winner tables with
bootstrap confidence intervals — rendered as markdown and JSON under
``results/campaigns/<name>/``.

Determinism contract: given the same rows, both artifacts are
**byte-identical** across runs and machines — no timestamps, sorted
JSON keys, fixed float formatting, and bootstrap resampling seeded
from a sha256 of the regime/mechanism/metric key rather than from
global RNG state.  The CI smoke and ``benchmarks --only campaign``
gate on exactly this property.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

#: metric -> (row key, better-direction, display label).  od-wait is
#: represented by the on-demand turnaround (wait dominates it for the
#: instant-start question the paper asks).
REPORT_METRICS: Tuple[Tuple[str, str, str], ...] = (
    ("avg_turnaround_od_h", "min", "od turnaround [h]"),
    ("avg_bounded_slowdown", "min", "bounded slowdown"),
    ("system_utilization", "max", "utilization"),
)

#: bootstrap resamples for the per-(regime, mechanism) CI
BOOTSTRAP_B = 200


def regime_key(regime: Mapping[str, object]) -> Tuple[Tuple[str, object], ...]:
    return tuple(sorted(regime.items()))


def _fmt(x: Optional[float], nd: int = 4) -> str:
    if x is None or (isinstance(x, float) and not np.isfinite(x)):
        return "nan"
    return f"{x:.{nd}f}"


def bootstrap_ci(values: Sequence[float], key: str,
                 b: int = BOOTSTRAP_B, alpha: float = 0.05
                 ) -> Tuple[float, float]:
    """Percentile bootstrap CI of the mean, deterministically seeded
    from ``key`` (so reports are byte-stable regardless of row arrival
    order or process count)."""
    vals = np.asarray([v for v in values if np.isfinite(v)], dtype=float)
    if vals.size == 0:
        return float("nan"), float("nan")
    if vals.size == 1:
        return float(vals[0]), float(vals[0])
    seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")
    rng = np.random.default_rng(seed)
    means = rng.choice(vals, size=(b, vals.size), replace=True).mean(axis=1)
    lo, hi = np.percentile(means, (100 * alpha / 2, 100 * (1 - alpha / 2)))
    return float(lo), float(hi)


def aggregate(rows: Sequence[Mapping]) -> List[dict]:
    """Collapse per-seed rows into per-(regime, mechanism) summaries.

    Each input row: ``{"regime": {...}, "mechanism": str, "seed": int,
    "metrics": {...}}``.  Output entries carry the mean, the seed
    count, and the bootstrap CI for every REPORT_METRICS metric, in a
    deterministic order (sorted regime key, then mechanism).
    """
    groups: Dict[tuple, Dict[str, List[Tuple[int, float]]]] = {}
    seeds: Dict[tuple, set] = {}
    for row in rows:
        k = (regime_key(row["regime"]), row["mechanism"])
        g = groups.setdefault(k, {m: [] for m, _d, _l in REPORT_METRICS})
        seeds.setdefault(k, set()).add(row["seed"])
        for m, _d, _l in REPORT_METRICS:
            v = row["metrics"].get(m)
            if v is not None:
                g[m].append((row["seed"], float(v)))
    out = []
    for (rkey, mech) in sorted(groups, key=lambda k: (repr(k[0]), k[1])):
        g = groups[(rkey, mech)]
        entry = {"regime": dict(rkey), "mechanism": mech,
                 "n_seeds": len(seeds[(rkey, mech)]), "metrics": {}}
        for m, _d, _l in REPORT_METRICS:
            # seed order, not arrival order: the CI resamples index into
            # this list and must not depend on pool completion order
            ordered = [v for _s, v in sorted(g[m])]
            vals = [v for v in ordered if np.isfinite(v)]
            ci_lo, ci_hi = bootstrap_ci(
                ordered, key=f"{rkey!r}|{mech}|{m}")
            entry["metrics"][m] = {
                "mean": float(np.mean(vals)) if vals else None,
                "ci_lo": None if not np.isfinite(ci_lo) else ci_lo,
                "ci_hi": None if not np.isfinite(ci_hi) else ci_hi,
                "n": len(vals)}
        out.append(entry)
    return out


def winners(aggregated: Sequence[Mapping]) -> List[dict]:
    """Per-regime winner per metric: the mechanism with the best mean;
    ``decisive`` marks wins whose CI does not overlap the runner-up's."""
    by_regime: Dict[tuple, List[Mapping]] = {}
    for e in aggregated:
        by_regime.setdefault(regime_key(e["regime"]), []).append(e)
    out = []
    for rkey in sorted(by_regime, key=repr):
        entries = by_regime[rkey]
        row = {"regime": dict(rkey), "winners": {}}
        for m, direction, _l in REPORT_METRICS:
            scored = [(e["mechanism"], e["metrics"][m]) for e in entries
                      if e["metrics"][m]["mean"] is not None]
            if not scored:
                row["winners"][m] = None
                continue
            sign = 1.0 if direction == "min" else -1.0
            # mechanism name breaks exact ties deterministically
            scored.sort(key=lambda t: (sign * t[1]["mean"], t[0]))
            best_name, best = scored[0]
            decisive = True
            if len(scored) > 1:
                _n2, second = scored[0][0], scored[1][1]
                if None in (best["ci_lo"], best["ci_hi"],
                            second["ci_lo"], second["ci_hi"]):
                    decisive = False
                elif direction == "min":
                    decisive = best["ci_hi"] < second["ci_lo"]
                else:
                    decisive = best["ci_lo"] > second["ci_hi"]
            row["winners"][m] = {"mechanism": best_name,
                                 "mean": best["mean"],
                                 "ci_lo": best["ci_lo"],
                                 "ci_hi": best["ci_hi"],
                                 "decisive": bool(decisive)}
        out.append(row)
    return out


def _regime_label(regime: Mapping[str, object]) -> str:
    parts = [str(regime.get("trace", "?"))]
    for k in sorted(regime):
        if k != "trace":
            v = regime[k]
            parts.append(f"{k}={v:g}" if isinstance(v, float) else
                         f"{k}={v}")
    return " ".join(parts)


def render_markdown(campaign: str, aggregated: Sequence[Mapping],
                    won: Sequence[Mapping], provenance: Mapping) -> str:
    """The human-readable report.  Deterministic bytes (no timestamps;
    provenance carries only stable identifiers)."""
    lines = [f"# Campaign report: {campaign}", ""]
    lines.append("Provenance: " + ", ".join(
        f"{k}={provenance[k]}" for k in sorted(provenance)))
    lines += ["", "## Winners by regime", ""]
    header = "| regime | " + " | ".join(
        label for _m, _d, label in REPORT_METRICS) + " |"
    lines.append(header)
    lines.append("|" + "---|" * (1 + len(REPORT_METRICS)))
    for row in won:
        cells = [_regime_label(row["regime"])]
        for m, _d, _l in REPORT_METRICS:
            w = row["winners"][m]
            if w is None:
                cells.append("—")
            else:
                mark = "**" if w["decisive"] else ""
                cells.append(
                    f"{mark}{w['mechanism']}{mark} "
                    f"({_fmt(w['mean'])} "
                    f"[{_fmt(w['ci_lo'])}, {_fmt(w['ci_hi'])}])")
        lines.append("| " + " | ".join(cells) + " |")
    lines += ["", "Bold winner: 95% bootstrap CI clear of the runner-up "
              f"(B={BOOTSTRAP_B}, seeded from the regime key).", "",
              "## Per-regime detail", ""]
    for row in won:
        rkey = regime_key(row["regime"])
        lines.append(f"### {_regime_label(row['regime'])}")
        lines.append("")
        lines.append("| mechanism | seeds | " + " | ".join(
            label for _m, _d, label in REPORT_METRICS) + " |")
        lines.append("|" + "---|" * (2 + len(REPORT_METRICS)))
        entries = [e for e in aggregated
                   if regime_key(e["regime"]) == rkey]
        for e in sorted(entries, key=lambda e: e["mechanism"]):
            cells = [e["mechanism"], str(e["n_seeds"])]
            for m, _d, _l in REPORT_METRICS:
                s = e["metrics"][m]
                cells.append(
                    "—" if s["mean"] is None else
                    f"{_fmt(s['mean'])} "
                    f"[{_fmt(s['ci_lo'])}, {_fmt(s['ci_hi'])}]")
            lines.append("| " + " | ".join(cells) + " |")
        lines.append("")
    return "\n".join(lines) + "\n"


def write_report(out_dir: str, campaign: str, rows: Sequence[Mapping],
                 provenance: Mapping) -> Dict[str, str]:
    """Aggregate ``rows`` and write the three artifacts; returns their
    paths.  rows.json preserves every per-seed row; report.json the
    aggregation + winners; report.md the rendered tables."""
    os.makedirs(out_dir, exist_ok=True)
    aggregated = aggregate(rows)
    won = winners(aggregated)
    paths = {
        "rows": os.path.join(out_dir, "rows.json"),
        "report_json": os.path.join(out_dir, "report.json"),
        "report_md": os.path.join(out_dir, "report.md"),
    }
    with open(paths["rows"], "w", encoding="utf-8") as f:
        json.dump({"campaign": campaign, "provenance": dict(provenance),
                   "rows": list(rows)}, f, indent=1, sort_keys=True)
        f.write("\n")
    with open(paths["report_json"], "w", encoding="utf-8") as f:
        json.dump({"campaign": campaign, "provenance": dict(provenance),
                   "aggregated": aggregated, "winners": won},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    with open(paths["report_md"], "w", encoding="utf-8") as f:
        f.write(render_markdown(campaign, aggregated, won, provenance))
    return paths
