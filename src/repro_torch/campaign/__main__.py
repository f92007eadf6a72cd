"""Campaign CLI::

    python -m repro_torch.campaign list
    python -m repro_torch.campaign fetch mini-steady kth-sp2
    python -m repro_torch.campaign run examples/campaigns/mini.toml
    python -m repro_torch.campaign report results/torch/campaigns/mini

``run`` is offline-first: zoo fixtures need no network, remote traces
resolve through the cache ($REPRO_TRACE_CACHE), and ``--offline``
(or $REPRO_OFFLINE) turns any would-be download into a clear error.
A killed run resumes from its checkpoint; ``--fresh`` discards it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core.workloads.base import WorkloadDataError

from .report import write_report
from .runner import run_campaign
from .spec import CampaignSpec, CampaignSpecError, default_output_dir
from .zoo import fetch, get_trace, is_cached, registered_traces


def _cmd_list(args) -> int:
    rows = []
    for name in registered_traces():
        spec = get_trace(name)
        rows.append((name,
                     "fixture" if spec.fixture else "remote",
                     "yes" if is_cached(name) else "no",
                     spec.license,
                     spec.description))
    widths = [max(len(r[i]) for r in rows + [_LIST_HEADER])
              for i in range(4)]
    for r in [_LIST_HEADER] + rows:
        print("  ".join(str(c).ljust(w) for c, w in zip(r, widths))
              + "  " + r[4])
    return 0


_LIST_HEADER = ("name", "kind", "cached", "license", "description")


def _cmd_fetch(args) -> int:
    rc = 0
    for name in args.traces:
        try:
            path = fetch(name, offline=args.offline or None,
                         cache=args.cache)
        except WorkloadDataError as e:
            print(f"fetch {name}: FAILED: {e}", file=sys.stderr)
            rc = 1
            continue
        print(f"fetch {name}: ok -> {path}")
    return rc


def _cmd_run(args) -> int:
    try:
        spec = CampaignSpec.load(args.spec)
    except (CampaignSpecError, OSError) as e:
        print(f"spec error: {e}", file=sys.stderr)
        return 2
    out_dir = args.out or default_output_dir(spec)
    print(f"campaign {spec.name}: {spec.n_cells} cells "
          f"({len(spec.traces)} trace(s) x {len(spec.mechanisms)} "
          f"mechanism(s) x {len(spec.seeds)} seed(s) x grid) -> {out_dir}")

    def progress(done, total, result):
        wl = result.spec.workload
        print(f"  [{done}/{total}] {wl.label} x {result.spec.mechanism} "
              f"seed={result.spec.seed} "
              f"({result.elapsed_s:.1f}s)" if result.elapsed_s else
              f"  [{done}/{total}] {wl.label} x {result.spec.mechanism} "
              f"seed={result.spec.seed} (restored)")

    try:
        paths = run_campaign(
            spec, out_dir=out_dir, offline=args.offline or None,
            resume=not args.fresh,
            processes=0 if args.serial else None,
            progress=progress if not args.quiet else None)
    except WorkloadDataError as e:
        print(f"campaign failed: {e}", file=sys.stderr)
        return 1
    for k in sorted(paths):
        print(f"wrote {paths[k]}")
    return 0


def _cmd_report(args) -> int:
    rows_path = args.rows
    if os.path.isdir(rows_path):
        rows_path = os.path.join(rows_path, "rows.json")
    try:
        with open(rows_path, encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"cannot read rows: {e}", file=sys.stderr)
        return 2
    out_dir = args.out or os.path.dirname(os.path.abspath(rows_path))
    paths = write_report(out_dir, payload.get("campaign", "campaign"),
                         payload["rows"], payload.get("provenance", {}))
    for k in sorted(paths):
        print(f"wrote {paths[k]}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.campaign",
        description="trace-zoo campaigns: declarative mechanism "
                    "robustness sweeps over real and fixture traces")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list zoo traces and cache state")

    p = sub.add_parser("fetch", help="fetch + verify traces into the cache")
    p.add_argument("traces", nargs="+")
    p.add_argument("--cache", default=None, help="cache dir override")
    p.add_argument("--offline", action="store_true",
                   help="fail instead of downloading")

    p = sub.add_parser("run", help="run a campaign spec end to end")
    p.add_argument("spec", help="path to a .toml or .json campaign spec")
    p.add_argument("--out", default=None,
                   help="output dir (default results/torch/campaigns/<name>)")
    p.add_argument("--offline", action="store_true")
    p.add_argument("--fresh", action="store_true",
                   help="discard any existing checkpoint")
    p.add_argument("--serial", action="store_true",
                   help="no process fan-out (deterministic single-proc)")
    p.add_argument("--quiet", action="store_true")

    p = sub.add_parser("report",
                       help="re-render report artifacts from rows.json")
    p.add_argument("rows", help="rows.json or a campaign output dir")
    p.add_argument("--out", default=None)

    args = ap.parse_args(argv)
    return {"list": _cmd_list, "fetch": _cmd_fetch,
            "run": _cmd_run, "report": _cmd_report}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
