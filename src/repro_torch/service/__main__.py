"""CLI: replay a workload scenario through the shadow scheduler service.

    python -m repro_torch.service --scenario bursty-od --n-jobs 80 \
        --mechanism "CUA&SPAA" --speed inf --log decisions.jsonl --fidelity

Prints the ShadowReport (or FidelityReport) as JSON; exits non-zero when
an SLO or the fidelity contract is violated, so the same invocation
works as a CI gate.  ``--speed 60`` replays at one simulated minute per
wall second (watchable); the default ``inf`` never sleeps.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

from repro_torch.core.workloads import get_scenario, registered_scenarios

from .daemon import SchedulerService, ServiceConfig, shadow_fidelity
from .launchers import DryrunLauncher
from .slo import SloPolicy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="Shadow-mode scheduler service replay.")
    ap.add_argument("--scenario", default="bursty-od",
                    help="workload preset (see --list-scenarios)")
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--n-jobs", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mechanism", default="CUA&SPAA")
    ap.add_argument("--queue-policy", default="EASY")
    ap.add_argument("--speed", default="inf",
                    help="sim-seconds per wall-second, or 'inf'")
    ap.add_argument("--log", default=None, metavar="PATH",
                    help="write the JSONL decision log here")
    ap.add_argument("--decision-p99-ms", type=float, default=10.0)
    ap.add_argument("--fidelity", action="store_true",
                    help="also run the offline reference and compare")
    args = ap.parse_args(argv)

    if args.list_scenarios:
        print("\n".join(registered_scenarios()))
        return 0

    scn = get_scenario(args.scenario, n_jobs=args.n_jobs)
    jobs, n_nodes = scn.realize(args.seed)
    cfg = ServiceConfig(
        n_nodes=n_nodes, mechanism=args.mechanism,
        queue_policy=args.queue_policy, speed=float(args.speed),
        decision_log_path=args.log,
        slo=SloPolicy(decision_p99_ms=args.decision_p99_ms))

    if args.fidelity:
        rep = shadow_fidelity(jobs, cfg)
        print(json.dumps(rep.as_dict(), indent=2, default=str))
        return 0 if (rep.ok and rep.service.ok) else 1

    svc = SchedulerService(cfg, jobs, launcher=DryrunLauncher(n_nodes))
    rep = svc.run_replay()
    print(json.dumps(rep.as_dict(), indent=2, default=str))
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
