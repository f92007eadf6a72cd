#!/usr/bin/env python3
"""Find the highest arrival rate a serving cell sustains: one engine, one
process, the cell's traffic at each rate in turn.  Not run by the
benchmark's runs; its answer is written into the mix's `rate_per_s`.

    python3 perfbench/sweep.py --workload <cell> --rates 2.5,3,3.5 [--seconds 40]

For each rate: the requests due, the batches, the p90 of TTFT and of
latency of the requests served, the requests due before the window closed
that were not served (the backlog at the close), and the mean TTFT of the
last third of the requests served against the first: a backlog that grows
shows as a ratio well over 1 and a backlog at the close.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness, readers, traffic  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch
    if not torch.cuda.is_available():
        print("sweep needs a CUDA card", file=sys.stderr)
        return 3
    from perfbench.drivers import serve
    c = harness.cell(args.workload)
    run = harness.Run(c, args.seed, args.seconds, False, torch.device("cuda", 0),
                      time.perf_counter(), model=c.model)
    _, _, engine, probe = serve.build(run)
    vocab = c.model["vocab"]
    for rate in (float(r) for r in args.rates.split(",")):
        arrivals = traffic.serve_schedule(dict(c.mix, rate_per_s=rate), args.seed, args.seconds,
                                          vocab)
        serve.warm(engine, c.mix, arrivals, vocab, args.seed)
        reqs, batches, window_s, _ = serve.serve_window(run, engine, probe, arrivals, drain=False)
        served = [r for b in batches for r in b["reqs"]]
        backlog = sum(1 for a in arrivals if a.due_s < args.seconds) - len(served)
        ttft = [r.first_token_at - r.submitted_at for r in served]
        lat = [r.done_at - r.submitted_at for r in served]
        third = max(1, len(served) // 3)
        print(json.dumps({
            "rate": rate, "requests": len(served), "batches": len(batches),
            "mean_batch": len(served) / max(1, len(batches)),
            "ttft_p90_ms": 1e3 * readers.p90(ttft), "latency_p90_ms": 1e3 * readers.p90(lat),
            "backlog_at_close": backlog,
            "late_over_early_ttft": (sum(ttft[-third:]) / third) / (sum(ttft[:third]) / third),
            "served_tok_s": sum(len(r.tokens_out) for r in served) / window_s,
            "busy_s": sum(b["dur_s"] for b in batches)}), flush=True)
    harness.assert_no_forbidden("sweep")
    return 0


if __name__ == "__main__":
    sys.exit(main())
