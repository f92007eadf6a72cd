"""The benchmark's frame: what a run reads, checks and prints.

`main` runs one cell of `BENCHMARK.json` from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name.  A cell names its configuration (the file
`BENCHMARK.json` gives it, holding the sizes, the program's config module and
the reference module) and its traffic mix (`traffic/<mix>.json`, whose
`driver` names the module under `drivers/` that runs it); its limits are
`limits/<cell>.json`; each metric is read by `metrics/<metric>.py`; each
kernel operation's work and trace names are `kernels/<op>.py` and
`kernels/<op>*.json`.  A cell not yet proven stands in `pending.json`.
The drivers are the only code that imports the
program (`repro_torch`, from `src/`); nothing here imports JAX or the JAX
package, and the run fails if either is loaded once its window has closed.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR":
              "build/torch_extensions", "CUDA_CACHE_PATH": "build/cuda_cache"}


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def pending() -> dict:
    """Cells built and tested on the CPU but not yet proven on the chip
    (`pending.json`, entries in `BENCHMARK.json`'s form, end-to-end metrics
    with no bound yet).  `cell` finds them by name, so `run.py`,
    `calibrate.py` and `sweep.py` take them; the benchmark's own checks see
    only `BENCHMARK.json`.  A benchmark change proves one and moves its
    entries over."""
    return json.loads((BENCH_DIR / "pending.json").read_text())


def load_file(path: Path, name: str):
    """A module from a file whose name may hold dots (`metrics/x.serve.py`)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return load_file(BENCH_DIR / "metrics" / f"{name}.py", f"perfbench_metric_{name}")


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN)


def assert_no_forbidden(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"{when}: modules of JAX or the JAX package are loaded: {found}")


def settle() -> None:
    """End of set-up: collect what set-up left and keep the survivors out of
    the collector's later passes, so that the window's collections are short
    and alike from run to run."""
    gc.collect()
    gc.freeze()


def prepare_environment() -> None:
    """The program on the path; every build and kernel cache at a fixed
    directory inside the checkout (the program's own kernel libraries
    already go to build/kernels there)."""
    for var, rel in CACHE_DIRS.items():
        os.environ.setdefault(var, str(ROOT / rel))
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


@dataclass
class Cell:
    """One entry of `workloads`, with everything it names, loaded."""
    name: str
    entry: dict
    config: dict            # the configuration's file
    mix: dict               # traffic/<mix>.json
    limits: dict            # limits/<cell>.json
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]   # ... and with --trace 1

    @property
    def model(self) -> dict:
        return self.config["model"]

    def reference(self):
        return importlib.import_module(f"perfbench.reference.{self.config['reference']}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    if name not in {w["name"] for w in bench["workloads"]}:
        extra = pending()
        bench = {k: bench[k] + extra.get(k, []) for k in
                 ("configs", "workloads", "end_to_end", "per_layer")}
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(entries)}")
    entry = entries[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())
    return Cell(name, entry, config, mix, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


@dataclass
class Run:
    """What a driver is handed, and what it fills in."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any                       # torch.device
    t_start: float                    # process start, time.perf_counter
    model: Optional[dict] = None      # sizes actually run (cell.model, or smaller in tests)
    rec: Dict[str, Any] = field(default_factory=dict)   # the run's record
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = {"value": value, "limit": limit}

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())


def program_config(run: Run):
    """The program's ModelConfig for this run: the configuration's module
    in `repro_torch.configs`, with the sizes the run uses.  Where the file
    runs a number other than the module's, it names that key under
    `differs_from_program`; any other difference is an error, so the
    program runs what the file states and nothing else."""
    from dataclasses import fields

    from repro_torch.configs import get_config
    from repro_torch.models.config import MoEConfig, SSMConfig
    m = run.model
    base = get_config(run.cell.config["program_config"])
    kw = {k: v for k, v in m.items() if k not in ("moe", "ssm")}
    if "moe" in m:
        kw["moe"] = MoEConfig(**m["moe"])
    if "ssm" in m:
        kw["ssm"] = SSMConfig(**m["ssm"])
    cfg = base.with_(**kw)
    if run.model is run.cell.model:
        differ = {f.name for f in fields(cfg) if getattr(cfg, f.name) != getattr(base, f.name)}
        named = set(run.cell.config.get("differs_from_program", {}))
        if differ != named:
            raise ValueError(f"{run.cell.config['program_config']}: the file runs "
                             f"{sorted(differ)} other than the program's config, and names "
                             f"{sorted(named)}")
    return cfg


def check_layout(params: dict, cfg) -> None:
    """The tree the benchmark made has the program's keys, shapes and
    dtypes (those of `init_params` on the meta device)."""
    from repro_torch.models import init_params

    from .weights import layout
    want, got = layout(init_params(cfg, device="meta")), layout(params)
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:6]
        raise ValueError(f"weights differ from the program's tree: {diff}")


def device_block(run: Run, peak: int) -> dict:
    import torch
    dev = run.device
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": peak}


def power_limit() -> Optional[str]:
    """`name, power.limit` as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def execute(run: Run) -> dict:
    """Drive the cell, read its metrics, and return the result line's
    object (checks last)."""
    driver = importlib.import_module(f"perfbench.drivers.{run.cell.mix['driver']}")
    run.model = run.model or run.cell.model
    attempted, failed, peak = driver.run(run)
    assert_no_forbidden("after the window")
    device = device_block(run, peak)
    run.rec["device_kind"] = device["kind"]
    wanted = run.cell.per_layer if run.trace else run.cell.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_reader(m["name"]).read(run.rec)
        if value is None:
            if not run.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": run.correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if run.trace and "trace" in run.rec:
        t = run.rec["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["card"] = run.rec.get("card")
    out["checks"] = run.checks
    return out


def summary(rec: dict) -> dict:
    """A few of the record's numbers, for a reader of standard error."""
    keys = ("setup_s", "check_s", "window_s", "judged_tokens", "max_logit_gap", "card",
            "left_out", "loss_gap", "grad_gap", "worst_grad_leaf", "worst_change_leaf")
    out = {k: rec[k] for k in keys if k in rec}
    if "batches" in rec:
        bs = rec["batches"]
        out.update(due=rec["due"], served=sum(b["B"] for b in bs), batches=len(bs),
                   mean_batch=sum(b["B"] for b in bs) / len(bs),
                   mean_padded=sum(b["S"] for b in bs) / len(bs),
                   last_done_s=max(b["t_call"] + b["dur_s"] for b in bs))
    if "steps" in rec:
        out.update(steps=len(rec["steps"]), step_s=[s["s"] for s in rec["steps"]])
    if "trace" in rec:
        out["trace_ops"] = rec["trace"]["n_device_ops"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    prepare_environment()
    c = cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.entry["chips"]:
        print(f"no result: the cell needs {c.entry['chips']} CUDA card(s), "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    run = Run(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
              t_start)
    out = execute(run)
    gc.collect()
    assert_no_forbidden("at exit")
    print("run: " + json.dumps(summary(run.rec)), file=sys.stderr)
    for name, chk in run.checks.items():
        print(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
