"""A malleable training job: `LiveCluster.step_all` driving one `ElasticJob`.

Set-up makes the weights from the seed, hands them to one `ElasticJob`
(batch and sequence from the mix, its own data stream from the seed, no
checkpoint directory), submits it to a `LiveCluster` of `slots` slots that
all name the card with a target no window reaches, and drives it through
its first `check_steps` steps with `step_all(1)`, the window's own call.
Those steps warm every shape, and on them the program's numbers are read
as the optimizer keeps them: each step's loss, each leaf's first gradient
(worked out from the first moment after step 1, m / (1 - b1)), each leaf's
change after the last of them (before the next step overwrites it).  The
window then calls `step_all(1)` back to back, and ends with the first step
that finishes `seconds` after it opened; its rate is every token of those
steps over its whole length.

The check, once the window has closed, the peak is read and the job's
state is freed: the plain reference draws the same weights from the seed
again, takes the same batches (`traffic.train_batch`), runs as many AdamW
steps, and the three numbers are compared by the worst leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the gradient and change comparisons: they move by round-off alone.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from .. import traffic, weights
from ..harness import (Run, assert_no_forbidden, check_layout, power_limit, program_config,
                       settle)
from ..reference.common import EXACT, exact_matmuls, leaf_gaps, leaves, norms
from ..trace import Stretch

NEGLIGIBLE = 1e-3   # a leaf's reference gradient against the median leaf's
# The numbers held to limits (PERF.md gives the readings they were set
# from): the first gradient by the worst leaf's relative error as a tensor,
# ||g - g_ref|| / ||g_ref||, and the change after the first steps by the
# worst leaf's norm gap.  The gap of the gradient's norms is not held: at
# initialisation a leaf's norm barely sees the precision or the data (the
# fp8 control and half a batch move it less than bfloat16 does).  Nor is
# each step's loss: no control or fault reads three times sound runs.
CHECKED = ("grad_worst_leaf_err", "change_gap")


def build(run: Run):
    """(cluster, job, the weights' leaves as made)."""
    from repro_torch.runtime import LiveCluster
    from repro_torch.runtime.elastic import ElasticJob
    from repro_torch.training import AdamW, make_train_state
    mix = run.cell.mix
    cfg = program_config(run)
    params = weights.make(run.cell.reference().param_specs(run.model), run.seed, run.device)
    check_layout(params, cfg)
    opt = AdamW(**mix["optimizer"])
    job = ElasticJob(0, cfg, kind=mix["kind"], batch=mix["batch"], seq=mix["seq"],
                     opt=opt, seed=run.seed)
    job.state = make_train_state(params, opt)
    cluster = LiveCluster([run.device] * mix["slots"])
    cluster.submit(job, min_nodes=1, max_nodes=mix["slots"], target_steps=mix["target_steps"])
    return cluster, job, params


def first_steps(run: Run, cluster, job, params) -> Dict:
    """Drive the job through its first check_steps steps; the program's
    numbers from them."""
    b1 = run.cell.mix["optimizer"]["b1"]
    p0 = {k: t.clone() for k, t in leaves(params)}
    cluster.step_all(1)
    # the first gradient as the update took it, kept in host memory
    grad_t = {k: (t / (1 - b1)).cpu() for k, t in leaves(job.state.opt.m)}
    grad = {k: float(t.norm()) for k, t in grad_t.items()}
    for _ in range(run.cell.mix["check_steps"] - 1):
        cluster.step_all(1)
    change = {k: float((t.float() - p0[k].float()).norm()) for k, t in leaves(params)}
    return {"losses": list(job.losses), "grad": grad, "grad_t": grad_t, "change": change}


def reference_readings(run: Run, mm=EXACT, half_batch: bool = False) -> Dict:
    """The reference's numbers over the job's first check_steps batches
    (with half_batch, over each batch's first half of rows alone: the fault
    a training cell must catch)."""
    mix, m = run.cell.mix, run.model
    ref = run.cell.reference()
    params = weights.make(ref.param_specs(m), run.seed, run.device)
    p0 = {k: t.clone() for k, t in leaves(params)}
    rows = mix["batch"] // 2 if half_batch else mix["batch"]
    batches = []
    for step in range(mix["check_steps"]):
        tok, lab = traffic.train_batch(run.seed, step, mix["batch"], mix["seq"], m["vocab"])
        batches.append((torch.from_numpy(tok[:rows]).to(run.device),
                        torch.from_numpy(lab[:rows]).to(run.device)))
    losses, first = ref.train(params, batches, m, mix["optimizer"], mm, mix["ref_rows"])
    change = {k: float((t.float() - p0[k].float()).norm()) for k, t in leaves(params)}
    return {"losses": losses, "grad": norms(first), "grad_t": first, "change": change}


def compare(got: Dict, ref: Dict) -> Dict:
    med = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
    keep = [k for k, g in ref["grad"].items() if g >= NEGLIGIBLE * med]
    grad, change = (leaf_gaps(got[k], ref[k], keep) for k in ("grad", "change"))
    err = {}
    for k in keep:
        r = ref["grad_t"][k].float()
        err[k] = float((got["grad_t"][k].to(r.device).float() - r).norm() / r.norm())
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_worst_leaf_err": max(err.values()),
            "grad_gap": max(grad.values()), "change_gap": max(change.values()),
            "worst_grad_leaf": max(grad, key=grad.get),
            "worst_change_leaf": max(change, key=change.get),
            "left_out": sorted(set(ref["grad"]) - set(keep))}


def free(cluster, job) -> None:
    job.state = None
    job._step_fn = None
    cluster.jobs.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(run: Run):
    mix = run.cell.mix
    cluster, job, params = build(run)
    got = first_steps(run, cluster, job, params)
    del params
    assert_no_forbidden("after set-up")
    settle()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    run.rec["setup_s"] = time.perf_counter() - run.t_start
    from repro_torch.kernels import launch_counts
    stretch, steps = None, []
    t_w = time.perf_counter()
    while True:
        traced = (run.trace and time.perf_counter() - t_w >= mix["trace_at"] * run.seconds
                  and (stretch is None or len(stretch.units) < mix["trace_units"]))
        if traced and stretch is None:
            stretch = Stretch(run.device).__enter__()
        before = launch_counts() if traced else None
        t = time.perf_counter()
        cluster.step_all(1)
        steps.append({"s": time.perf_counter() - t, "traced": traced})
        if traced:
            after = launch_counts()
            stretch.units.append({"B": mix["batch"], "S": mix["seq"],
                                  "launches": {k: after[k] - before[k] for k in after}})
            if len(stretch.units) == mix["trace_units"]:
                stretch.__exit__(None, None, None)
        if time.perf_counter() - t_w >= run.seconds:
            break
    window_s = time.perf_counter() - t_w
    if stretch is not None and stretch.wall_s is None:
        stretch.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    run.rec.update(kind="train", reference=run.cell.config["reference"], model=run.model,
                   window_s=window_s, steps=steps, tokens_per_step=mix["batch"] * mix["seq"],
                   seq=mix["seq"], card=power_limit() if run.device.type == "cuda" else None)
    if stretch is not None:
        run.rec["trace"] = stretch.reduce()
    free(cluster, job)
    exact_matmuls()
    t_check = time.perf_counter()
    r = compare(got, reference_readings(run))
    run.rec["check_s"] = time.perf_counter() - t_check
    lim = run.cell.limits
    for name in CHECKED:
        run.check(name, r[name], lim[name])
    run.rec.update(left_out=r["left_out"], grad_gap=r["grad_gap"], loss_gap=r["loss_gap"],
                   worst_grad_leaf=r["worst_grad_leaf"],
                   worst_change_leaf=r["worst_change_leaf"])
    return len(steps), 0, peak

