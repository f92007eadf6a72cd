"""The port's scheduler copy and its live seam against the JAX package.

1. The copy's `Simulator` on the golden workload (the one
   `tests/test_policy_api.py::test_golden_seed_metrics` pins) gives the
   reference's job records field by field, for BASE and every mechanism of
   MECHANISMS; a shadow replay through the copy's service gives the
   reference's decision digest.  Jobs come from the reference's
   `core.workloads` and are converted field by field to the port's JobSpec.
2. The seam end to end: `repro_torch.launch.elastic_cluster.run` on 8 CPU
   slots at `tests/test_runtime.py`'s SMALL_CFG, against the reference's
   `ElasticJob` / `ServeEngine` running the same four jobs through the same
   service on 8 host devices (a subprocess, so the XLA flag does not leak).
   Both start from the same params (the reference's `init_params`, carried
   over with `from_jax_params`) and train with AdamW eps 1e-3, as
   `tests/test_torch_training.py` does.  Decision digest, event log (without
   `t` and `reshard_s`), per-job counts and served tokens are equal; final
   params and moments agree within 1e-5 (`tests/test_torch_training.py`'s
   tolerance for a state after AdamW steps: f32 sums in another order).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import MECHANISMS as JMECHANISMS  # noqa: E402
from repro.core import SimConfig as JSimConfig  # noqa: E402
from repro.core import Simulator as JSimulator  # noqa: E402
from repro.core import WorkloadConfig, generate  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.service import DryrunLauncher as JDryrunLauncher  # noqa: E402
from repro.service import SchedulerService as JSchedulerService  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro_torch.core import MECHANISMS, JobSpec, JobType, NoticeKind  # noqa: E402
from repro_torch.core import SimConfig, Simulator  # noqa: E402
from repro_torch.launch import elastic_cluster  # noqa: E402
from repro_torch.models import ModelConfig, from_jax_params  # noqa: E402
from repro_torch.service import DryrunLauncher, SchedulerService, ServiceConfig  # noqa: E402
from repro_torch.training import AdamW, checkpoint, make_train_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
             d_ff=128, vocab=256, tie_embeddings=True, param_dtype="float32",
             compute_dtype="float32", attn_block_q=32, attn_block_kv=32)
OPT = dict(lr=3e-4, eps=1e-3, warmup=10, total_steps=10_000)
RUN = dict(batch=8, seq=32, target_steps=12, ckpt_every=6)
TOL = dict(atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- the scheduler
@pytest.fixture(scope="module")
def golden_jobs():
    jjobs = generate(WorkloadConfig(n_jobs=120, n_nodes=512, n_projects=12,
                                    horizon_days=4.0, seed=0))
    return jjobs, [_port_spec(j) for j in jjobs]


def _port_spec(j) -> JobSpec:
    kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    kw["jtype"] = JobType(j.jtype.value)
    kw["notice_kind"] = NoticeKind(j.notice_kind.value)
    return JobSpec(**kw)


def test_mechanisms_are_the_references():
    assert MECHANISMS == JMECHANISMS


@pytest.mark.parametrize("mech", ("BASE",) + MECHANISMS)
def test_simulator_records_equal_the_references(golden_jobs, mech):
    jjobs, jobs = golden_jobs
    ref = JSimulator(JSimConfig(n_nodes=512, mechanism=mech), list(jjobs))
    ref.run()
    sim = Simulator(SimConfig(n_nodes=512, mechanism=mech), list(jobs))
    sim.run()
    assert sorted(sim.records) == sorted(ref.records)
    fields = [f.name for f in dataclasses.fields(ref.records[0]) if f.name != "job"]
    for jid, r in ref.records.items():
        s = sim.records[jid]
        assert _port_spec(r.job) == s.job
        assert [getattr(s, f) for f in fields] == [getattr(r, f) for f in fields], jid
    assert sim.now == ref.now


@pytest.mark.parametrize("mech", ("BASE", "CUA&SPAA", "N&PAA"))
def test_shadow_replay_digest_equals_the_references(golden_jobs, mech):
    jjobs, jobs = golden_jobs
    jrep = JSchedulerService(JServiceConfig(n_nodes=512, mechanism=mech), list(jjobs),
                             launcher=JDryrunLauncher(512)).run_replay()
    rep = SchedulerService(ServiceConfig(n_nodes=512, mechanism=mech), list(jobs),
                           launcher=DryrunLauncher(512)).run_replay()
    assert rep.n_decisions == jrep.n_decisions > 0
    assert rep.digest == jrep.digest


# ------------------------------------------------------------------ the seam
REFERENCE = """
import json, sys, tempfile
import jax, numpy as np
from repro.core.job import JobType
from repro.models import init_params
from repro.models.config import ModelConfig
from repro.runtime import ElasticJob, LiveCluster
from repro.service import (AdmissionQueue, LiveClusterLauncher, SchedulerService,
                           ServiceConfig, plan_requests)
from repro.serving import Request, ServeEngine
from repro.training import AdamW, checkpoint

out, mech = sys.argv[1], sys.argv[2]
CFG = ModelConfig(**SMALL)
devices = jax.devices()
assert len(devices) == 8
cluster = LiveCluster(devices, arrival_policy=mech.split("&")[-1])
tmp = tempfile.mkdtemp()

def job_factory(spec):
    kind = "malleable" if spec.jtype is JobType.MALLEABLE else "rigid"
    return ElasticJob(spec.jid, CFG, kind=kind, batch=RUN["batch"], seq=RUN["seq"],
                      opt=AdamW(**OPT), ckpt_dir=f"{tmp}/j{spec.jid}",
                      ckpt_every=RUN["ckpt_every"], seed=spec.jid % 97)

served = []

def serve_fn(job, node_ids):
    engine = ServeEngine(CFG, init_params(jax.random.PRNGKey(9), CFG),
                         max_seq=MAX_SEQ)
    reqs = []
    for p in plan_requests(job, vocab=CFG.vocab):
        rng = np.random.default_rng(p["rid"])
        reqs.append(Request(rid=p["rid"], prompt=rng.integers(
            0, CFG.vocab, p["prompt_len"], dtype=np.int32),
            max_new_tokens=p["max_new_tokens"]))
    engine.serve_batch(reqs)
    served.append([r.tokens_out for r in reqs])
    return reqs

launcher = LiveClusterLauncher(cluster, job_factory, serve_fn=serve_fn,
                               steps_per_tick=2, target_steps=RUN["target_steps"])
queue = AdmissionQueue()
queue.submit_training(n_max=3, runtime_s=40.0, n_min=1)
queue.submit_training(n_max=3, runtime_s=40.0, n_min=1)
queue.submit_rigid(nodes=2, runtime_s=40.0)
queue.submit_inference(nodes=4, hold_s=8.0, submit_time=15.0, notice_lead_s=5.0)
queue.close()
svc = SchedulerService(ServiceConfig(n_nodes=8, mechanism=mech, speed=float("inf")),
                       launcher=launcher)
rep = svc.run_live(queue)
while any(i.status in ("running", "waiting") for i in launcher.infos.values()):
    cluster.step_all(5)
jobs = {}
for jid, info in launcher.infos.items():
    checkpoint.save(f"{out}/j{jid}", info.job.step_idx, info.job.state)
    jobs[jid] = dict(steps_done=info.steps_done, shrink_count=info.shrink_count,
                     preempt_count=info.preempt_count, step_idx=info.job.step_idx)
result = dict(digest=rep.digest, n_decisions=rep.n_decisions, jobs=jobs,
              log=[{k: v for k, v in e.items() if k not in ("t", "reshard_s")}
                   for e in cluster.log], served=served)
with open(f"{out}/results.json", "w") as f:
    json.dump(result, f)
"""


SEAM_MECHANISMS = ("CUA&SPAA", "CUA&PAA")


@pytest.fixture(scope="module")
def reference_seam(tmp_path_factory):
    """Starts the reference's run of each mechanism in a subprocess of its
    own, all at once; returns a function that waits for one and gives its
    results and the directory of its jobs' final states.  XLA compiles at
    its lowest backend optimisation level there (the same arithmetic; the
    runs re-compile a step for every mesh they resize to)."""
    code = (f"SMALL = {SMALL!r}\nOPT = {OPT!r}\nRUN = {RUN!r}\n"
            f"MAX_SEQ = {elastic_cluster.MAX_SEQ}\n" + REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0")
    procs = {}
    for mech in SEAM_MECHANISMS:
        out = tmp_path_factory.mktemp("reference_seam")
        procs[mech] = out, subprocess.Popen(
            [sys.executable, "-c", code, str(out), mech], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(mech):
        out, proc = procs[mech]
        _, err = proc.communicate(timeout=540)
        assert proc.returncode == 0, err[-3000:]
        with open(out / "results.json") as f:
            return json.load(f), out

    yield result
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _run_port(mech):
    jcfg, cfg = JModelConfig(**SMALL), ModelConfig(**SMALL)
    jobs = {}

    def on_job(job):
        job.opt = AdamW(**OPT)
        params = jinit_params(jax.random.PRNGKey(job.seed), jcfg)
        job.state = make_train_state(
            from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu"), job.opt)
        jobs[job.jid] = job

    serve_params = from_jax_params(
        jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(9), jcfg)), cfg, "cpu")
    stats = elastic_cluster.run(cfg, cfg, device="cpu", speed=math.inf, mechanism=mech,
                                serve_params=serve_params, on_job=on_job, **RUN)
    return stats, jobs


@pytest.mark.parametrize("mech,moves", zip(SEAM_MECHANISMS, [("shrink", "expand"),
                                                              ("preempt",)]))
def test_seam_equals_the_references(reference_seam, mech, moves):
    stats, jobs = _run_port(mech)
    ref, ref_ckpt = reference_seam(mech)
    log = [{k: v for k, v in e.items() if k != "reshard_s"} for e in stats["cluster_log"]]
    events = [e["event"] for e in log]
    assert {"event": "od_acquire", "jid": -1, "source": mech.split("&")[1],
            "nodes": 4} in log
    for move in moves:
        assert move in events
    if mech == "CUA&PAA":  # every preempted job starts again: a resume
        preempted = {e["jid"] for e in log if e["event"] == "preempt"}
        assert all(sum(1 for e in log if e == {"event": "start", "jid": jid, "nodes": 3})
                   == 2 for jid in preempted)
    assert log == ref["log"]
    assert (stats["digest"], stats["n_decisions"]) == (ref["digest"], ref["n_decisions"])
    assert [s["tokens"] for s in stats["served"]] == ref["served"]
    for jid, info in stats["jobs"].items():
        want = ref["jobs"][str(jid)]
        assert {k: info[k] for k in want} == want
        assert info["steps_done"] == RUN["target_steps"]
        assert all(math.isfinite(x) for x in info["losses"])
        state = jobs[jid].state
        got = checkpoint.restore(str(ref_ckpt / f"j{jid}"), state)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL),
                     (state.params, state.opt), (got.params, got.opt))
