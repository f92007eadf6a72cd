"""The port's ElasticJob against the reference's runtime contracts.

The contracts of `tests/test_runtime.py` (resize keeps the params bit for
bit; resume restores params and step exactly; a checkpointed restart
replays the uninterrupted stream within 1e-6), run on the port on CPU slots
and on the reference on 8 host devices (one subprocess, so the XLA flag
does not leak), from the same params: the reference's `init_params` for
the job's seed, carried over with `from_jax_params`.  Both train SMALL_CFG
with AdamW eps 1e-3, as `tests/test_torch_training.py` does; the port's
states and losses agree with the reference's within that file's 1e-5 for a
state after AdamW steps (f32 sums in another order).  The checkpoint layout
is shared, so the port resumes from the reference's preempt checkpoint,
exactly.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import init_params as jinit_params  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.models import ModelConfig, from_jax_params  # noqa: E402
from repro_torch.runtime import ElasticJob  # noqa: E402
from repro_torch.runtime.elastic import _state_leaves  # noqa: E402
from repro_torch.training import AdamW, checkpoint, make_train_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
             d_ff=128, vocab=256, tie_embeddings=True, param_dtype="float32",
             compute_dtype="float32", attn_block_q=32, attn_block_kv=32)
OPT = dict(lr=1e-3, eps=1e-3, warmup=2, total_steps=20)
TOL = dict(atol=1e-5, rtol=1e-5)
CPU = ["cpu"] * 8

REFERENCE = """
import json, sys
import jax, numpy as np
from repro.models.config import ModelConfig
from repro.runtime import ElasticJob
from repro.training import AdamW, checkpoint

out = sys.argv[1]
CFG = ModelConfig(**SMALL)
devs = jax.devices()
assert len(devs) == 8
res = {}

def job(seed, **kw):
    return ElasticJob(1, CFG, kind="malleable", batch=8, seq=32, opt=AdamW(**OPT),
                      seed=seed, **kw)

def leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state.params)]

def max_err(a, b):
    return max(float(np.abs(x.astype(np.float64) - y).max()) for x, y in zip(a, b))

# shrink and expand
j = job(0)
j.start(devs[:4])
losses = [j.step()["loss"] for _ in range(3)]
before = leaves(j.state)
j.resize(devs[:2])
res["reshard_err"] = max_err(before, leaves(j.state))
losses.append(j.step()["loss"])
j.resize(devs[:6])
losses.append(j.step()["loss"])
res["resize_losses"] = losses
checkpoint.save(f"{out}/resize", j.step_idx, j.state)

# preempt with warning, resume on other devices
j = job(0, ckpt_dir=f"{out}/preempt", ckpt_every=100)
j.start(devs[:4])
for _ in range(4):
    j.step()
at_preempt = leaves(j.state)
j.preempt(warning=True)
j2 = job(0, ckpt_dir=f"{out}/preempt")
j2.resume(devs[4:8])
res["resume_step"] = j2.step_idx
res["resume_err"] = max_err(at_preempt, leaves(j2.state))

# a 5 + 5 step restart against 10 uninterrupted steps
a = job(7)
a.start(devs[:1])
for _ in range(10):
    a.step()
b = job(7, ckpt_dir=f"{out}/restart", ckpt_every=5)
b.start(devs[:1])
for _ in range(5):
    b.step()
b2 = job(7, ckpt_dir=f"{out}/restart")
b2.resume(devs[:1])
for _ in range(5):
    b2.step()
res["restart_err"] = max_err(leaves(a.state), leaves(b2.state))
checkpoint.save(f"{out}/ten", a.step_idx, a.state)
with open(f"{out}/results.json", "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Starts the reference's runs in a subprocess; returns a function that
    waits for them and gives (results, output directory)."""
    out = tmp_path_factory.mktemp("reference_runtime")
    code = f"SMALL = {SMALL!r}\nOPT = {OPT!r}\n" + REFERENCE
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0")
    proc = subprocess.Popen([sys.executable, "-c", code, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}

    def result():
        if not done:
            _, err = proc.communicate(timeout=540)
            assert proc.returncode == 0, err[-3000:]
            with open(out / "results.json") as f:
                done.update(json.load(f))
        return done, out

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def cfgs():
    return JModelConfig(**SMALL), ModelConfig(**SMALL)


def _job(cfgs, seed, **kw):
    """A port job whose state starts from the reference's params."""
    jcfg, cfg = cfgs
    job = ElasticJob(1, cfg, kind="malleable", batch=8, seq=32, opt=AdamW(**OPT),
                     seed=seed, **kw)
    params = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(seed), jcfg))
    job.state = make_train_state(from_jax_params(params, cfg, "cpu"), job.opt)
    return job


def _params(job):
    return [t.clone() for t in _state_leaves(job.state.params)]


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _close_to(state, ckpt_dir):
    """state against the reference's state saved under ckpt_dir."""
    ref = checkpoint.restore(str(ckpt_dir), state)
    for got, want in zip(_state_leaves((state.params, state.opt)),
                         _state_leaves((ref.params, ref.opt))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_shrink_and_expand_keep_the_params_bit_for_bit(cfgs, reference):
    job = _job(cfgs, 0)
    job.start(CPU[:4])
    losses = [job.step()["loss"] for _ in range(3)]
    before = _params(job)
    job.resize(CPU[:2])
    assert _bit_equal(before, _params(job))
    losses.append(job.step()["loss"])
    job.resize(CPU[:6])
    losses.append(job.step()["loss"])
    assert len(job.resize_costs) == 2 and all(c >= 0 for c in job.resize_costs)
    ref, out = reference()
    assert ref["reshard_err"] == 0.0
    np.testing.assert_allclose(losses, ref["resize_losses"], **TOL)
    _close_to(job.state, out / "resize")


def test_preempt_and_resume_restore_params_and_step_exactly(cfgs, reference, tmp_path):
    job = _job(cfgs, 0, ckpt_dir=str(tmp_path), ckpt_every=100)
    job.start(CPU[:4])
    for _ in range(4):
        job.step()
    at_preempt = _params(job)
    job.preempt(warning=True)
    assert job.devices == () and all(t.device.type == "cpu" for t in _params(job))
    job2 = ElasticJob(1, cfgs[1], kind="malleable", batch=8, seq=32, opt=AdamW(**OPT),
                      seed=0, ckpt_dir=str(tmp_path))
    job2.resume(CPU[4:8])
    assert job2.step_idx == 4
    assert _bit_equal(at_preempt, _params(job2))
    job2.step()
    ref, _ = reference()
    assert (ref["resume_step"], ref["resume_err"]) == (4, 0.0)


def test_restart_replays_the_uninterrupted_stream(cfgs, reference, tmp_path):
    a = _job(cfgs, 7)
    a.start(CPU[:1])
    for _ in range(10):
        a.step()
    b = _job(cfgs, 7, ckpt_dir=str(tmp_path), ckpt_every=5)
    b.start(CPU[:1])
    for _ in range(5):
        b.step()
    b2 = ElasticJob(1, cfgs[1], kind="malleable", batch=8, seq=32, opt=AdamW(**OPT),
                    seed=7, ckpt_dir=str(tmp_path))
    b2.resume(CPU[:1])
    for _ in range(5):
        b2.step()
    err = max(float((x.double() - y.double()).abs().max())
              for x, y in zip(_params(a), _params(b2)))
    assert err < 1e-6
    ref, out = reference()
    assert ref["restart_err"] < 1e-6
    _close_to(a.state, out / "ten")


def test_port_resumes_the_references_preempt_checkpoint(cfgs, reference):
    """The reference's ElasticJob wrote a preempt checkpoint at step 4; the
    port's resume reads it: step 4 and every param bit of the file."""
    _, out = reference()
    job = ElasticJob(1, cfgs[1], kind="malleable", batch=8, seq=32, opt=AdamW(**OPT),
                     seed=0, ckpt_dir=str(out / "preempt"))
    job.resume(["cpu"])
    assert job.step_idx == 4
    with np.load(out / "preempt" / "step_00000004.npz") as data:
        flat = checkpoint._flatten(job.state)
        assert sorted(flat) == sorted(data.files)
        for key, arr in flat.items():
            assert np.array_equal(arr, data[key]), key
    assert np.isfinite(job.step()["loss"])


# ------------------------------------------------------ a job on gloo ranks
# Slots that name distinct devices run the job on one rank process each, on
# an (n, 1) ("data", "model") mesh, as the reference's job runs on n of its 8
# host devices: the same contracts, from the same params.
RANKS = [f"cpu:{i}" for i in range(8)]


def _ranked_job(cfgs, seed, **kw):
    job = _job(cfgs, seed, **kw)
    assert job._ranks is None      # the reference's params wait in this process
    return job


def test_shrink_and_expand_on_ranks_keep_the_params_bit_for_bit(cfgs, reference, tmp_path):
    """start(4), 3 steps, resize(2), a step, resize(6), a step: the params
    cross each resize bit for bit, no resize writes a file, the shrink
    starts no process (its ranks re-form the world) and the expand starts
    six; the losses and the final state are the reference's within 1e-5."""
    job = _ranked_job(cfgs, 0, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=100)
    try:
        job.start(RANKS[:4])
        assert len(job._ranks) == 4
        losses = [job.step()["loss"] for _ in range(3)]
        before = _params(job)
        shrink_cost = job.resize(RANKS[:2])
        assert len(job._ranks) == 2 and job.devices == [torch.device(d) for d in RANKS[:2]]
        assert _bit_equal(before, _params(job))
        losses.append(job.step()["loss"])
        before = _params(job)
        job.resize(RANKS[:6])
        assert len(job._ranks) == 6
        assert _bit_equal(before, _params(job))
        losses.append(job.step()["loss"])
        state = job.state
    finally:
        job.close()
    assert not (tmp_path / "ckpt").exists()
    shrink, expand = job.resize_parts
    assert set(shrink) == {"gather_s", "reform_s", "place_s"}
    assert set(expand) == {"gather_s", "spawn_s", "place_s"}
    assert job.resize_costs[0] == shrink_cost and all(c > 0 for c in job.resize_costs)
    ref, out = reference()
    np.testing.assert_allclose(losses, ref["resize_losses"], **TOL)
    _close_to(state, out / "resize")


def test_preempt_on_ranks_and_resume_on_others_restore_exactly(cfgs, reference, tmp_path):
    """Preempt with warning on cpu:0-3 after 4 steps (the ranks write the
    checkpoint and stop), resume on cpu:4-7: step 4, every param bit; the
    reference's preempt checkpoint resumes on 4 ranks exactly too (every
    array of the file)."""
    job = _ranked_job(cfgs, 0, ckpt_dir=str(tmp_path), ckpt_every=100)
    try:
        job.start(RANKS[:4])
        for _ in range(4):
            job.step()
        at_preempt = _params(job)
        job.preempt(warning=True)
        assert job.devices == () and job._ranks is None
        assert _bit_equal(at_preempt, _params(job))   # gathered to host memory
    finally:
        job.close()
    _, out = reference()
    job2 = ElasticJob(1, cfgs[1], kind="malleable", batch=8, seq=32, opt=AdamW(**OPT),
                      seed=0, ckpt_dir=str(tmp_path))
    try:
        job2.resume(RANKS[4:8])
        assert job2.step_idx == 4 and len(job2._ranks) == 4
        assert _bit_equal(at_preempt, _params(job2))
        for ckpt in (tmp_path, out / "preempt"):
            # the reference's: the restore a resume runs, on the same 4 ranks
            job2._ranks.call("restore", str(ckpt))
            flat = checkpoint._flatten(job2.state)
            with np.load(Path(ckpt) / "step_00000004.npz") as data:
                assert sorted(flat) == sorted(data.files)
                for key, arr in flat.items():
                    assert np.array_equal(arr, data[key]), key
    finally:
        job2.close()


def test_rank_placements_are_tree_shardings(cfgs):
    """With fsdp the rules shard the weights over `data`: after start on
    4 ranks each rank's placements equal `sharding.tree_shardings` leaf by
    leaf, some of them sharded, and a step's loss is the one-device job's
    within 1e-5."""
    from types import SimpleNamespace

    from repro_torch.sharding import leaves_with_paths, at_path, tree_shardings
    jcfg, cfg = cfgs
    cfg = cfg.with_(fsdp=True)
    one = _job((jcfg, cfg), 0)
    one.start(["cpu"])
    job = _ranked_job((jcfg, cfg), 0)
    try:
        job.start(RANKS[:4])
        want = tree_shardings(one.state, cfg,
                              SimpleNamespace(shape=(4, 1), mesh_dim_names=("data", "model")))
        got = job._ranks.results("placements")
        paths = [p for p, _ in leaves_with_paths(one.state)]
        assert len(got) == 4 and paths
        for rank_pl in got:
            for path in paths:
                assert tuple(at_path(rank_pl, path)) == tuple(at_path(want, path)), path
        assert any("Shard" in repr(at_path(want, p)) for p in paths)
        np.testing.assert_allclose(job.step()["loss"], one.step()["loss"], **TOL)
    finally:
        job.close()


def test_a_rank_that_raises_fails_start_within_the_timeout(cfgs):
    """Every rank of a job whose config no rank can build raises: start
    raises RankError, with the rank's own error, well inside the ranks'
    timeout, and leaves no rank running."""
    from repro_torch.runtime.ranks import RANK_TIMEOUT, RankError
    bad = cfgs[1].with_(family="no-such-family")
    job = ElasticJob(1, bad, batch=8, seq=32, opt=AdamW(**OPT))
    t0 = time.monotonic()
    with pytest.raises(RankError, match="ValueError: no-such-family"):
        job.start(RANKS[:2])
    assert time.monotonic() - t0 < RANK_TIMEOUT / 10
    assert job._ranks is None or len(job._ranks) == 0


def test_live_cluster_drives_a_job_on_ranks_unchanged(cfgs):
    """`LiveCluster` (the reference's scheduling, copied) on 3 slots that
    name distinct CPU devices: a malleable job starts on 3 ranks, an
    on-demand arrival shrinks it to 2 (SPAA), the release expands it back
    to 3, and it finishes its steps; its losses are those of the same job
    on one device within 1e-5."""
    from repro_torch.runtime import LiveCluster
    one = _job(cfgs, 3)
    one.start(["cpu"])
    want = [one.step()["loss"] for _ in range(3)]
    cluster = LiveCluster(RANKS[:3], arrival_policy="SPAA")
    job = _ranked_job(cfgs, 3)
    try:
        info = cluster.submit(job, min_nodes=2, max_nodes=3, target_steps=3)
        assert len(job._ranks) == 3
        cluster.step_all(1)
        od = cluster.acquire_for_ondemand(1)
        assert len(job._ranks) == 2 and len(info.node_ids) == 2
        cluster.step_all(1)
        cluster.release_ondemand(od)
        assert len(job._ranks) == 3
        cluster.step_all(1)
    finally:
        job.close()
    assert [e["event"] for e in cluster.log] == ["start", "shrink", "od_acquire", "expand",
                                                 "finish"]
    assert info.status == "done" and len(job.resize_costs) == 2
    np.testing.assert_allclose(job.losses, want, **TOL)
