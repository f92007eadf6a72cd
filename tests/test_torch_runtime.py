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
