"""The port's last two seam entry points against the JAX package's examples,
on the CPU.

* `repro_torch.launch.quickstart`: 3 steps of the `20m` model (batch 2, seq
  64) from the reference's params (`from_jax_params`) give the reference's
  `make_train_step` metrics on the same `synthetic_batch` stream: nll,
  grad norm and lr within 1e-4 (f32 sums in another order through six
  layers and an AdamW step; `tests/test_torch_training.py` holds a step at
  the same bound).
* `repro_torch.launch.ondemand_serving`: the two bursts through the port's
  service give the reference's decision rows (the clock fields `wall`,
  `mono` and `latency_ms` removed) and its greedy tokens, request by
  request.  The service runs at `speed=inf` (ServiceConfig's default), so
  the rows do not depend on how fast the model serves.

The reference side is `examples/quickstart.py` and
`examples/ondemand_serving.py` themselves: their model sizes, and the
serve demo's `ServeLauncher`, come from the example modules.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import init_params as jinit_params  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.service import AdmissionQueue as JAdmissionQueue  # noqa: E402
from repro.service import SchedulerService as JSchedulerService  # noqa: E402
from repro.service import ServiceConfig as JServiceConfig  # noqa: E402
from repro.service import SloPolicy as JSloPolicy  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import make_train_state as jmake_state  # noqa: E402
from repro.training import make_train_step as jmake_step  # noqa: E402
from repro.training import synthetic_batch as jsynthetic_batch  # noqa: E402
from repro_torch.launch import ondemand_serving, quickstart  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- quickstart
def test_quickstart_sizes_are_the_examples():
    ex = _example("quickstart")
    for size, jcfg in ex.SIZES.items():
        cfg = quickstart.SIZES[size]
        assert cfg.param_count() == jcfg.param_count()
        assert {f: getattr(cfg, f) for f in ("n_layers", "d_model", "n_heads", "n_kv",
                                             "d_ff", "vocab", "tie_embeddings")} == \
            {f: getattr(jcfg, f) for f in ("n_layers", "d_model", "n_heads", "n_kv",
                                           "d_ff", "vocab", "tie_embeddings")}
        assert cfg.d_head == 64


def test_quickstart_matches_the_reference():
    steps, batch, seq = 3, 2, 64
    jcfg = _example("quickstart").SIZES["20m"].with_(param_dtype="float32",
                                                     compute_dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), quickstart.config("20m"), "cpu")
    opt = JAdamW(lr=3e-3, warmup=20, total_steps=steps)
    state = jmake_state(jp, opt)
    step = jax.jit(jmake_step(jcfg, opt)).lower(
        state, jsynthetic_batch(jcfg, batch, seq, seed=0, step=0)).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    ref = {"nll": [], "grad_norm": [], "lr": []}
    for i in range(steps):
        state, m = step(state, jsynthetic_batch(jcfg, batch, seq, seed=0, step=i))
        for k in ref:
            ref[k].append(float(m[k]))
    out = quickstart.run("20m", steps=steps, batch=batch, seq=seq, device="cpu", params=tp)
    for k, v in ref.items():
        np.testing.assert_allclose(out[k], v, **TOL, err_msg=k)
    assert [r["step"] for r in out["log"]] == [0, steps - 1]
    assert out["log"][-1]["nll"] == out["nll"][-1]


# ---------------------------------------------------------- on-demand serving
@pytest.fixture(scope="module")
def served():
    """Both packages' on-demand demo from the same params."""
    ex = _example("ondemand_serving")
    cfg = ondemand_serving.CFG
    jcfg = JModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
        "tie_embeddings", "param_dtype", "compute_dtype", "attn_block_q", "attn_block_kv")})
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    launcher = ex.ServeLauncher(JServeEngine(jcfg, jp, max_seq=ondemand_serving.MAX_SEQ),
                                jcfg.vocab)
    queue = JAdmissionQueue()
    queue.submit_inference(nodes=8, hold_s=5.0)
    queue.submit_inference(nodes=4, hold_s=3.0, submit_time=2.0, notice_lead_s=2.0)
    queue.close()
    svc = JSchedulerService(JServiceConfig(n_nodes=8, mechanism="CUA&SPAA",
                                           slo=JSloPolicy(decision_p99_ms=30_000.0)),
                            launcher=launcher)
    rep = svc.run_live(queue)
    ref = {"decisions": [{k: v for k, v in row.items()
                          if k not in ondemand_serving.WALL_FIELDS} for row in svc.log.rows],
           "batches": [(jid, [r.tokens_out for r in reqs]) for jid, reqs, _ in launcher.batches],
           "n_jobs": rep.n_jobs, "n_decisions": rep.n_decisions}
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return ref, ondemand_serving.run(device="cpu", params=tp)


def test_ondemand_serving_decisions_equal_the_references(served):
    ref, out = served
    assert (out["n_jobs"], out["n_decisions"]) == (ref["n_jobs"], ref["n_decisions"])
    assert out["n_jobs"] == 2 and out["n_decisions"] > 0
    assert out["decisions"] == ref["decisions"]
    assert out["deterministic"]


def test_ondemand_serving_tokens_equal_the_references(served):
    ref, out = served
    assert len(ref["batches"]) == 2
    assert [(b["jid"], b["tokens"]) for b in out["batches"]] == ref["batches"]
