"""The port's serving engine and CLI, against the JAX `ServeEngine`, and the
port's import boundary (no jax, nothing of the JAX package `repro`)."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import init_params as jinit_params  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ModelConfig, from_jax_params  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# the config of tests/test_runtime.py::test_serving_engine_batches_and_latency
CFG = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
           d_ff=128, vocab=128, tie_embeddings=True, param_dtype="float32",
           compute_dtype="float32", attn_block_q=32, attn_block_kv=32)


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = JModelConfig(**CFG), ModelConfig(**CFG)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return (JServeEngine(jcfg, jp, max_seq=64),
            ServeEngine(cfg, tp, max_seq=64, device="cpu"))


# Prompts are longer than d_head (16), so the reference grows its prefill
# cache to max_seq (`_grow` pads the sequence axis when it is the largest one).
@pytest.mark.parametrize("lens,max_new", [((17, 19, 21), 8), ((24, 17), 12),
                                          ((20, 20, 20, 20), 5)])
def test_greedy_tokens_equal_jax(engines, lens, max_new):
    jeng, eng = engines
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(0, 128, n, dtype=np.int32) for n in lens]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    jeng.serve_batch(jreqs)
    eng.serve_batch(reqs)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in jreqs]
    for r in reqs:
        assert len(r.tokens_out) == max_new
        assert r.submitted_at <= r.first_token_at <= r.done_at


# d_head 32: with prompts shorter than that the reference keeps the cache at
# the prompt's length and writes each decoded token into its last row.
SHORT_CFG = dict(CFG, d_model=128, vocab=256)


@pytest.mark.parametrize("lens,max_new", [((8, 13, 21), 10), ((31,), 6),
                                          ((9, 30, 17, 12), 8), ((32, 25), 5)])
def test_greedy_tokens_equal_jax_for_prompts_shorter_than_d_head(lens, max_new):
    jcfg, cfg = JModelConfig(**SHORT_CFG), ModelConfig(**SHORT_CFG)
    assert cfg.d_head == 32
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in lens]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    JServeEngine(jcfg, jp, max_seq=64).serve_batch(jreqs)
    ServeEngine(cfg, tp, max_seq=64, device="cpu").serve_batch(reqs)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in jreqs]
    assert all(len(r.tokens_out) == max_new for r in reqs)


def test_eos_stops_a_request(engines):
    _, eng = engines
    prompt = np.random.default_rng(9).integers(0, 128, 18, dtype=np.int32)
    free = eng.serve_batch([Request(rid=0, prompt=prompt, max_new_tokens=6)])[0]
    eos = free.tokens_out[2]
    stop = ServeEngine(eng.cfg, eng.params, max_seq=64, eos_id=eos, device="cpu")
    r = stop.serve_batch([Request(rid=0, prompt=prompt, max_new_tokens=6)])[0]
    assert r.tokens_out == free.tokens_out[:free.tokens_out.index(eos) + 1]


def test_prompt_longer_than_max_seq_raises(engines):
    _, eng = engines
    with pytest.raises(ValueError, match="max_seq"):
        eng.serve_batch([Request(rid=0, prompt=np.zeros(65, np.int32))])


def test_serve_cli_runs_on_cpu():
    stats = serve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                        "--requests", "3", "--prompt-len", "40", "--min-prompt-len", "33",
                        "--max-new", "4", "--max-seq", "64"])
    assert stats["tokens"] == 12 and stats["device"] == "cpu"
    assert all(len(o) == 4 for o in stats["outputs"])
    assert all(33 <= n <= 40 for n in stats["prompt_lens"])


def test_serve_cli_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3-8b", "--reduced"])


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith(('repro.', 'jax'))]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in (SRC / "repro_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_forbidden_imports_in_source(path):
    text = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import|from) (?:jax|repro)\b", text, flags=re.M)
    assert not bad, bad


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
