"""The port's MoE family (olmoe) against the JAX reference, on the CPU.

Reduced olmoe_1b_7b in f32 (4 layers, 8 experts, top-2, d_expert 64,
capacity factor 4.0), with two variants: `dropping` (capacity factor 0.5,
so the token-major claim order decides which assignments overflow to the
trash slot) and `shared_dense` (one shared expert and a dense first block,
the `shared` and `pre_layers` params).  The reference's params are carried
over with `from_jax_params`, inputs are drawn with numpy from a seed, and
the reference runs compiled at its lowest backend optimisation level and
single-threaded (`_jit`), the port single-threaded.

Tolerances: `moe_fwd` 2e-5 on y and 1e-6 on the aux loss, with the routing
(expert ids, kept mask, slots) equal; `forward` logits 1e-4 and its aux
1e-5; prefill and greedy decode logits and every cache leaf 1e-4 with
tokens equal; one train step's loss, grad norm and params 1e-4 (AdamW eps
1e-3, as tests/test_torch_training.py explains); the port's decode against
its own forward 2e-2 on log-softmax, `tests/test_archs.py`'s bound for
attention families.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models import dist as jdist  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import make_train_state as jmake_state  # noqa: E402
from repro.training import make_train_step as jmake_step  # noqa: E402
from repro.training import synthetic_batch as jsynthetic_batch  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import (decode_step, forward, from_jax_params,  # noqa: E402
                                init_cache, init_params, model, moe, prefill)
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.training import (AdamW, make_train_state, make_train_step,  # noqa: E402
                                  synthetic_batch)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
N_DECODE = 8
VARIANTS = ("base", "dropping", "shared_dense")


def _variant(cfg, name):
    if name == "dropping":
        return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    if name == "shared_dense":
        return cfg.with_(moe=dataclasses.replace(cfg.moe, n_shared=1, first_dense=1,
                                                 d_first_dense=256))
    return cfg


def _compiled(fn, *args):
    """fn compiled for args' shapes at XLA's lowest backend optimisation
    level, its contractions single-threaded (see tests/test_torch_ssm.py)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_cpu_multi_thread_eigen": False})


def _jit(fn, *args):
    return _compiled(fn, *args)(*args)


@pytest.fixture(scope="module", autouse=True)
def no_mesh():
    """The reference's `moe_fwd` takes its shard_map branch under a mesh;
    make sure no other test module left one set."""
    saved = (jdist.get_mesh(), jdist.batch_axes())
    jdist.set_mesh(None)
    yield
    jdist.set_mesh(*saved)


@pytest.fixture(autouse=True)
def pinned_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rigs():
    return {}


def _rig(rigs, name):
    """(jcfg, cfg, reference params, the port's copy) of a variant; the
    dropping variant shares the base variant's params."""
    if name not in rigs:
        jcfg = _variant(jreduced("olmoe_1b_7b"), name)
        cfg = _variant(reduced("olmoe_1b_7b"), name)
        if name == "dropping":
            _, _, jp, tp = _rig(rigs, "base")
        else:
            jp = _jit(lambda key: jmodel.init_params(key, jcfg), jax.random.PRNGKey(0))
            tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
        rigs[name] = (jcfg, cfg, jp, tp)
    return rigs[name]


def _close(j, t, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _cache_close(jcache, tcache):
    assert sorted(tcache) == sorted(jcache)
    for name, kv in tcache.items():
        for j, t in zip(jcache[name], kv):
            assert tuple(t.shape) == tuple(j.shape), name
            _close(j, t)


# ---------------------------------------------------------------- moe_fwd
def _jroute(x2d, router, cfg, capacity):
    """The reference's routing, with the ops of `_moe_local` (one device):
    (expert ids, kept mask, slots)."""
    m = cfg.moe
    probs = jax.nn.softmax((x2d.astype(jnp.float32) @ router).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    eid = top_e.reshape(-1)
    onehot = eid[:, None] == jnp.arange(m.n_experts)[None]
    pos = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1
    pos = jnp.take_along_axis(pos, eid[:, None], axis=1)[:, 0]
    keep = pos < capacity
    return eid, keep, jnp.where(keep, pos, capacity)


@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_fwd_matches_jax(rigs, variant):
    jcfg, cfg, jp, tp = _rig(rigs, variant)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tlp = model._layer(tp["layers"]["moe"], 0)
    B, S = 2, 32
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jy, jaux = _jit(lambda p, a: jmoe.moe_fwd(p, a, jcfg), jlp, jnp.asarray(x))
    y, aux = moe.moe_fwd(tlp, torch.from_numpy(x), cfg)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32 and aux.dim() == 0
    _close(jy, y, atol=2e-5, rtol=2e-5)
    _close(jaux, aux, atol=1e-6, rtol=1e-6)
    cap = moe._capacity(B * S, cfg)
    assert cap == jmoe._capacity(B * S, jcfg)
    jeid, jkeep, jslot = _jit(lambda a, r: _jroute(a, r, jcfg, cap),
                              jnp.asarray(x.reshape(B * S, -1)), jlp["router"])
    _, _, eid, keep, slot = moe._route(torch.from_numpy(x.reshape(B * S, -1)),
                                       tlp["router"], cfg, cap)
    assert np.array_equal(eid.numpy(), np.asarray(jeid))
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(slot.numpy(), np.asarray(jslot))
    # the dropping variant overflows, the others keep every assignment
    assert bool((~keep).any()) == (variant == "dropping")


def test_moe_params_match_the_reference_tree(rigs):
    """The router is f32 in a bf16 model, as in the reference; `shared` and
    `pre_layers` appear with their variant."""
    for name in ("base", "shared_dense"):
        jcfg, cfg, _, _ = _rig(rigs, name)
        jcfg, cfg = jcfg.with_(param_dtype="bfloat16"), cfg.with_(param_dtype="bfloat16")
        jshapes = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg), jax.random.PRNGKey(0))
        tp = init_params(cfg, device="meta")
        jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): a for path, a in jl}
        tflat = {}

        def walk(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    tflat[f"{prefix}{k}"] = v
        walk(tp)
        assert sorted(tflat) == sorted(flat)
        for key, a in flat.items():
            assert tuple(tflat[key].shape) == tuple(a.shape), key
            assert str(tflat[key].dtype).removeprefix("torch.") == str(a.dtype), key
        assert tflat["layers/moe/router"].dtype == torch.float32
        assert ("pre_layers/ffn/w_up" in tflat) == ("layers/moe/shared/w_up" in tflat) \
            == (name == "shared_dense")


# -------------------------------------------------------- forward and aux
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_and_aux_match_jax(rigs, variant):
    jcfg, cfg, jp, tp = _rig(rigs, variant)
    toks = _tokens(cfg, 2, 24, seed=2)
    jt = jnp.asarray(toks)
    jl, jaux = _jit(lambda p, t: jmodel.forward(p, jmodel.TrainBatch(t, t), jcfg), jp, jt)
    tl, aux = model._forward(tp, torch.from_numpy(toks).long(), cfg)
    _close(jl, tl)
    _close(jaux, aux, atol=1e-5, rtol=1e-5)
    assert torch.equal(forward(tp, torch.from_numpy(toks).long(), cfg), tl)


# ------------------------------------------------------- prefill + decode
@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_greedy_decode_match_jax(rigs, variant):
    """A 40-token prefill, every cache leaf grown by N_DECODE rows, then
    N_DECODE greedy decode steps, each side feeding back its own argmax."""
    jcfg, cfg, jp, tp = _rig(rigs, variant)
    toks = _tokens(cfg, 2, 40, seed=3)
    jl, jcache = _jit(lambda p, t: jmodel.prefill(p, t, jcfg), jp, jnp.asarray(toks))
    tl, tcache = prefill(tp, torch.from_numpy(toks).long(), cfg)
    _close(jl, tl)
    _cache_close(jcache, tcache)
    pad = [(0, 0), (0, 0), (0, N_DECODE), (0, 0), (0, 0)]
    jcache = {n: tuple(jnp.pad(c, pad) for c in kv) for n, kv in jcache.items()}
    tcache = {n: tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, N_DECODE)) for c in kv)
              for n, kv in tcache.items()}
    jdec = _compiled(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, jcfg),
                     jp, jcache, jnp.zeros((2, 1), jnp.int32), jnp.int32(0))
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1)
    for i in range(N_DECODE):
        assert ttok.tolist() == np.asarray(jtok).tolist()
        jl, jcache = jdec(jp, jcache, jtok[:, None], jnp.int32(40 + i))
        tl, tcache = decode_step(tp, tcache, ttok[:, None], 40 + i, cfg)
        _close(jl, tl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    _cache_close(jcache, tcache)


@pytest.mark.parametrize("variant", ["base", "shared_dense"])
def test_decode_matches_forward(rigs, variant):
    """Teacher-forced, as tests/test_archs.py: prefill of 23 tokens, then a
    decode step of the 24th against `forward` over all 24 (log-softmax
    within 2e-2), and prefill's last logits against `forward` at 23.  The
    dropping variant is left out: prefill drops assignments that decode
    keeps, so the two differ by construction."""
    _, cfg, _, tp = _rig(rigs, variant)
    toks = torch.from_numpy(_tokens(cfg, 2, 24, seed=3)).long()
    full = forward(tp, toks, cfg)[..., :cfg.vocab].float()
    lp, cache = prefill(tp, toks[:, :23], cfg)
    cache = {n: tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1)) for c in kv)
             for n, kv in cache.items()}
    ld, _ = decode_step(tp, cache, toks[:, 23:], 23, cfg)
    for t, lg in ((23, ld), (22, lp)):
        gap = torch.log_softmax(full[:, t], -1) - torch.log_softmax(lg.float(), -1)
        assert float(gap.abs().max()) < 2e-2, t


def test_init_cache_matches_jax(rigs):
    jcfg, cfg, _, _ = _rig(rigs, "shared_dense")
    jc, c = jmodel.init_cache(jcfg, 3, 16), init_cache(cfg, 3, 16, "cpu")
    assert sorted(c) == sorted(jc) == ["layers", "pre_layers"]
    for name in c:
        for j, t in zip(jc[name], c[name]):
            assert tuple(t.shape) == tuple(j.shape) and not t.any()


# ----------------------------------------------------------- ServeEngine
@pytest.mark.parametrize("variant", VARIANTS)
def test_serve_engine_tokens_equal_jax(rigs, variant):
    """Left-padded prompts of 33-40 tokens: past d_head (32), so both
    engines grow every cache leaf to max_seq, `pre_layers` too (the
    shared_dense variant)."""
    jcfg, cfg, jp, tp = _rig(rigs, variant)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in (40, 33, 37)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    JServeEngine(jcfg, jp, max_seq=64).serve_batch(jreqs)
    ServeEngine(cfg, tp, max_seq=64, device="cpu").serve_batch(reqs)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in jreqs]
    assert all(len(r.tokens_out) == 6 for r in reqs)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_matches_jax(rigs, variant):
    jcfg, cfg, jp, tp = _rig(rigs, variant)
    kw = dict(lr=1e-3, eps=1e-3, warmup=2, total_steps=10)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jb = jsynthetic_batch(jcfg, 4, 32, step=3)
    tb = synthetic_batch(cfg, 4, 32, step=3, device="cpu")
    jstate, jm = _jit(jmake_step(jcfg, jopt), jmake_state(jp, jopt), jb)
    state, m = make_train_step(cfg, opt)(
        make_train_state(jax.tree.map(lambda t: t.clone(), tp), opt), tb)
    for k in ("loss", "grad_norm", "nll", "aux"):
        _close(jm[k], m[k])
    assert float(m["aux"]) > 0
    jax.tree.map(_close, jstate.params, state.params)


def test_remat_gives_the_same_grads(rigs):
    """Under remat="full" each block, the aux it returns included, is
    recomputed in the backward pass: the loss, the aux and every gradient
    equal those without remat."""
    _, cfg, _, tp = _rig(rigs, "shared_dense")
    tb = synthetic_batch(cfg, 2, 32, step=5, device="cpu")
    out = []
    for c in (cfg, cfg.with_(remat="full")):
        live = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
        loss, m = model.loss_fn(live, tb, c)
        loss.backward()
        out.append((loss.detach(), m["aux"].detach(), jax.tree.map(lambda t: t.grad, live)))
    (l0, a0, g0), (l1, a1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(a0, a1) and float(a0) > 0
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-6), g0, g1)


# ------------------------------------------------------ launches and CLIs
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_kernel_calls_match_chip_smokes_count(monkeypatch, remat):
    """chip_smoke phase 15 asserts each kernel's launches per MoE train step
    from the layer count and the remat; on the CPU the same path calls the
    attention kernel's plain forward where the card launches it."""
    cfg = reduced("olmoe_1b_7b").with_(remat=remat)
    calls = []
    orig = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    opt = AdamW()
    make_train_step(cfg, opt, microbatches=2)(
        make_train_state(init_params(cfg, seed=0, device="cpu"), opt),
        synthetic_batch(cfg, 2, 32, device="cpu"))
    want = _chip_smoke().train_launches(cfg, microbatches=2)
    assert len(calls) == want["flash_attention"]
    assert want == {"flash_attention": 2 * cfg.n_layers * (2 if remat == "full" else 1),
                    "flash_attention_bwd": 2 * cfg.n_layers, "ssd_scan": 0,
                    "ssd_scan_bwd": 0}


def test_serve_and_train_clis_run_olmoe_on_cpu():
    s = serve.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "40", "--min-prompt-len", "33",
                    "--max-new", "4", "--max-seq", "64"])
    assert s["arch"] == "olmoe-1b-7b" and [len(o) for o in s["outputs"]] == [4] * 3
    assert s["prompt_lens"] == [len(r.prompt) for r in serve.draw_requests(
        reduced("olmoe_1b_7b").vocab, 3, 33, 40, 4)]
    t = train.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", "--layers",
                    "2", "--steps", "2", "--batch", "4", "--seq", "32", "--microbatches", "2"])
    assert t["steps"] == 2 and all(math.isfinite(x) for x in t["losses"])
    assert abs(t["losses"][0] - math.log(512)) < 1.0


def test_chip_smokes_moe_batch_is_the_serve_launchers():
    """chip_smoke checks its kernels at phase 14's batch, which it draws
    itself (so its kernel phase also runs in older checkouts): the shape
    must be the one `launch.serve` draws for the same arguments."""
    cs = _chip_smoke()
    reqs = serve.draw_requests(50304, cs.MOE_REQUESTS, *cs.MOE_PROMPT, cs.MOE_NEW)
    assert cs.moe_serve_batch() == (len(reqs), max(len(r.prompt) for r in reqs))
