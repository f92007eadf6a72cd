"""The port's dense LM layers and model against the JAX reference.

JAX-initialised params go through `from_jax_params`, inputs are made with
numpy from a seed, and every comparison is in float32 on the CPU (the
kernels' plain versions) at atol/rtol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.model import TrainBatch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import (decode_step, forward, from_jax_params,  # noqa: E402
                                init_cache, init_params, prefill)
from repro_torch.models import layers  # noqa: E402

DENSE = ["llama3_8b", "yi_9b", "chatglm3_6b", "granite_34b"]
B, S = 2, 24
TOL = dict(atol=1e-4, rtol=1e-4)


def _close(j, t, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def rigs():
    return {}


def _rig(rigs, arch):
    if arch not in rigs:
        jcfg, cfg = jreduced(arch), reduced(arch)
        jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
        rigs[arch] = (jcfg, cfg, jp, from_jax_params(_np(jp), cfg, "cpu"))
    return rigs[arch]


def _tokens(cfg, seed=3, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_reference(arch):
    for jc, c in ((jconfigs.get_config(arch), configs.get_config(arch)),
                  (jreduced(arch), reduced(arch))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(c)
        assert jc.param_count() == c.param_count()
        assert jc.padded_vocab == c.padded_vocab


# ------------------------------------------------------------------- layers
def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x, s = rng.standard_normal((2, 5, 64)).astype(np.float32), \
        rng.standard_normal(64).astype(np.float32)
    j = jlayers.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-5)
    _close(j, layers.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x), 1e-5))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_jax(fraction):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [100]])).astype(np.int32)
    j = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0, fraction)
    t = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0, fraction)
    _close(j, t)
    if fraction < 1.0:  # the unrotated half passes through untouched
        assert torch.equal(t[..., 16:], torch.from_numpy(x)[..., 16:])


def _layer0(jp, tp, key):
    return (jax.tree.map(lambda a: a[0], jp["layers"][key]),
            {k: v[0] for k, v in tp["layers"][key].items()})


@pytest.mark.parametrize("arch", DENSE)
def test_gqa_prefill_and_decode_match_jax(rigs, arch):
    jcfg, cfg, jp, tp = _rig(rigs, arch)
    ja, ta = _layer0(jp, tp, "attn")
    x = np.random.default_rng(2).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    jo, (jk, jv) = jlayers.gqa_fwd(ja, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                   return_kv=True)
    to, (tk, tv) = layers.gqa_fwd(ta, torch.from_numpy(x), cfg,
                                  positions=torch.from_numpy(pos), return_kv=True)
    for j, t in ((jo, to), (jk, tk), (jv, tv)):
        _close(j, t)
    # decode: write the next token at S into a cache of S + 3 rows
    x1 = np.random.default_rng(3).standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pad = [(0, 0), (0, 3), (0, 0), (0, 0)]
    jcache = (jnp.pad(jk, pad), jnp.pad(jv, pad))
    tcache = (torch.nn.functional.pad(tk, (0, 0, 0, 0, 0, 3)),
              torch.nn.functional.pad(tv, (0, 0, 0, 0, 0, 3)))
    p1 = np.full((B, 1), S, np.int32)
    jo1, (jk1, _) = jlayers.gqa_fwd(ja, jnp.asarray(x1), jcfg, positions=jnp.asarray(p1),
                                    cache=jcache, cache_index=S)
    to1, (tk1, _) = layers.gqa_fwd(ta, torch.from_numpy(x1), cfg,
                                   positions=torch.from_numpy(p1), cache=tcache,
                                   cache_index=S)
    _close(jo1, to1)
    _close(jk1, tk1)
    assert tk1 is tcache[0]  # written in place


def test_gqa_decode_refuses_a_full_cache(rigs):
    """A decode write past the end of a full cache is the reference's
    `dynamic_update_slice`: clamped to the last row, every row valid (what
    `ServeEngine` meets with a prompt-long cache), not an error."""
    jcfg, cfg, jp, tp = _rig(rigs, "llama3_8b")
    ja, ta = _layer0(jp, tp, "attn")
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((1, 4, cfg.n_kv, cfg.d_head)).astype(np.float32)
            for _ in range(2))
    x = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    for index in (3, 4, 6):
        jo, (jk, jv) = jlayers.gqa_fwd(ja, jnp.asarray(x), jcfg,
                                       positions=jnp.full((1, 1), index, jnp.int32),
                                       cache=(jnp.asarray(k), jnp.asarray(v)),
                                       cache_index=index)
        to, (tk, tv) = layers.gqa_fwd(ta, torch.from_numpy(x), cfg,
                                      positions=torch.full((1, 1), index),
                                      cache=(torch.from_numpy(k.copy()),
                                             torch.from_numpy(v.copy())),
                                      cache_index=index)
        for j, t in ((jo, to), (jk, tk), (jv, tv)):
            _close(j, t)


@pytest.mark.parametrize("arch", DENSE)
def test_swiglu_matches_jax(rigs, arch):
    jcfg, cfg, jp, tp = _rig(rigs, arch)
    jf, tf = _layer0(jp, tp, "ffn")
    x = np.random.default_rng(4).standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    _close(jlayers.swiglu_fwd(jf, jnp.asarray(x), "float32"),
           layers.swiglu_fwd(tf, torch.from_numpy(x), "float32"))


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("arch", DENSE)
def test_init_params_has_reference_tree(rigs, arch):
    _, cfg, jp, _ = _rig(rigs, arch)
    tp = init_params(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(rigs, arch):
    jcfg, cfg, jp, tp = _rig(rigs, arch)
    toks = _tokens(cfg)
    jl, _ = jmodel.forward(jp, TrainBatch(tokens=jnp.asarray(toks), labels=jnp.asarray(toks)),
                           jcfg)
    _close(jl, forward(tp, torch.from_numpy(toks).long(), cfg))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_step_match_jax(rigs, arch):
    jcfg, cfg, jp, tp = _rig(rigs, arch)
    toks = _tokens(cfg, seed=5)
    jl, jc = jmodel.prefill(jp, jnp.asarray(toks[:, :-1]), jcfg)
    tl, tc = prefill(tp, torch.from_numpy(toks[:, :-1]).long(), cfg)
    _close(jl, tl)
    for j, t in zip(jc["layers"], tc["layers"]):
        _close(j, t)
    # decode the last token into caches grown by one row
    pad = [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]
    jc = {"layers": tuple(jnp.pad(c, pad) for c in jc["layers"])}
    cache = init_cache(cfg, B, S, "cpu")
    for full, part in zip(cache["layers"], tc["layers"]):
        full[:, :, :S - 1] = part
    jd, _ = jmodel.decode_step(jp, jc, jnp.asarray(toks[:, -1:]), S - 1, jcfg)
    td, _ = decode_step(tp, cache, torch.from_numpy(toks[:, -1:]).long(), S - 1, cfg)
    _close(jd, td)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(rigs, arch):
    """The port's tests/test_archs.py check: the full forward's logits at
    position t equal prefill(t tokens) -> decode of token t."""
    _, cfg, _, tp = _rig(rigs, arch)
    toks = torch.from_numpy(_tokens(cfg, seed=3, shape=(B, 32))).long()
    full = forward(tp, toks, cfg)
    t = 31
    logits_p, pre = prefill(tp, toks[:, :t], cfg)
    cache = init_cache(cfg, B, t + 1, "cpu")
    for c, p in zip(cache["layers"], pre["layers"]):
        c[:, :, :t] = p
    logits_d, _ = decode_step(tp, cache, toks[:, t:t + 1], t, cfg)
    a = torch.log_softmax(full[:, t].float(), -1)
    b = torch.log_softmax(logits_d.float(), -1)
    assert float((a - b).abs().max()) < 2e-2
    a = torch.log_softmax(full[:, t - 1].float(), -1)
    b = torch.log_softmax(logits_p.float(), -1)
    assert float((a - b).abs().max()) < 5e-2


# ---------------------------------------------------------------- convert
def test_from_jax_params_refuses_missing_and_unused_keys(rigs):
    _, cfg, jp, _ = _rig(rigs, "llama3_8b")
    np_params = _np(jp)
    extra = dict(np_params, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="stray"):
        from_jax_params(extra, cfg, "cpu")
    missing = dict(np_params, ln_f={})
    with pytest.raises(KeyError, match="ln_f/scale"):
        from_jax_params(missing, cfg, "cpu")
    bad = dict(np_params, ln_f={"scale": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="ln_f/scale"):
        from_jax_params(bad, cfg, "cpu")


def test_from_jax_params_widens_bf16_exactly():
    cfg = reduced("llama3_8b").with_(param_dtype="bfloat16")
    jp = jmodel.init_params(jax.random.PRNGKey(1), jreduced("llama3_8b").with_(
        param_dtype="bfloat16"))
    tp = from_jax_params(_np(jp), cfg, "cpu")
    w = tp["layers"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.float().numpy(),
                          np.asarray(jp["layers"]["attn"]["wq"], np.float32))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b", "xlstm_350m",
                                  "zamba2_1p2b", "internvl2_1b", "seamless_m4t_medium"])
def test_unported_families_raise(arch):
    cfg = reduced(arch)
    if cfg.family == "hybrid":   # trains (init, forward, loss) but does not serve
        params = init_params(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            prefill(params, torch.zeros((1, 8), dtype=torch.long), cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            init_cache(cfg, 1, 8, "cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        init_params(cfg, device="cpu")
