"""Hybrid (zamba2) serving in the port against the JAX reference, on the CPU.

Reduced zamba2 in f32 (4 Mamba-2 layers, the shared block after every 2,
SSD chunk 32), the reference's params carried over with `from_jax_params`,
the same numpy inputs on both sides.  The reference runs compiled at its
lowest backend optimisation level and single-threaded (`_jit`), the port
single-threaded (`pinned_threads`), as in `tests/test_torch_ssm.py`.

Tolerances: `ssd_step` 1e-5 (one f32 recurrence step); the Mamba-2 block,
`prefill` (logits and every cache leaf) and greedy `decode_step` logits
1e-4 (chains of f32 sums in another order; the SSD gates round at ~3e-5,
see ROADMAP queue 3), with greedy tokens equal; the port's decode against
its own forward 5e-2 on log-softmax, the reference's `tests/test_archs.py`
bound for recurrent families.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (decode_step, forward, from_jax_params,  # noqa: E402
                                init_cache, prefill, ssm)
from repro_torch.models.config import torch_dtype  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
N_DECODE = 8


def _compiled(fn, *args):
    """fn compiled for args' shapes at XLA's lowest backend optimisation
    level, its contractions single-threaded (see tests/test_torch_ssm.py)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_cpu_multi_thread_eigen": False})


def _jit(fn, *args):
    return _compiled(fn, *args)(*args)


@pytest.fixture(autouse=True)
def pinned_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(j, t, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _leaves_close(jtree, ttree, **tol):
    """Every leaf, in pytree order (the two packages' MambaState classes
    differ, so the trees are compared leaf by leaf)."""
    jl, tl = jax.tree.leaves(jtree), jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape)
        _close(j, t, **tol)


@pytest.fixture(scope="module")
def rig():
    jcfg, cfg = jreduced("zamba2_1p2b"), reduced("zamba2_1p2b")
    jp = _jit(lambda key: jmodel.init_params(key, jcfg), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


# ------------------------------------------------------------------ ssd_step
@pytest.mark.parametrize("b,h,p,n", [(2, 8, 32, 16), (3, 4, 64, 64)])
def test_ssd_step_matches_jax(b, h, p, n):
    rng = np.random.default_rng(b * h + p + n)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    arrs = (f(b, h, p, n), f(b, h, p), np.abs(f(b, h)), -np.abs(f(h)), f(b, n), f(b, n), f(h))
    jst, jy = _jit(jops.ssd_step, *map(jnp.asarray, arrs))
    st, y = ops.ssd_step(*map(torch.from_numpy, arrs))
    assert st.dtype == y.dtype == torch.float32
    _close(jst, st, atol=1e-5, rtol=1e-5)
    _close(jy, y, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------- state and cache layout
@pytest.mark.parametrize("batch,max_seq", [(1, 8), (3, 72)])
def test_init_state_and_cache_match_jax(rig, batch, max_seq):
    jcfg, cfg, _, _ = rig
    jst, st = jssm.init_mamba_state(jcfg, batch), ssm.init_mamba_state(cfg, batch, "cpu")
    jc, c = jmodel.init_cache(jcfg, batch, max_seq), init_cache(cfg, batch, max_seq, "cpu")
    assert sorted(c) == sorted(jc) == ["attn", "mamba"]
    assert type(st).__name__ == type(jst).__name__ and st._fields == jst._fields
    assert c["mamba"]._fields == jc["mamba"]._fields
    for j, t in zip(jax.tree.leaves((jst, jc)), jax.tree.leaves((st, c))):
        assert tuple(t.shape) == tuple(j.shape)
        assert t.dtype == torch_dtype(str(j.dtype))
        assert not t.any()


# ----------------------------------------------------------- the Mamba-2 block
def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]),
            {k: v[0] for k, v in tp["layers"].items()})


def test_mamba2_fwd_return_state_matches_jax(rig):
    jcfg, cfg, jp, tp = rig
    jlp, tlp = _layer0(jp, tp)
    x = np.random.default_rng(8).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    jy, jst = _jit(lambda p, a: jssm.mamba2_fwd(p, a, jcfg, return_state=True),
                   jlp, jnp.asarray(x))
    y, st = ssm.mamba2_fwd(tlp, torch.from_numpy(x), cfg, return_state=True)
    assert isinstance(st, ssm.MambaState) and st.ssm.dtype == torch.float32
    _close(jy, y)
    _leaves_close(jst, st)


def test_mamba2_fwd_with_state_matches_jax(rig):
    jcfg, cfg, jp, tp = rig
    jlp, tlp = _layer0(jp, tp)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    st = [rng.standard_normal(t.shape).astype(np.float32)
          for t in ssm.init_mamba_state(cfg, 2, "cpu")]
    jy, jst2 = _jit(lambda p, a, *s: jssm.mamba2_fwd(p, a, jcfg, state=jssm.MambaState(*s)),
                    jlp, jnp.asarray(x), *map(jnp.asarray, st))
    y, st2 = ssm.mamba2_fwd(tlp, torch.from_numpy(x), cfg,
                            state=ssm.MambaState(*map(torch.from_numpy, st)))
    _close(jy, y)
    _leaves_close(jst2, st2)


# ------------------------------------------------------------ prefill + decode
@pytest.fixture(scope="module")
def served(rig):
    """Prefill of a 64-token prompt (two SSD chunks, so the state is passed
    between them), the attention caches grown by N_DECODE rows as
    tests/test_archs.py grows them, then N_DECODE greedy decode steps, each
    side feeding back its own argmax.  Returns both sides' prefill output,
    and each step's logits and tokens."""
    jcfg, cfg, jp, tp = rig
    toks = _tokens(cfg, 2, 64)
    jpre = _jit(lambda p, t: jmodel.prefill(p, t, jcfg), jp, jnp.asarray(toks))
    tpre = prefill(tp, torch.from_numpy(toks).long(), cfg)
    pad = [(0, 0), (0, 0), (0, N_DECODE), (0, 0), (0, 0)]
    jcache = {"mamba": jpre[1]["mamba"],
              "attn": tuple(jnp.pad(c, pad) for c in jpre[1]["attn"])}
    tcache = {"mamba": ssm.MambaState(*(t.clone() for t in tpre[1]["mamba"])),
              "attn": tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, N_DECODE))
                            for c in tpre[1]["attn"])}
    jdec = _compiled(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, jcfg),
                     jp, jcache, jnp.zeros((2, 1), jnp.int32), jnp.int32(0))
    jtok = jnp.argmax(jpre[0], -1).astype(jnp.int32)
    ttok = tpre[0].argmax(-1)
    steps = []
    for i in range(N_DECODE):
        jl, jcache = jdec(jp, jcache, jtok[:, None], jnp.int32(64 + i))
        tl, tcache = decode_step(tp, tcache, ttok[:, None], 64 + i, cfg)
        steps.append((jl, tl, np.asarray(jtok).tolist(), ttok.tolist()))
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1)
    return toks, jpre, tpre, steps, (jcache, tcache)


def test_prefill_matches_jax(served):
    _, (jl, jcache), (tl, tcache), _, _ = served
    _close(jl, tl)
    assert sorted(tcache) == ["attn", "mamba"]
    _leaves_close(jcache, tcache)


def test_greedy_decode_matches_jax(served):
    _, _, _, steps, (jcache, tcache) = served
    for jl, tl, jtok, ttok in steps:
        assert ttok == jtok
        _close(jl, tl)
    _leaves_close(jcache, tcache)


def test_decode_matches_forward(rig):
    """Teacher-forced, as tests/test_archs.py: the port's prefill of 24
    tokens and 8 decode steps of the next true tokens against its own
    forward over all 32 (one chunk), log-softmax within 5e-2."""
    _, cfg, _, tp = rig
    toks = torch.from_numpy(_tokens(cfg, 2, 32, seed=3)).long()
    full = forward(tp, toks, cfg)[..., :cfg.vocab].float()
    lg, cache = prefill(tp, toks[:, :24], cfg)
    cache["attn"] = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 8))
                          for c in cache["attn"])
    outs = [lg]
    for t in range(24, 32):
        lg, cache = decode_step(tp, cache, toks[:, t:t + 1], t, cfg)
        outs.append(lg)
    for i, lg in enumerate(outs):
        a = torch.log_softmax(full[:, 23 + i], -1)
        b = torch.log_softmax(lg.float(), -1)
        assert float((a - b).abs().max()) < 5e-2, i


@pytest.mark.parametrize("S", [24, 32])
def test_prompts_up_to_one_chunk_match_jax(rig, S):
    """Prompts no longer than the SSD chunk run as one chunk of their own
    length, as the reference's `_ssd_jnp` takes min(chunk, s)."""
    jcfg, cfg, jp, tp = rig
    toks = _tokens(cfg, 2, S, seed=S)
    jl, jcache = _jit(lambda p, t: jmodel.prefill(p, t, jcfg), jp, jnp.asarray(toks))
    tl, tcache = prefill(tp, torch.from_numpy(toks).long(), cfg)
    _close(jl, tl)
    _leaves_close(jcache, tcache)


def test_prompt_longer_than_a_chunk_must_be_a_multiple_of_it(rig):
    """40 tokens at chunk 32: the reference asserts (`ops.py:274`), and so
    does the port."""
    jcfg, cfg, jp, tp = rig
    toks = _tokens(cfg, 1, 40)
    with pytest.raises(AssertionError, match="not divisible"):
        _jit(lambda p, t: jmodel.prefill(p, t, jcfg), jp, jnp.asarray(toks))
    with pytest.raises(AssertionError, match="not divisible"):
        prefill(tp, torch.from_numpy(toks).long(), cfg)


def test_tail_layers_match_jax():
    """5 layers at attn_every 2: two groups and one tail layer with no
    shared block after it (zamba2-1.2b has 38 = 6 x 6 + 2): prefill and 2
    greedy decode steps against the reference."""
    jcfg = jreduced("zamba2_1p2b").with_(n_layers=5)
    cfg = reduced("zamba2_1p2b").with_(n_layers=5)
    jp = _jit(lambda key: jmodel.init_params(key, jcfg), jax.random.PRNGKey(1))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = _tokens(cfg, 2, 32, seed=5)
    jl, jcache = _jit(lambda p, t: jmodel.prefill(p, t, jcfg), jp, jnp.asarray(toks))
    tl, tcache = prefill(tp, torch.from_numpy(toks).long(), cfg)
    assert tcache["mamba"].ssm.shape[0] == 5 and tcache["attn"][0].shape[0] == 2
    _close(jl, tl)
    _leaves_close(jcache, tcache)
    pad = [(0, 0), (0, 0), (0, 2), (0, 0), (0, 0)]
    jcache = {"mamba": jcache["mamba"], "attn": tuple(jnp.pad(c, pad) for c in jcache["attn"])}
    tcache["attn"] = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 2))
                           for c in tcache["attn"])
    jdec = _compiled(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, jcfg),
                     jp, jcache, jnp.zeros((2, 1), jnp.int32), jnp.int32(0))
    tok = tl.argmax(-1)
    for i in range(2):
        jl, jcache = jdec(jp, jcache, jnp.asarray(tok.numpy()[:, None], jnp.int32),
                          jnp.int32(32 + i))
        tl, tcache = decode_step(tp, tcache, tok[:, None], 32 + i, cfg)
        _close(jl, tl)
        tok = tl.argmax(-1)
        assert tok.tolist() == np.asarray(jnp.argmax(jl, -1)).tolist()
    _leaves_close(jcache, tcache)
