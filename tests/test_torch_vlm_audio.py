"""The port's VLM (internvl2-1b) and encoder-decoder audio
(seamless-m4t-medium) families against the JAX reference, on the CPU.

Reduced configs: internvl2 is 4 dense GQA blocks of d_model 128, 4 heads
over 2 kv heads of 32, with 8 patch embeddings projected by `patch_proj`
before the text; seamless is 2 non-causal encoder blocks over 32 frame
embeddings and 4 decoder blocks (self-attention, cross-attention,
SwiGLU), 4 heads over 4 kv heads of 32.  The reference's params are
carried over with `from_jax_params`, inputs are drawn with numpy from a
seed, and the reference runs compiled at its lowest backend optimisation
level and single-threaded (`_jit`), the port single-threaded.

Tolerances, f32: a layer within 1e-5 (`gqa_fwd` in cross mode,
`_dec_block_fwd` in prefill and decode), the whole model within 1e-4
(logits, loss, every cache leaf, a train step's loss, grad norm and
params, AdamW eps 1e-3 as tests/test_torch_training.py explains); the
port's decode against its own forward 2e-2 on log-softmax (prefill's last
logits 5e-2), `tests/test_archs.py`'s bounds.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models import dist as jdist  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import make_train_state as jmake_state  # noqa: E402
from repro.training import make_train_step as jmake_step  # noqa: E402
from repro.training import synthetic_batch as jsynthetic_batch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import (TrainBatch, decode_step, forward,  # noqa: E402
                                from_jax_params, init_cache, init_params, layers,
                                loss_fn, model, prefill)
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.training import (AdamW, make_train_state, make_train_step,  # noqa: E402
                                  synthetic_batch)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

VLM, AUDIO = "internvl2_1b", "seamless_m4t_medium"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 24
N_DECODE = 6


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
    """The reference's sharding constraints are no-ops without a mesh;
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


def _rig(rigs, arch):
    """(jcfg, cfg, reference params, the port's copy) of the reduced arch."""
    if arch not in rigs:
        jcfg, cfg = jreduced(arch), reduced(arch)
        jp = _jit(lambda key: jmodel.init_params(key, jcfg), jax.random.PRNGKey(0))
        rigs[arch] = (jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu"))
    return rigs[arch]


def _close(j, t, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _tokens(cfg, shape=(B, S), seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _extra(cfg, batch=B, seed=1):
    """The patch (VLM) or frame (audio) embeddings, as the reference's
    tests/test_archs.py draws them: N(0, 1) * 0.02, f32."""
    rows = cfg.n_patches if cfg.family == "vlm" else cfg.enc_len
    return (np.random.default_rng(seed).standard_normal((batch, rows, cfg.d_model))
            * 0.02).astype(np.float32)


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(cache):
    """A cache's leaves in a fixed order, with their names."""
    out = []
    for name in sorted(cache):
        leaf = cache[name]
        for i, t in enumerate(leaf if isinstance(leaf, tuple) else (leaf,)):
            out.append((f"{name}[{i}]", t))
    return out


def _cache_close(jcache, tcache, **tol):
    jl, tl = _leaves(jcache), _leaves(tcache)
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (name, j), (_, t) in zip(jl, tl, strict=True):
        assert tuple(t.shape) == tuple(j.shape), name
        _close(j, t, **tol)


# ------------------------------------------------------------------ layers
def test_gqa_cross_attention_matches_jax(rigs):
    """`gqa_fwd` with kv_source: k and v from the encoder's memory, no RoPE
    on q or k (positions far from 0 must not matter), every query sees
    every row: out within 1e-5, and no cache comes back."""
    jcfg, cfg, jp, tp = _rig(rigs, AUDIO)
    jx = jax.tree.map(lambda a: a[1], jp["layers"]["xattn"])
    tx = model._layer(tp["layers"]["xattn"], 1)
    x, enc = _x(cfg, (B, 5), 2), _x(cfg, (B, cfg.enc_len), 3)
    pos = np.broadcast_to(np.arange(100, 105), (B, 5))
    jo, jc = _jit(lambda p, a, e, q: jlayers.gqa_fwd(p, a, jcfg, positions=q, kv_source=e,
                                                     causal=False),
                  jx, jnp.asarray(x), jnp.asarray(enc), jnp.asarray(pos))
    to, tc = layers.gqa_fwd(tx, _t(x), cfg, positions=_t(pos), kv_source=_t(enc))
    assert jc is None and tc is None
    _close(jo, to, **LAYER_TOL)
    again, _ = layers.gqa_fwd(tx, _t(x), cfg, positions=_t(pos * 0), kv_source=_t(enc))
    assert torch.equal(again, to)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_dec_block_matches_jax(rigs, mode):
    """One decoder block: in prefill (`return_kv`) out and the (k, v) it
    returns; in decode, a step at index 9 against a cache of 12 rows whose
    first 9 hold a prefill's k/v: out and both cache leaves, within
    1e-5."""
    jcfg, cfg, jp, tp = _rig(rigs, AUDIO)
    jlp = jax.tree.map(lambda a: a[2], jp["layers"])
    tlp = model._layer(tp["layers"], 2)
    enc = _x(cfg, (B, cfg.enc_len), 4)
    if mode == "prefill":
        x = _x(cfg, (B, 9), 5)
        pos = np.broadcast_to(np.arange(9), (B, 9))
        jo, (jk, jv) = _jit(lambda p, a, e, q: jmodel._dec_block_fwd(
            p, a, e, jcfg, positions=q, return_kv=True), jlp, jnp.asarray(x),
            jnp.asarray(enc), jnp.asarray(pos))
        to, (tk, tv) = model._dec_block_fwd(tlp, _t(x), _t(enc), cfg, positions=_t(pos),
                                            return_kv=True)
    else:
        rng = np.random.default_rng(6)
        ck, cv = (np.zeros((B, 12, cfg.n_kv, cfg.d_head), np.float32) for _ in range(2))
        ck[:, :9], cv[:, :9] = (rng.standard_normal((B, 9, cfg.n_kv, cfg.d_head))
                                for _ in range(2))
        x = _x(cfg, (B, 1), 7)
        pos = np.full((B, 1), 9)
        jo, (jk, jv) = _jit(lambda p, a, e, q, c: jmodel._dec_block_fwd(
            p, a, e, jcfg, positions=q, cache=c, cache_index=9), jlp, jnp.asarray(x),
            jnp.asarray(enc), jnp.asarray(pos), (jnp.asarray(ck), jnp.asarray(cv)))
        tck, tcv = _t(ck.copy()), _t(cv.copy())
        to, (tk, tv) = model._dec_block_fwd(tlp, _t(x), _t(enc), cfg, positions=_t(pos),
                                            cache=(tck, tcv), cache_index=9)
        assert tk is tck and tv is tcv                # written in place
    for j, t in ((jo, to), (jk, tk), (jv, tv)):
        _close(j, t, **LAYER_TOL)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("arch,step", [(VLM, 0), (AUDIO, 5), ("llama3_8b", 3)])
def test_synthetic_batch_extra_matches_jax(arch, step):
    """`extra` bit for bit: the patch or frame draws follow the tokens'
    from the same generator.  A dense config's batch has no extra and its
    tokens are the reference's."""
    jb = jsynthetic_batch(jreduced(arch), 3, 40, seed=2, step=step)
    tb = synthetic_batch(reduced(arch), 3, 40, seed=2, step=step, device="cpu")
    assert np.array_equal(np.asarray(jb.tokens), tb.tokens.numpy())
    assert np.array_equal(np.asarray(jb.labels), tb.labels.numpy())
    if jb.extra is None:
        assert tb.extra is None and reduced(arch).family == "dense"
        return
    assert tb.extra.dtype == torch.float32
    assert np.array_equal(np.asarray(jb.extra), tb.extra.numpy())
    cfg = reduced(arch)
    rows = cfg.n_patches if cfg.family == "vlm" else cfg.enc_len
    assert tuple(tb.extra.shape) == (3, rows, cfg.d_model)


# ------------------------------------------------------------------ model
def test_init_cache_matches_jax(rigs):
    """The audio cache: {"self": (k, v), "enc"}, zero, the reference's
    shapes; the VLM's is the dense layout."""
    for arch in (VLM, AUDIO):
        jcfg, cfg, _, _ = _rig(rigs, arch)
        jc, c = jmodel.init_cache(jcfg, 3, 16), init_cache(cfg, 3, 16, "cpu")
        assert [n for n, _ in _leaves(c)] == [n for n, _ in _leaves(jc)]
        for (_, j), (_, t) in zip(_leaves(jc), _leaves(c)):
            assert tuple(t.shape) == tuple(j.shape) and t.dtype == torch.float32
            assert not t.any()
    assert tuple(c["enc"].shape) == (3, cfg.enc_len, cfg.d_model)


FORWARD_CASES = {"vlm_patches": (VLM, True), "vlm_text": (VLM, False), "audio": (AUDIO, True)}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_and_loss_match_jax(rigs, case):
    """Logits over the text rows (the patch rows dropped) and loss_fn's
    loss, nll and z-loss, within 1e-4."""
    arch, with_extra = FORWARD_CASES[case]
    jcfg, cfg, jp, tp = _rig(rigs, arch)
    toks = _tokens(cfg, seed=2)
    labels = np.roll(toks, -1, axis=1)
    extra = _extra(cfg) if with_extra else None
    jb = jmodel.TrainBatch(jnp.asarray(toks), jnp.asarray(labels),
                           None if extra is None else jnp.asarray(extra))
    tb = TrainBatch(_t(toks).long(), _t(labels).long(), None if extra is None else _t(extra))
    jl, _ = _jit(lambda p, b: jmodel.forward(p, b, jcfg), jp, jb)
    (jloss, jm) = _jit(lambda p, b: jmodel.loss_fn(p, b, jcfg), jp, jb)
    tl = forward(tp, tb.tokens, cfg, tb.extra)
    assert tuple(tl.shape) == (B, S, cfg.padded_vocab)
    _close(jl, tl)
    loss, m = loss_fn(tp, tb, cfg)
    _close(jloss, loss)
    for k in ("nll", "zloss"):
        _close(jm[k], m[k])


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prefill_and_greedy_decode_match_jax(rigs, arch):
    """A prefill with `extra` (logits and every cache leaf: the VLM's
    layers over P + S rows, the audio model's self-attention k/v and its
    encoder memory), the self-attention leaves grown by N_DECODE rows, then
    N_DECODE greedy decode steps, each side feeding back its own argmax:
    logits, tokens, and the cache after them, within 1e-4."""
    jcfg, cfg, jp, tp = _rig(rigs, arch)
    toks, extra = _tokens(cfg, seed=3), _extra(cfg, seed=4)
    jl, jcache = _jit(lambda p, t, e: jmodel.prefill(p, t, jcfg, extra=e), jp,
                      jnp.asarray(toks), jnp.asarray(extra))
    tl, tcache = prefill(tp, _t(toks).long(), cfg, extra=_t(extra))
    _close(jl, tl)
    _cache_close(jcache, tcache)
    rows = S + (cfg.n_patches if arch == VLM else 0)
    name = "layers" if arch == VLM else "self"
    assert tcache[name][0].shape[2] == rows
    pad = [(0, 0), (0, 0), (0, N_DECODE), (0, 0), (0, 0)]
    jcache = dict(jcache, **{name: tuple(jnp.pad(c, pad) for c in jcache[name])})
    tcache[name] = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, N_DECODE))
                         for c in tcache[name])
    enc = tcache.get("enc")
    jdec = _compiled(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, jcfg),
                     jp, jcache, jnp.zeros((B, 1), jnp.int32), jnp.int32(0))
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1)
    for i in range(N_DECODE):
        assert ttok.tolist() == np.asarray(jtok).tolist()
        jl, jcache = jdec(jp, jcache, jtok[:, None], jnp.int32(rows + i))
        tl, tcache = decode_step(tp, tcache, ttok[:, None], rows + i, cfg)
        _close(jl, tl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    _cache_close(jcache, tcache)
    if enc is not None:
        assert tcache["enc"] is enc                   # the step leaves it as it is


def test_vlm_decode_matches_forward(rigs):
    """The port's tests/test_archs.py `test_decode_matches_forward` for
    the VLM: prefill of 31 text tokens after the patches, every cache leaf
    grown by one row, the decode step of the 32nd at position P + 31
    against `forward` over all 32 (log-softmax within 2e-2), and prefill's
    last logits against `forward` at 30 (5e-2)."""
    _, cfg, _, tp = _rig(rigs, VLM)
    toks = _t(_tokens(cfg, (B, 32), seed=3)).long()
    extra = _t(_extra(cfg))
    full = forward(tp, toks, cfg, extra).float()
    t = 31
    plen = cfg.n_patches + t
    lp, cache = prefill(tp, toks[:, :t], cfg, extra=extra)
    cache = {n: tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1)) for c in kv)
             for n, kv in cache.items()}
    ld, _ = decode_step(tp, cache, toks[:, t:t + 1], plen, cfg)
    for i, lg, bound in ((t, ld, 2e-2), (t - 1, lp, 5e-2)):
        gap = torch.log_softmax(full[:, i], -1) - torch.log_softmax(lg.float(), -1)
        assert float(gap.abs().max()) < bound, i


def test_encdec_prefill_decode(rigs):
    """The port's tests/test_archs.py `test_encdec_prefill_decode`: prefill
    of 31 tokens over the frames, "self" grown by one row, the decode step
    of the 32nd against `forward` over all 32 (2e-2); prefill's last
    logits against `forward` at 30 (5e-2)."""
    _, cfg, _, tp = _rig(rigs, AUDIO)
    toks = _t(_tokens(cfg, (B, 32), seed=4)).long()
    extra = _t(_extra(cfg))
    full = forward(tp, toks, cfg, extra).float()
    t = 31
    lp, cache = prefill(tp, toks[:, :t], cfg, extra=extra)
    cache["self"] = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1))
                          for c in cache["self"])
    ld, _ = decode_step(tp, cache, toks[:, t:t + 1], t, cfg)
    for i, lg, bound in ((t, ld, 2e-2), (t - 1, lp, 5e-2)):
        gap = torch.log_softmax(full[:, i], -1) - torch.log_softmax(lg.float(), -1)
        assert float(gap.abs().max()) < bound, i


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_train_step_matches_jax(rigs, arch):
    """One AdamW step (eps 1e-3) over 2 microbatches, `extra` split with
    the batch: loss, grad norm, nll and every param within 1e-4 of the
    reference's `make_train_step`."""
    jcfg, cfg, jp, tp = _rig(rigs, arch)
    kw = dict(lr=1e-3, eps=1e-3, warmup=2, total_steps=10)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jb = jsynthetic_batch(jcfg, 4, 32, step=3)
    tb = synthetic_batch(cfg, 4, 32, step=3, device="cpu")
    jstate, jm = _jit(jmake_step(jcfg, jopt, microbatches=2), jmake_state(jp, jopt), jb)
    state, m = make_train_step(cfg, opt, microbatches=2)(
        make_train_state(jax.tree.map(lambda t: t.clone(), tp), opt), tb)
    for k in ("loss", "grad_norm", "nll"):
        _close(jm[k], m[k])
    jax.tree.map(_close, jstate.params, state.params)


# -------------------------------------------------------------- ServeEngine
@pytest.mark.parametrize("lens", [(40, 33, 36), (24, 20, 17)])
def test_serve_engine_vlm_tokens_equal_jax(rigs, lens):
    """Both engines serve the VLM's text alone.  Padded to 40 tokens (at
    least d_head 32) the cache grows to max_seq; padded to 24 it stays
    prompt-long in both (`_grow` grows only a leaf whose prompt axis is its
    largest), and each decode step overwrites the last prompt row in both:
    the tokens are equal either way."""
    jcfg, cfg, jp, tp = _rig(rigs, VLM)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lens]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    JServeEngine(jcfg, jp, max_seq=64).serve_batch(jreqs)
    ServeEngine(cfg, tp, max_seq=64, device="cpu").serve_batch(reqs)
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in jreqs]
    assert all(len(r.tokens_out) == 6 for r in reqs)


def test_serve_engine_refuses_audio_in_both(rigs):
    jcfg, cfg, jp, tp = _rig(rigs, AUDIO)
    msg = "ServeEngine drives attention-family LMs; recurrent archs serve via decode_step"
    with pytest.raises(NotImplementedError, match=msg):
        JServeEngine(jcfg, jp)
    with pytest.raises(NotImplementedError, match=msg):
        ServeEngine(cfg, tp, device="cpu")


# --------------------------------------------------- launches and the CLIs
def _count_plain_calls(monkeypatch):
    """Count the calls of each attention kernel's plain version (on the
    card, the kernel's launches) and of the plain non-causal attention."""
    calls = {"flash_attention": 0, "flash_decode": 0, "naive_attention": 0}
    for mod, name, key in ((fa, "flash_attention_plain", "flash_attention"),
                           (fd, "flash_decode_plain", "flash_decode")):
        orig = getattr(mod, name)

        def counted(*a, _o=orig, _k=key, **k):
            calls[_k] += 1
            return _o(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    from repro_torch.kernels import ops
    orig = ops.naive_attention

    def naive(*a, **k):
        calls["naive_attention"] += 1
        return orig(*a, **k)
    monkeypatch.setattr(ops, "naive_attention", naive)
    return calls


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_attention_calls_match_chip_smokes_count(rigs, monkeypatch, arch):
    """chip_smoke phases 23-25 hold the kernels' launches to these counts:
    a prefill runs flash_attention once a (decoder) layer, a decode step
    flash_decode once a layer; the audio encoder's self-attention and every
    cross-attention take the plain non-causal path (jnp in the reference);
    a train step launches what `train_launches` predicts (remat "full")."""
    _, cfg, _, tp = _rig(rigs, arch)
    calls = _count_plain_calls(monkeypatch)
    extra = _t(_extra(cfg))
    with torch.no_grad():
        lg, cache = prefill(tp, _t(_tokens(cfg)).long(), cfg, extra=extra)
    L = cfg.n_layers
    cross = L if arch == AUDIO else 0
    assert calls == {"flash_attention": L, "flash_decode": 0,
                     "naive_attention": cross + (cfg.n_enc_layers if arch == AUDIO else 0)}
    name = "layers" if arch == VLM else "self"
    cache[name] = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 2)) for c in cache[name])
    rows = cache[name][0].shape[2] - 2
    with torch.no_grad():
        decode_step(tp, cache, lg.argmax(-1)[:, None], rows, cfg)
    assert calls == {"flash_attention": L, "flash_decode": L,
                     "naive_attention": 2 * cross + (cfg.n_enc_layers if arch == AUDIO else 0)}
    for k in calls:
        calls[k] = 0
    rcfg = cfg.with_(remat="full")
    opt = AdamW()
    make_train_step(rcfg, opt, microbatches=2)(
        make_train_state(jax.tree.map(lambda t: t.clone(), tp), opt),
        synthetic_batch(rcfg, 2, 16, device="cpu"))
    want = _chip_smoke().train_launches(rcfg, microbatches=2)
    assert calls["flash_attention"] == want["flash_attention"] == 2 * 2 * L
    assert calls["flash_decode"] == 0 and want["ssd_scan"] == 0


@pytest.mark.parametrize("arch", ["internvl2-1b", "seamless-m4t-medium"])
def test_train_cli_runs_on_cpu(arch):
    s = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "32", "--microbatches", "2"])
    assert s["steps"] == 2 and len(s["losses"]) == 2
    assert all(math.isfinite(x) for x in s["losses"] + s["grad_norms"])
    assert abs(s["losses"][0] - math.log(512)) < 1.0


def test_serve_cli_serves_the_vlm_on_cpu():
    s = serve.main(["--arch", "internvl2-1b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "40", "--min-prompt-len", "34",
                    "--max-new", "4", "--max-seq", "64"])
    assert s["arch"] == "internvl2-1b" and [len(o) for o in s["outputs"]] == [4] * 3
    with pytest.raises(NotImplementedError, match="attention-family"):
        serve.main(["--arch", "seamless-m4t-medium", "--reduced", "--device", "cpu"])


# ------------------------------------------------- the full-width models
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,n_params", [(VLM, 630_483_840), (AUDIO, 977_860_608)])
def test_full_width_models_on_the_meta_device(arch, n_params):
    """The models chip_smoke phases 23-25 build, on the meta device: the
    reference's tree and shapes (`jax.eval_shape`), whole depth, and the
    parameter count of their leaves; both fit on one card with room for
    AdamW."""
    cfg = get_config(arch)
    params = init_params(cfg, device="meta")
    jshapes = jax.eval_shape(lambda k: jmodel.init_params(k, jconfigs.get_config(arch)),
                             jax.random.PRNGKey(0))
    jflat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tflat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [(p, tuple(a.shape)) for p, a in jflat] == [(p, tuple(t.shape)) for p, t in tflat]
    assert sum(t.numel() for t in tree_leaves(params)) == n_params
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params))
