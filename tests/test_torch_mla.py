"""The port's multi-head latent attention (deepseek-v2) against the JAX
reference, on the CPU.

Reduced deepseek_v2_236b: 4 blocks of d_model 128 and 4 heads, MLA with
kv_lora 64, q_lora 96, d_nope 32, d_rope 16, d_v 32; MoE with 8 experts
top-2 plus 2 shared, a dense first block (`pre_layers`, d_first_dense 256)
and capacity factor 4.0 (nothing drops).  The reference's params are
carried over with `from_jax_params`, inputs are drawn with numpy from a
seed, and the reference runs compiled at its lowest backend optimisation
level and single-threaded (`_jit`), the port single-threaded.

Tolerances: in f32 a layer within 1e-5 (`mla_fwd`'s prefill and absorbed
decode, out and both cache leaves) and the whole model within 1e-4
(logits, every cache leaf, a train step's loss, grad norm and params,
AdamW eps 1e-3 as tests/test_torch_training.py explains); in bf16 2e-2 of
the largest magnitude; the port's decode against its own forward 2e-2 on
log-softmax (prefill's last logits 5e-2), `tests/test_archs.py`'s bounds.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, forward, from_jax_params,  # noqa: E402
                                init_cache, init_params, layers, model, prefill)
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.training import (AdamW, make_train_state, make_train_step,  # noqa: E402
                                  synthetic_batch)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

ARCH = "deepseek_v2_236b"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
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


def _rig(rigs, dtype="float32"):
    """(jcfg, cfg, reference params, the port's copy) of reduced deepseek-v2
    with params and compute in dtype."""
    if dtype not in rigs:
        jcfg = jreduced(ARCH).with_(param_dtype=dtype, compute_dtype=dtype)
        cfg = reduced(ARCH).with_(param_dtype=dtype, compute_dtype=dtype)
        jp = _jit(lambda key: jmodel.init_params(key, jcfg), jax.random.PRNGKey(0))
        rigs[dtype] = (jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu"))
    return rigs[dtype]


def _close(j, t, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _rel_close(j, t, tol=2e-2):
    """Within tol of the reference's largest magnitude (bf16)."""
    j = np.asarray(j, np.float32)
    err = np.abs(t.detach().float().numpy() - j).max()
    assert err <= tol * np.abs(j).max(), (err, np.abs(j).max())


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _x(cfg, B, S, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _attn0(jp, tp):
    """The first MoE block's attention params, both packages."""
    return (jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
            model._layer(tp["layers"]["attn"], 0))


def _cache_close(jcache, tcache, **tol):
    assert sorted(tcache) == sorted(jcache) == ["layers", "pre_layers"]
    for name, kv in tcache.items():
        for j, t in zip(jcache[name], kv, strict=True):
            assert tuple(t.shape) == tuple(j.shape), name
            _close(j, t, **tol)


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_matches_the_reference_tree(dtype):
    """`init_mla`'s keys, shapes and dtypes against `jax.eval_shape` of the
    reference's, alone and stacked (`lead`) as `init_params` stacks it."""
    jcfg = jreduced(ARCH).with_(param_dtype=dtype)
    cfg = reduced(ARCH).with_(param_dtype=dtype)
    jshapes = jax.eval_shape(lambda k: jlayers.init_mla(k, jcfg), jax.random.PRNGKey(0))
    for lead in ((), (3,)):
        tp = layers.init_mla(None, cfg, lead=lead)
        assert sorted(tp) == sorted(jshapes)
        for k, a in jshapes.items():
            assert tuple(tp[k].shape) == (*lead, *a.shape), k
            assert str(tp[k].dtype).removeprefix("torch.") == str(a.dtype), k
    assert tuple(tp["wkv_b"].shape) == (3, 64, 4, 32 + 32)


# ----------------------------------------------------------------- mla_fwd
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_jax(rigs, dtype):
    """The direct form: out and the latents (c_kv, k_rope) it returns."""
    jcfg, cfg, jp, tp = _rig(rigs, dtype)
    jattn, tattn = _attn0(jp, tp)
    jx, tx = _x(cfg, 2, 24, 1, dtype)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    jout, (jc, jr) = _jit(lambda p, a, q: jlayers.mla_fwd(p, a, jcfg, positions=q,
                                                          return_kv=True),
                          jattn, jx, jnp.asarray(pos))
    out, (c, r) = layers.mla_fwd(tattn, tx, cfg, positions=torch.from_numpy(pos.copy()),
                                 return_kv=True)
    assert out.dtype == c.dtype == r.dtype == getattr(torch, dtype)
    assert tuple(c.shape) == (2, 24, 64) and tuple(r.shape) == (2, 24, 16)
    for j, t in ((jout, out), (jc, c), (jr, r)):
        if dtype == "float32":
            _close(j, t, **LAYER_TOL)
        else:
            _rel_close(j, t)


# prefill rows, cache rows, decode index, query tokens: a step inside the
# cache, two query tokens at once, and a step past the cache's end, whose
# write the reference's dynamic_update_slice clamps to the last rows
DECODE_CASES = {"inside": (20, 24, 20, 1), "two_tokens": (20, 24, 21, 2),
                "clamped": (20, 22, 23, 1)}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_mla_absorbed_decode_matches_jax(rigs, case):
    """A prefill's latents in a cache of `rows` rows, then the absorbed
    decode at `index`: out and both cache leaves within 1e-5."""
    pre, rows, index, sq = DECODE_CASES[case]
    jcfg, cfg, jp, tp = _rig(rigs)
    jattn, tattn = _attn0(jp, tp)
    jx, tx = _x(cfg, 2, pre + sq, 2, "float32")
    pos = np.broadcast_to(np.arange(pre), (2, pre))
    _, (c, r) = layers.mla_fwd(tattn, tx[:, :pre], cfg, positions=torch.from_numpy(pos.copy()),
                               return_kv=True)
    cc = torch.zeros((2, rows, 64))
    cr = torch.zeros((2, rows, 16))
    cc[:, :pre], cr[:, :pre] = c, r
    jcache = (jnp.asarray(cc.numpy()), jnp.asarray(cr.numpy()))
    dpos = np.broadcast_to(np.arange(index, index + sq), (2, sq))
    jout, (jc, jr) = _jit(
        lambda p, a, q, cache: jlayers.mla_fwd(p, a, jcfg, positions=q, cache=cache,
                                               cache_index=index),
        jattn, jx[:, pre:], jnp.asarray(dpos), jcache)
    out, (tc, tr) = layers.mla_fwd(tattn, tx[:, pre:], cfg,
                                   positions=torch.from_numpy(dpos.copy()),
                                   cache=(cc, cr), cache_index=index)
    assert tc is cc and tr is cr                  # written in place
    for j, t in ((jout, out), (jc, tc), (jr, tr)):
        _close(j, t, **LAYER_TOL)
    start = min(index, rows - sq)
    assert bool(cc[:, start:start + sq].abs().sum(-1).gt(0).all())
    if case == "clamped":
        assert start == rows - 1 and bool(cc[:, pre:start].eq(0).all())


# ---------------------------------------------------------------- the model
def test_init_cache_matches_jax(rigs):
    jcfg, cfg, _, _ = _rig(rigs)
    jc, c = jmodel.init_cache(jcfg, 3, 16), init_cache(cfg, 3, 16, "cpu")
    assert sorted(c) == sorted(jc) == ["layers", "pre_layers"]
    for name in c:
        for j, t in zip(jc[name], c[name], strict=True):
            assert tuple(t.shape) == tuple(j.shape) and t.dtype == torch.float32
            assert not t.any()
    assert [tuple(t.shape) for t in c["layers"]] == [(3, 3, 16, 64), (3, 3, 16, 16)]


def test_forward_matches_jax(rigs):
    jcfg, cfg, jp, tp = _rig(rigs)
    toks = _tokens(cfg, 2, 24, seed=2)
    jl, jaux = _jit(lambda p, t: jmodel.forward(p, jmodel.TrainBatch(t, t), jcfg), jp,
                    jnp.asarray(toks))
    tl, aux = model._forward(tp, torch.from_numpy(toks).long(), cfg)
    _close(jl, tl)
    _close(jaux, aux, atol=1e-5, rtol=1e-5)
    assert torch.equal(forward(tp, torch.from_numpy(toks).long(), cfg), tl)


@pytest.mark.parametrize("block", [("pre_layers", 0), ("layers", 0), ("layers", 2)])
def test_block_matches_jax_in_bf16(rigs, block):
    """Each block in bf16 (MLA, then SwiGLU or the routed experts) on the
    same input as the reference's, the input the port's blocks before it
    give: within 2e-2 of the largest magnitude.  Whole-model bf16 logits
    are not compared: rounding differences that each block keeps small
    flip a top-k choice somewhere in the stack, and one token's expert
    changes its logits by far more (0.87 against a largest logit of 4.3
    on these tokens)."""
    jcfg, cfg, jp, tp = _rig(rigs, "bfloat16")
    toks = torch.from_numpy(_tokens(cfg, 2, 24, seed=2)).long()
    pos = torch.arange(24)[None].expand(2, 24)
    x = layers.embed(tp["embed"], toks, cfg)
    for name in model._stacks(tp):
        for i in range(model._n_layers(tp[name])):
            if (name, i) == block:
                jlp = jax.tree.map(lambda a, i=i: a[i], jp[name])
                jy = _jit(lambda p, a, q: jmodel._block_fwd(p, a, jcfg, positions=q,
                                                            moe_layer=name == "layers")[0],
                          jlp, jnp.asarray(x.float().numpy(), jnp.bfloat16),
                          jnp.asarray(pos.numpy()))
            x = model._block_fwd(model._layer(tp[name], i), x, cfg, positions=pos)[0]
            if (name, i) == block:
                assert x.dtype == torch.bfloat16
                return _rel_close(jy, x)


def test_prefill_and_greedy_decode_match_jax(rigs):
    """A 40-token prefill (logits, both latent leaves of both stacks), the
    leaves grown by N_DECODE rows, then N_DECODE greedy decode steps, each
    side feeding back its own argmax; the cache after them."""
    jcfg, cfg, jp, tp = _rig(rigs)
    toks = _tokens(cfg, 2, 40, seed=3)
    jl, jcache = _jit(lambda p, t: jmodel.prefill(p, t, jcfg), jp, jnp.asarray(toks))
    tl, tcache = prefill(tp, torch.from_numpy(toks).long(), cfg)
    _close(jl, tl)
    _cache_close(jcache, tcache)
    pad = [(0, 0), (0, 0), (0, N_DECODE), (0, 0)]
    jcache = {n: tuple(jnp.pad(c, pad) for c in kv) for n, kv in jcache.items()}
    tcache = {n: tuple(torch.nn.functional.pad(c, (0, 0, 0, N_DECODE)) for c in kv)
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


def test_decode_matches_forward(rigs):
    """Teacher-forced, as tests/test_archs.py: prefill of 31 tokens, every
    latent leaf grown by one row, a decode step of the 32nd against
    `forward` over all 32 (log-softmax within 2e-2), and prefill's last
    logits against `forward` at 31 (5e-2)."""
    _, cfg, _, tp = _rig(rigs)
    toks = torch.from_numpy(_tokens(cfg, 2, 32, seed=3)).long()
    full = forward(tp, toks, cfg)[..., :cfg.vocab].float()
    lp, cache = prefill(tp, toks[:, :31], cfg)
    cache = {n: tuple(torch.nn.functional.pad(c, (0, 0, 0, 1)) for c in kv)
             for n, kv in cache.items()}
    ld, _ = decode_step(tp, cache, toks[:, 31:], 31, cfg)
    for t, lg, bound in ((31, ld, 2e-2), (30, lp, 5e-2)):
        gap = torch.log_softmax(full[:, t], -1) - torch.log_softmax(lg.float(), -1)
        assert float(gap.abs().max()) < bound, t


# ------------------------------------------------------------- ServeEngine
def _serve(rigs, lens):
    jcfg, cfg, jp, tp = _rig(rigs)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lens]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    return (lambda: JServeEngine(jcfg, jp, max_seq=128).serve_batch(jreqs),
            lambda: ServeEngine(cfg, tp, max_seq=128, device="cpu").serve_batch(reqs),
            jreqs, reqs)


@pytest.mark.parametrize("lens", [(64, 50, 57), (80, 71, 66)])
def test_serve_engine_tokens_equal_jax(rigs, lens):
    """A batch padded to 64 or 80 tokens, at least kv_lora (64): both
    engines grow both latent leaves to max_seq and give the same tokens."""
    jserve, tserve, jreqs, reqs = _serve(rigs, lens)
    jserve()
    tserve()
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in jreqs]
    assert all(len(r.tokens_out) == 6 for r in reqs)


def test_serve_engine_batch_shorter_than_kv_lora_raises_in_both(rigs):
    """Padded to 32 tokens, under kv_lora: `_grow` grows only a leaf whose
    prompt axis is its largest, so c_kv (L, B, 32, 64) stays 32 rows while
    k_rope (L, B, 32, 16) grows to 128, and the absorbed decode adds score
    tensors of 32 and 128 columns.  The reference raises, and the port
    keeps its rule and raises too."""
    jserve, tserve, _, _ = _serve(rigs, (32, 20, 27))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jserve()
    with pytest.raises(RuntimeError, match=r"size of tensor a \(32\) must match .* \(128\)"):
        tserve()


# -------------------------------------------------------------- train step
def test_train_step_matches_jax(rigs):
    """One AdamW step (eps 1e-3): loss, grad norm, nll, aux and every
    param within 1e-4 of the reference's `make_train_step`."""
    jcfg, cfg, jp, tp = _rig(rigs)
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


def test_train_grads_match_jax_through_the_kernels_shapes(rigs, monkeypatch):
    """The gradients of one reduced train step (2 x 64 tokens, f32), leaf by
    leaf within 1e-4 of the reference's `jax.grad` of its `loss_fn` (its
    jnp path: the reference has no VJP of its own).  Every attention call
    on the way needs a gradient and has a shape the kernels take, forward
    and backward alike: (D, Dv) = (48, 32), in MLA_HEAD_DIMS beside the full
    width's (192, 128), so on the card each launches the hand-written
    forward and backward (chip_smoke's MLA training phases; the card cases
    of `tests/test_torch_gpu.py`)."""
    jcfg, cfg, jp, tp = _rig(rigs)
    jb = jsynthetic_batch(jcfg, 2, 64, step=1)
    tb = synthetic_batch(cfg, 2, 64, step=1, device="cpu")
    (jloss, _), jg = _jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                                              has_aux=True), jp, jb)
    calls, orig = [], fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain", lambda q, k, v, **kw: calls.append(
        (q, k, v)) or orig(q, k, v, **kw))
    live = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss, _ = model.loss_fn(live, tb, cfg)
    leaves = list(tree_leaves(live))
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    _close(jloss, loss)
    jax.tree.map(lambda j, t: _close(j, grads[id(t)]), jg, live)
    assert len(calls) == cfg.n_layers
    for q, k, v in calls:
        assert q.requires_grad and fa.supports(q, k, v)
        assert (q.shape[-1], v.shape[-1]) == (48, 32) in fa.MLA_HEAD_DIMS
    full = get_config(ARCH).mla
    assert (full.d_nope + full.d_rope, full.d_v) == (192, 128) in fa.MLA_HEAD_DIMS


# ---------------------------------------------------- launches and the CLI
def test_mla_launches_no_kernel_and_the_cli_serves_it(monkeypatch):
    """On the CPU MLA launches no kernel: its prefill's attention (Dv != D)
    takes flash_attention's plain version, once a layer and prefill (on
    the card its Dv != D instance, which chip_smoke phases 20 and 21
    count), and its decode, the absorbed einsums, reaches no attention
    function.  `launch.serve` serves reduced deepseek-v2 at a batch padded
    past kv_lora."""
    calls = {"flash_attention_plain": 0, "flash_decode_plain": 0}
    for mod, name in ((fa, "flash_attention_plain"), (fd, "flash_decode_plain")):
        orig = getattr(mod, name)

        def counted(*a, _o=orig, _n=name, **k):
            calls[_n] += 1
            return _o(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    before = (fa.flash_attention.launches, fd.flash_decode.launches)
    s = serve.main(["--arch", "deepseek-v2-236b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "72", "--min-prompt-len", "64",
                    "--max-new", "4", "--max-seq", "96"])
    assert s["arch"] == "deepseek-v2-236b" and [len(o) for o in s["outputs"]] == [4] * 3
    assert calls == {"flash_attention_plain": reduced(ARCH).n_layers, "flash_decode_plain": 0}
    assert (fa.flash_attention.launches, fd.flash_decode.launches) == before


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smokes_full_width_serve_cuts_only_depth():
    """chip_smoke phase 21's model, built on the meta device: deepseek-v2-
    236b's widths whole and 8 of its 60 layers (the dense first block, 7
    MoE blocks), 29.19e9 params in 58.39 GB; its batch of 8 prompts padded
    to 512 tokens, at least kv_lora; its decode step's byte bound, and the
    cache a token and layer takes against GQA's at these heads."""
    cs = _chip_smoke()
    full = get_config(ARCH)
    cfg = full.with_(n_layers=cs.MLA_LAYERS)
    params = init_params(cfg, device="meta")

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    assert (cfg.n_layers, full.n_layers, cfg.moe.first_dense) == (8, 60, 1)
    assert (cfg.d_model, cfg.n_heads, cfg.vocab) == (5120, 128, 102400)
    assert (cfg.mla.kv_lora, cfg.mla.q_lora, cfg.mla.d_nope, cfg.mla.d_rope,
            cfg.mla.d_v) == (512, 1536, 128, 64, 128)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared, cfg.moe.d_expert,
            cfg.moe.d_first_dense) == (160, 6, 2, 1536, 12288)
    assert sum(t.numel() for t in tree_leaves(params)) == 29_191_361_536
    assert (nbytes(params), nbytes(params["embed"]), nbytes(params["pre_layers"]),
            nbytes(params["layers"])) == (58_394_191_872, 2_097_152_000, 675_958_784,
                                          7 * 7_945_867_264)
    reqs = cs.mla_requests(cfg.vocab)
    lens = [len(r.prompt) for r in reqs]
    assert len(reqs) == 8 and max(lens) == lens[0] == 512 >= cfg.mla.kv_lora
    assert min(lens) >= 384 and {r.max_new_tokens for r in reqs} == {64}
    assert cs.MLA_MAX_SEQ == 576
    step = cs.mla_decode_step_bytes(cfg, params, 8, cs.MLA_MAX_SEQ)
    row = 8 * 8 * (512 + 64) * 2
    assert step == {"weight_bytes": 58_394_191_872 - (102400 - 8) * 5120 * 2,
                    "cache_read_bytes": row * 576, "row_bytes": row,
                    "bytes": 58_394_191_872 - (102400 - 8) * 5120 * 2 + row * 577}
    assert ((cfg.mla.kv_lora + cfg.mla.d_rope) * 2, 2 * cfg.n_kv * cfg.d_head * 2) == \
        (1152, 65536)
