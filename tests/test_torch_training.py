"""The port's training slice against the JAX reference, on the CPU.

Reduced zamba2 (the hybrid Mamba-2 family) and reduced llama3_8b (dense):
JAX-initialised params go through `from_jax_params`, batches come from
`synthetic_batch` (numpy seeded by (seed, step) in both packages), and every
comparison is in float32.  Tolerances: 1e-4 (atol and rtol) for logits,
losses, gradients and the grad norm (f32 sums in another order); 1e-5 for
the state after one AdamW step (params, m, v, error feedback) and its lr,
since an update is a small step from the same params; < 1e-6 for a restart
against an uninterrupted run (the same arithmetic).

The reference runs compiled (`_jit`), as its own train loop runs it.
"""
import functools
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
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import make_train_state as jmake_state  # noqa: E402
from repro.training import make_train_step as jmake_step  # noqa: E402
from repro.training import synthetic_batch as jsynthetic_batch  # noqa: E402
from repro.training import train_step as jtrain_step  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import (from_jax_params, init_cache, init_params,  # noqa: E402
                                loss_fn, prefill)
from repro_torch.models import model  # noqa: E402
from repro_torch.training import (AdamW, checkpoint, make_train_state,  # noqa: E402
                                  make_train_step, stream, synthetic_batch)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 4, 64   # two SSD chunks of 32 in reduced zamba2


@pytest.fixture(scope="module", autouse=True)
def no_mesh():
    """The reference's sharding constraints are no-ops without a mesh;
    make sure no other test module left one set."""
    saved = (jdist.get_mesh(), jdist.batch_axes())
    jdist.set_mesh(None)
    yield
    jdist.set_mesh(*saved)


@pytest.fixture(scope="module")
def rigs():
    return {}


def _jit(fn, *args):
    """fn(*args) compiled by XLA at its lowest backend optimisation level:
    the same arithmetic, compiled in a fraction of the default's time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@functools.lru_cache(maxsize=None)
def _jinit(key, jcfg):
    """The reference's init_params, compiled (eager init dispatches op by op)."""
    return _jit(lambda k: jmodel.init_params(k, jcfg), jax.random.PRNGKey(key))


def _rig(rigs, arch):
    if arch not in rigs:
        jcfg, cfg = jreduced(arch), reduced(arch)
        jp = _jinit(0, jcfg)
        rigs[arch] = (jcfg, cfg, jp, from_jax_params(_np(jp), cfg, "cpu"))
    return rigs[arch]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(j, t, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _tree_close(jtree, ttree, **tol):
    jax.tree.map(lambda j, t: _close(j, t, **tol), jtree, ttree)


def _batches(cfg, jcfg, step=0):
    jb = jsynthetic_batch(jcfg, B, S, step=step)
    return jb, synthetic_batch(cfg, B, S, step=step, device="cpu")


def _clone(tree):
    return jax.tree.map(lambda t: t.clone(), tree)


def _state_close(jstate, state, **tol):
    """The reference's and the port's TrainState, leaf by leaf."""
    assert int(jstate.opt.step) == int(state.opt.step)
    for j, t in ((jstate.params, state.params), (jstate.opt.m, state.opt.m),
                 (jstate.opt.v, state.opt.v), (jstate.ef, state.ef)):
        assert (j is None) == (t is None)
        if j is not None:
            _tree_close(j, t, **tol)


def _opts():
    """One AdamW for both packages.  Adam's first update is g / (|g| + eps)
    (after clipping), so with the default eps (1e-8) it divides the f32
    noise of a small gradient element by that element's own size: the two
    packages' grads differ by ~1e-5 of the largest (the SSD gates are
    differences of long f32 cumsums), which moves such an element by up to
    lr.  eps 1e-3 on both sides keeps the update smooth in g, so one step
    holds to 1e-5 while the arithmetic compared is unchanged."""
    kw = dict(lr=1e-3, eps=1e-3, warmup=2, total_steps=10)
    return JAdamW(**kw), AdamW(**kw)


# ------------------------------------------------------------ model + loss
@pytest.fixture(scope="module")
def hybrid_ref(rigs):
    """The reference's logits, loss, metrics and full gradient tree on one
    reduced-zamba2 batch, from one compiled program."""
    jcfg, cfg, jp, _ = _rig(rigs, "zamba2_1p2b")
    jb, tb = _batches(cfg, jcfg, step=1)

    def ref(p):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: jmodel.loss_fn(q, jb, jcfg), has_aux=True)(p)
        return jmodel.forward(p, jb, jcfg)[0], loss, metrics, grads
    return tb, _jit(ref, jp)


def test_hybrid_forward_and_loss_match_jax(rigs, hybrid_ref):
    _, cfg, _, tp = _rig(rigs, "zamba2_1p2b")
    tb, (jl, jloss, jm, _) = hybrid_ref
    _close(jl, model.forward(tp, tb.tokens, cfg))
    loss, m = loss_fn(tp, tb, cfg)
    _close(jloss, loss)
    for k in ("nll", "zloss", "aux"):
        _close(jm[k], m[k])


def test_hybrid_grads_match_jax(rigs, hybrid_ref):
    _, cfg, _, tp = _rig(rigs, "zamba2_1p2b")
    tb, (_, jloss, _, jg) = hybrid_ref
    live = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss, _ = loss_fn(live, tb, cfg)
    loss.backward()
    _close(jloss, loss)
    _tree_close(jg, jax.tree.map(lambda t: t.grad, live))


def test_hybrid_remat_gives_the_same_grads(rigs):
    _, cfg, _, tp = _rig(rigs, "zamba2_1p2b")
    _, tb = _batches(cfg, jreduced("zamba2_1p2b"), step=2)
    grads = []
    for c in (cfg, cfg.with_(remat="full")):
        live = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
        loss_fn(live, tb, c)[0].backward()
        grads.append(jax.tree.map(lambda t: t.grad, live))
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-6), *grads)
    with pytest.raises(NotImplementedError, match="dots"):
        loss_fn(tp, tb, cfg.with_(remat="dots"))


def test_hybrid_split_and_join_round_trip(rigs):
    _, cfg, _, tp = _rig(rigs, "zamba2_1p2b")
    c = cfg.with_(n_layers=5)   # two groups of 2 and a tail of 1
    stacked = {k: torch.cat([v, v[:1]]) for k, v in tp["layers"].items()}
    body, tail = model._hybrid_split(c, stacked)
    assert body["w_x"].shape[:2] == (2, 2) and tail["w_x"].shape[0] == 1
    joined = model._hybrid_join(c, body, tail)
    assert all(torch.equal(joined[k], stacked[k]) for k in stacked)


def test_hybrid_serving_still_raises(rigs):
    """Hybrid models serve through prefill / decode_step; the engine refuses
    them with the reference's reason, as the reference's engine does."""
    from repro.serving import ServeEngine as JServeEngine
    from repro_torch.serving import ServeEngine
    jcfg, cfg, jp, tp = _rig(rigs, "zamba2_1p2b")
    msg = "ServeEngine drives attention-family LMs"
    with pytest.raises(NotImplementedError, match=msg):
        JServeEngine(jcfg, jp)
    with pytest.raises(NotImplementedError, match=msg):
        ServeEngine(cfg, tp, device="cpu")
    logits, cache = prefill(tp, torch.zeros(1, 8, dtype=torch.long), cfg)
    assert logits.shape == (1, cfg.vocab)
    assert [tuple(t.shape) for t in cache["mamba"]] == \
        [tuple(t.shape) for t in init_cache(cfg, 1, 8, "cpu")["mamba"]]


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("arch,microbatches", [("zamba2_1p2b", 1), ("zamba2_1p2b", 2),
                                                ("llama3_8b", 1)])
def test_train_step_matches_jax(rigs, arch, microbatches):
    """Microbatch accumulation is the same code for every family, so the
    dense model runs one microbatch only."""
    jcfg, cfg, jp, tp = _rig(rigs, arch)
    jopt, opt = _opts()
    jb, tb = _batches(cfg, jcfg, step=3)
    jstate, jm = _jit(jmake_step(jcfg, jopt, microbatches=microbatches),
                      jmake_state(jp, jopt), jb)
    state, m = make_train_step(cfg, opt, microbatches=microbatches)(
        make_train_state(_clone(tp), opt), tb)
    assert int(state.opt.step) == 1
    _state_close(jstate, state, **STEP_TOL)
    _close(jm["lr"], m["lr"], **STEP_TOL)
    # the grad norm and the loss sum over everything: in the hybrid model
    # each SSD gate exp(cs_t - cs_u) is a difference of within-chunk cumsums
    # that reach ~-350, so f32 rounds it at ~3e-5 relative, in another order
    # in each package; those sums are held at the 1e-4 of the gradients
    for k in ("grad_norm", "loss", "nll"):
        _close(jm[k], m[k])


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "llama3_8b"])
def test_compressed_train_step_matches_jax(rigs, arch):
    """int8 rounding is discontinuous: an element at a rounding boundary
    flips under any f32 noise in its gradient.  So the reference's
    compression (`_quantize_int8`, `_dequantize_int8` and the error
    feedback of its train step) and its AdamW run on the port's own grads,
    and the port's compressed step must agree with them."""
    jcfg, cfg, jp, tp = _rig(rigs, arch)
    jopt, opt = _opts()
    _, tb = _batches(cfg, jcfg, step=4)
    live = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss_fn(live, tb, cfg)[0].backward()
    grads = jax.tree.map(lambda t: jnp.asarray(t.grad.numpy()), live)
    state, m = make_train_step(cfg, opt, compress_grads=True)(
        make_train_state(_clone(tp), opt, compress=True), tb)

    def jstep(grads, jstate):
        def comp(g, e):  # the reference's train_step.py, compress_grads branch
            g = g.astype(jnp.float32) + e
            gq = jtrain_step._dequantize_int8(*jtrain_step._quantize_int8(g))
            return gq, g - gq
        out = jax.tree.map(comp, grads, jstate.ef)
        two = lambda t: isinstance(t, tuple) and len(t) == 2  # noqa: E731
        gq = jax.tree.map(lambda t: t[0], out, is_leaf=two)
        ef = jax.tree.map(lambda t: t[1], out, is_leaf=two)
        params, opt_state, gnorm = jopt.update(gq, jstate.opt, jstate.params)
        return jtrain_step.TrainState(params, opt_state, ef), gnorm

    jstate, jgnorm = _jit(jstep, grads, jmake_state(jp, jopt, compress=True))
    _state_close(jstate, state, **STEP_TOL)
    _close(jgnorm, m["grad_norm"], **STEP_TOL)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("arch,step", [("zamba2_1p2b", 0), ("llama3_8b", 7)])
def test_synthetic_batch_matches_jax(arch, step):
    jb = jsynthetic_batch(jreduced(arch), 3, 40, seed=5, step=step)
    tb = synthetic_batch(reduced(arch), 3, 40, seed=5, step=step, device="cpu")
    assert np.array_equal(np.asarray(jb.tokens), tb.tokens.numpy())
    assert np.array_equal(np.asarray(jb.labels), tb.labels.numpy())
    assert tb._fields == ("tokens", "labels", "extra") and tb.tokens.dtype == torch.int64
    assert tb.extra is None and jb.extra is None
    nxt = next(stream(reduced(arch), 3, 40, seed=5, start_step=step + 1, device="cpu"))
    jnxt = jsynthetic_batch(jreduced(arch), 3, 40, seed=5, step=step + 1)
    assert np.array_equal(np.asarray(jnxt.tokens), nxt.tokens.numpy())


# ------------------------------------------------------------ checkpoints
def _bf16_llama():
    return (jreduced("llama3_8b").with_(param_dtype="bfloat16"),
            reduced("llama3_8b").with_(param_dtype="bfloat16"))


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jcfg, cfg = _bf16_llama()
    jstate = jmake_state(_jinit(2, jcfg), JAdamW(),
                         compress=True)
    jckpt.save(str(tmp_path), 7, jstate)
    template = make_train_state(init_params(cfg, seed=1, device="cpu"), AdamW(),
                                compress=True)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    state = checkpoint.restore(str(tmp_path), template)
    assert state.params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert state.opt.step.dtype == torch.int32
    _state_close(jstate, state, atol=0, rtol=0)


def test_port_checkpoint_restores_into_jax(tmp_path):
    jcfg, cfg = _bf16_llama()
    opt = AdamW(lr=1e-3, warmup=1, total_steps=4)
    state = make_train_state(init_params(cfg, seed=3, device="cpu"), opt, compress=True)
    state, _ = make_train_step(cfg, opt, compress_grads=True)(
        state, synthetic_batch(cfg, 2, 16, device="cpu"))
    checkpoint.save(str(tmp_path), 1, state)
    template = jmake_state(_jinit(2, jcfg), JAdamW(),
                           compress=True)
    jstate = jckpt.restore(str(tmp_path), template)
    assert jstate.params["layers"]["attn"]["wq"].dtype == jnp.bfloat16
    assert int(jstate.opt.step) == 1
    _state_close(jstate, state, atol=0, rtol=0)


def test_restart_equals_an_uninterrupted_run(rigs, tmp_path):
    _, cfg, _, tp = _rig(rigs, "zamba2_1p2b")
    opt = AdamW(lr=1e-3, warmup=1, total_steps=4)
    step = make_train_step(cfg, opt)

    def run(state, steps):
        for i in steps:
            state, _ = step(state, synthetic_batch(cfg, 2, S, step=i, device="cpu"))
        return state

    straight = run(make_train_state(_clone(tp), opt), range(4))
    half = run(make_train_state(_clone(tp), opt), range(2))
    checkpoint.save(str(tmp_path), 2, half)
    resumed = checkpoint.restore(str(tmp_path), make_train_state(
        init_params(cfg, seed=9, device="cpu"), opt))
    resumed = run(resumed, range(2, 4))
    assert int(straight.opt.step) == int(resumed.opt.step) == 4
    for a, b in ((straight.params, resumed.params), (straight.opt.m, resumed.opt.m),
                 (straight.opt.v, resumed.opt.v)):
        jax.tree.map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=1e-6), a, b)


# --------------------------------------------------------------- launcher
def test_train_cli_runs_and_resumes_on_cpu(tmp_path):
    argv = ["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "64", "--microbatches", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1"]
    first = train.main(argv + ["--steps", "2"])
    assert first["steps"] == 2 and first["device"] == "cpu"
    assert len(first["losses"]) == 2 and all(math.isfinite(x) for x in first["losses"])
    assert abs(first["losses"][0] - math.log(512)) < 1.0   # ~uniform over the vocab
    again = train.main(argv + ["--steps", "3"])
    assert again["steps"] == 1 and checkpoint.latest_step(str(tmp_path)) == 3


def test_train_cli_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "zamba2-1.2b", "--reduced", "--steps", "1"])


# ----------------------------------------------- launches on the train path
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_kernel_calls_match_chip_smokes_count(rigs, monkeypatch, remat):
    """chip_smoke asserts each kernel's launches per full-width train step
    from the layer structure and the remat nesting.  On the CPU the same
    path calls the kernels' plain forwards where the card launches them;
    count those calls and hold the formula to them."""
    _, cfg, _, tp = _rig(rigs, "zamba2_1p2b")
    cfg = cfg.with_(n_layers=5, remat=remat)    # two groups and a tail layer
    params = init_params(cfg, seed=0, device="cpu")
    calls = {"ssd_scan": 0, "flash_attention": 0}
    for mod, name in ((ssd, "ssd_scan_plain"), (fa, "flash_attention_plain")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=name[:-len("_plain")], **k):
            calls[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    opt = AdamW()
    step = make_train_step(cfg, opt, microbatches=2)
    step(make_train_state(params, opt), synthetic_batch(cfg, 2, S, device="cpu"))
    want = _chip_smoke().train_launches(cfg, microbatches=2)
    assert calls == {k: want[k] for k in calls}
    assert want["ssd_scan_bwd"] == 2 * 5 and want["flash_attention_bwd"] == 2 * 2


@pytest.mark.parametrize("shape,blocks", [((7, 6), 3), ((2, 30), 2), ((40, 1), 2)])
def test_adamw_updates_a_long_leaf_a_block_of_rows_at_a_time(monkeypatch, shape, blocks):
    """Above UPDATE_SLICE_ELEMS (lowered here to 20) a leaf is updated a
    block of leading-axis slices of at most 20 elements at a time (a row
    over 20 alone, then its own slices), not one row at a time: a 151,680-
    or 256,256-row embedding in two blocks, not in one update a row.  Bit
    for bit the whole-leaf update."""
    from repro_torch.training import optimizer
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(shape, generator=g)}
    grads = {"w": torch.randn(shape, generator=g)}
    opt = AdamW(lr=1e-3, warmup=1, total_steps=4)
    out, calls = [], []
    sqrt = torch.sqrt

    def counted(x):
        calls[-1] += 1
        return sqrt(x)
    monkeypatch.setattr(torch, "sqrt", counted)
    for limit in (1 << 30, 20):
        monkeypatch.setattr(optimizer, "UPDATE_SLICE_ELEMS", limit)
        p = {k: v.clone() for k, v in params.items()}
        state = opt.init(p)
        calls.append(0)
        p, state, gnorm = opt.update(grads, state, p)
        out.append((p["w"], state.m["w"], state.v["w"]))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert calls == [1 + 1, 1 + blocks]     # the global norm, then each update


def test_adamw_updates_a_large_leaf_slice_by_slice_bit_for_bit(monkeypatch):
    """A leaf above UPDATE_SLICE_ELEMS is updated one axis-0 slice at a time
    (the f32 temporaries stay one layer's size); the params and moments are
    bit for bit those of the whole-leaf update."""
    from repro_torch.training import optimizer
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 30, 20, generator=g).bfloat16(),
              "b": torch.randn(50, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    opt = AdamW(lr=1e-3, warmup=1, total_steps=4)
    out = []
    for limit in (1 << 30, 1000):
        monkeypatch.setattr(optimizer, "UPDATE_SLICE_ELEMS", limit)
        p = {k: v.clone() for k, v in params.items()}
        state = opt.init(p)
        for _ in range(2):
            p, state, gnorm = opt.update(grads, state, p)
        out.append((p, state, gnorm))
    (p1, s1, n1), (p2, s2, n2) = out
    assert torch.equal(n1, n2)
    for a, b in ((p1, p2), (s1.m, s2.m), (s1.v, s2.v)):
        assert all(torch.equal(a[k], b[k]) for k in a)
