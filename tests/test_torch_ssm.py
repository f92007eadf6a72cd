"""The port's SSD scan, flash-attention backward and Mamba-2 block against
the JAX reference, on the CPU (the kernels' plain versions).

Inputs are made with numpy from a seed and handed to both packages; bf16
inputs are rounded from the same f32 numbers on both sides.  Tolerances:

  * the SSD forward is held scale-relative (error over the reference's
    largest magnitude), at the reference's own `tests/test_kernels.py`
    tolerances: 2e-5 in f32 (both sides are f32 chunked sums in another
    order) and 2e-2 in bf16 (one bf16 rounding of the output);
  * gradients and the Mamba-2 block at 1e-4 (atol and rtol) in f32: longer
    chains of f32 sums in another order.

The reference runs compiled (`_jit`): op-by-op eager dispatch would spend
seconds compiling each op for each shape.  Both sides run their
contractions single-threaded (`_jit`, `pinned_threads`), so a comparison
does not depend on the thread pools that earlier test files in the same
worker left behind.  The Pallas kernel runs in interpret mode, as the
reference's own tests run it.

`_ssd_split` is the bf16 kernel's chunk-parallel decomposition in plain
torch (a test oracle): held against the reference at 2e-5 in f32, and with
the kernel's bf16 rounding points emulated, against the plain version at
1e-2, half of the card tests' 2e-2 gate.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import from_jax_params, init_params  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SWEEP = [(128, 32), (256, 64), (512, 128)]   # test_ssd_kernel_sweep's (s, chunk)
TOL = dict(atol=1e-4, rtol=1e-4)


def _ssd_np(seed, b=2, s=128, h=2, p=16, n=8):
    """x, dt, A, B, C, D as float32 numpy, shaped as test_ssd_kernel_sweep."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return (f(b, s, h, p), np.abs(f(b, s, h) * 0.1), -np.abs(f(h)), f(b, s, n),
            f(b, s, n), f(h))


def _both(arrs, dtype):
    """(jax arrays, torch tensors); x, B and C (0, 3, 4) in `dtype`."""
    jdt, tdt, _ = DTYPES[dtype]
    low = (0, 3, 4)
    return ([jnp.asarray(a, jdt if i in low else jnp.float32) for i, a in enumerate(arrs)],
            [torch.from_numpy(a).to(tdt if i in low else torch.float32)
             for i, a in enumerate(arrs)])


def _rel(j, t):
    j = np.asarray(j, np.float32)
    return float(np.abs(j - t.detach().float().numpy()).max()) / (float(np.abs(j).max()) + 1e-6)


def _jit(fn, *args):
    """fn(*args) compiled by XLA at its lowest backend optimisation level
    (the same arithmetic, compiled in a fraction of the default's time) and
    with its contractions single-threaded: on the shared Eigen pool their
    rounding depends on how the work is split among threads."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_cpu_multi_thread_eigen": False})(*args)


def _close(j, t, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


# ------------------------------------------------------------ SSD forward
@pytest.fixture(autouse=True)
def pinned_threads():
    """Pin the thread pools that the f32 parity depends on, whatever the
    worker ran before: torch's intra-op threads (1) for the port's plain
    version; the reference's side is compiled single-threaded by `_jit`."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("s,chunk", SWEEP)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("against", ["jnp", "pallas_interpret", "naive"])
def test_ssd_scan_plain_matches_jax(s, chunk, dtype, against):
    (jx, jdt, jA, jB, jC, jD), ins = _both(_ssd_np(s + chunk, s=s), dtype)
    if against == "jnp":
        jy = _jit(lambda *a: jops.ssd_scan(*a, chunk=chunk), jx, jdt, jA, jB, jC, jD)
    elif against == "pallas_interpret":
        jy = pallas_ssd(jx, jdt, jA, jB, jC, jD, chunk=chunk, interpret=True)
    else:
        jy = _jit(jref.naive_ssd, jx, jdt, jA, jB, jC, jD)
    y = ssd.ssd_scan(*ins, chunk=chunk)       # a CPU tensor: the plain version
    assert y.dtype == ins[0].dtype and y.shape == ins[0].shape
    assert _rel(jy, y) < DTYPES[dtype][2]


def test_ssd_scan_plain_computes_f64_inputs_in_f64():
    """f64 inputs stay f64 through the plain version and its backward (the
    card tests' exact reference for the f32 kernels); the result is the
    reference's naive SSD, and the f32 plain version's within its rounding."""
    arrs = _ssd_np(7)
    ins = [torch.from_numpy(a).double() for a in arrs]
    y = ssd.ssd_scan_plain(*ins, chunk=32)
    assert y.dtype == torch.float64
    jy = _jit(jref.naive_ssd, *(jnp.asarray(a) for a in arrs))
    assert _rel(jy, y) < DTYPES["float32"][2]
    assert float((ssd.ssd_scan_plain(*(t.float() for t in ins), chunk=32) - y).abs().max()) \
        < 1e-5 * float(y.abs().max())
    grads = ssd.ssd_scan_bwd_plain(*ins, torch.ones_like(y), chunk=32)
    assert all(g.dtype == torch.float64 for g in grads)


# --- the bf16 kernel's chunk-parallel split, in plain torch -----------------
def _ssd_split(x, dt, A, B, C, D, chunk, bf16_points=False):
    """The SSD forward decomposed as csrc/ssd_scan_fwd.cu computes it (Dao &
    Gu 2024, section 6): chunk states s_k = (B o g)^T x with g_u =
    exp(cs_last - cs_u) dt_u; state passing S_k = exp(cs_last) S_{k-1} + s_k;
    chunk scan y = (C B^T o gate, causal) (dt o x) + exp(cs_t) C S_{k-1} +
    D x.  With bf16_points, the kernel's roundings to bf16 before its
    tensor-core products: B o g, S_{k-1} and the gated W.  A test oracle;
    nothing on the CUDA path calls it."""
    rb = (lambda t: t.to(torch.bfloat16).float()) if bf16_points else (lambda t: t)
    b, s, h, p = x.shape
    n, nc = B.shape[-1], s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf, Cf = (t.float().reshape(b, nc, chunk, n) for t in (B, C))
    cs = torch.cumsum(dtf * A.float(), dim=2)                    # (b,nc,c,h)
    total = cs[:, :, -1]                                         # (b,nc,h)
    g = torch.exp(total[:, :, None] - cs) * dtf
    sk = torch.einsum("bkuhn,bkuhp->bkhnp", rb(Bf[:, :, :, None] * g[..., None]), xf)
    run, prev = torch.zeros_like(sk[:, 0]), []
    for k in range(nc):
        prev.append(run)
        run = run * torch.exp(total[:, k])[..., None, None] + sk[:, k]
    S = rb(torch.stack(prev, 1))                                 # entering states
    t = torch.arange(chunk)
    causal = (t[None, :] <= t[:, None])[None, None, :, :, None]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]            # (b,nc,t,u,h)
    gate = torch.exp(torch.where(causal, seg, torch.full_like(seg, -float("inf"))))
    W = rb(torch.einsum("bktn,bkun->bktu", Cf, Bf)[..., None] * gate * dtf[:, :, None])
    y = torch.einsum("bktuh,bkuhp->bkthp", W, xf)
    y = y + torch.exp(cs)[..., None] * torch.einsum("bktn,bkhnp->bkthp", Cf, S)
    return (y.reshape(b, s, h, p) + x.float() * D.float()[:, None]).to(x.dtype)


@pytest.mark.parametrize("s,chunk", SWEEP)
@pytest.mark.parametrize("against", ["jnp", "pallas_interpret", "plain"])
def test_ssd_chunk_split_matches_jax(s, chunk, against):
    arrs = _ssd_np(20 + s, s=s)
    (jx, jdt, jA, jB, jC, jD), ins = _both(arrs, "float32")
    y = _ssd_split(*ins, chunk)
    if against == "jnp":
        ref_y = _jit(lambda *a: jops._ssd_jnp(*a, chunk), jx, jdt, jA, jB, jC, jD)
    elif against == "pallas_interpret":
        ref_y = pallas_ssd(jx, jdt, jA, jB, jC, jD, chunk=chunk, interpret=True)
    else:
        ref_y = ssd.ssd_scan_plain(*ins, chunk=chunk).numpy()
    assert _rel(ref_y, y) < 2e-5


# the card tests' SSD shapes (tests/test_torch_gpu.py), and zamba2's decay
# range (A in [-16, -1], as chip_smoke draws it)
KERNEL_SSD_SHAPES = [(2, 128, 2, 16, 8, 32), (2, 256, 2, 16, 8, 64), (2, 512, 2, 16, 8, 128),
                     (2, 128, 8, 32, 16, 32), (1, 512, 4, 64, 64, 256),
                     (1, 300, 3, 24, 12, 100), (1, 256, 3, 16, 32, 64),
                     (1, 512, 2, 32, 16, 128), (2, 128, 4, 64, 16, 32),
                     (1, 1024, 2, 64, 64, 512), (1, 1024, 2, 32, 16, 1024)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", KERNEL_SSD_SHAPES)
@pytest.mark.parametrize("decay", ["test", "zamba2"])
def test_ssd_bf16_rounding_fits_the_gate(b, s, h, p, n, chunk, decay):
    """The bf16 kernel rounds B o g, S_{k-1} and W to bf16 for its tensor-core
    products, where the plain version keeps f32: emulated exactly that on
    the CPU, from bf16 inputs, it stays within half of the 2e-2 gate that
    tests/test_torch_gpu.py and chip_smoke hold the kernel to."""
    rng = np.random.default_rng(b * s + h * p + n)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    x, B, C = (t.to(torch.bfloat16) for t in (f(b, s, h, p), f(b, s, n), f(b, s, n)))
    dt = (f(b, s, h) * 0.1).abs()
    A = -torch.linspace(1.0, 16.0, h) if decay == "zamba2" else -f(h).abs()
    D = f(h)
    got = _ssd_split(x, dt, A, B, C, D, chunk, bf16_points=True)
    ref_y = ssd.ssd_scan_plain(x.float(), dt, A, B.float(), C.float(), D, chunk=chunk)
    assert got.dtype == torch.bfloat16
    assert _rel(ref_y.numpy(), got) < 1e-2


def _ssd_bwd_split(x, dt, A, B, C, D, dy, chunk, bf16_points=False):
    """The SSD backward decomposed as csrc/ssd_scan_bwd.cu computes it (Dao
    & Gu 2024, section 6): chunk states s_k = (B o g)^T x and their
    gradients' ds_k = (C o exp(cs))^T dy; the entering states S_{k-1}
    forward and dS_{k-1} = exp(total_k) dS_k + ds_k in reverse, with dtot_k
    = exp(total_k) <S_{k-1}, dS_k>; the products over the causal (t, u)
    pairs with K = C B^T o G and E = G o dt_u o (dy x^T); the dcs terms,
    their reverse cumsum, ddt = direct + A acc.  With bf16_points, the
    kernels' roundings before their tensor-core products: K and E to bf16;
    B o g, C o exp(cs), S_{k-1} and dS to pairs of bf16 (high and low
    half), which keep about 16 bits.  A test oracle; nothing on the CUDA
    path calls it.  Returns (dx, ddt, dA, dB, dC, dD) in f32."""
    rb = (lambda t: t.to(torch.bfloat16).float()) if bf16_points else (lambda t: t)
    hilo = lambda t: rb(t) + rb(t - rb(t))  # noqa: E731  (a bf16 pair: high and low half)
    b, s, h, p = x.shape
    n, nc = B.shape[-1], s // chunk
    xf, dyf = (t.float().reshape(b, nc, chunk, h, p) for t in (x, dy))
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf, Cf = (t.float().reshape(b, nc, chunk, n) for t in (B, C))
    cs = torch.cumsum(dtf * A.float(), dim=2)                    # (b,nc,c,h)
    total = cs[:, :, -1]                                         # (b,nc,h)
    edec = torch.exp(total[:, :, None] - cs)                     # exp(total - cs_u)
    # 1. chunk states and their gradients; 2. the state passes, in f32
    sk = torch.einsum("bkuhn,bkuhp->bkhnp", hilo(Bf[:, :, :, None] * (edec * dtf)[..., None]),
                      xf)
    run, prev = torch.zeros_like(sk[:, 0]), []
    for k in range(nc):
        prev.append(run)
        run = run * torch.exp(total[:, k])[..., None, None] + sk[:, k]
    S = hilo(torch.stack(prev, 1))                               # (b,nc,h,n,p)
    ds = torch.einsum("bkthn,bkthp->bkhnp",
                      hilo(Cf[:, :, :, None] * torch.exp(cs)[..., None]), dyf)
    run, dS, dtot = torch.zeros_like(ds[:, 0]), [None] * nc, [None] * nc
    for k in reversed(range(nc)):
        dS[k] = run
        dtot[k] = torch.exp(total[:, k]) * (S[:, k] * run).sum((-2, -1))
        run = run * torch.exp(total[:, k])[..., None, None] + ds[:, k]
    dS, dtot = hilo(torch.stack(dS, 1)), torch.stack(dtot, 1)      # (b,nc,h,n,p), (b,nc,h)
    # 3. the products over the causal pairs
    t = torch.arange(chunk)
    causal = (t[None, :] <= t[:, None])[None, None, :, :, None]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]            # (b,nc,t,u,h)
    G = torch.exp(torch.where(causal, seg, torch.full_like(seg, -float("inf"))))
    CB = torch.einsum("bktn,bkun->bktu", Cf, Bf)[..., None]
    xdy = torch.einsum("bkthp,bkuhp->bktuh", dyf, xf)
    K = rb(CB * G)
    E = rb(G * dtf[:, :, None] * xdy)
    Z = CB * G * xdy
    bds = torch.einsum("bkun,bkhnp->bkuhp", Bf, dS)              # B_u dS
    dx = dtf[..., None] * (torch.einsum("bktuh,bkthp->bkuhp", K, dyf) + edec[..., None] * bds)
    dx = dx + D.float()[:, None] * dyf
    dB = torch.einsum("bktuh,bktn->bkun", E, Cf) + torch.einsum(
        "bkuh,bkuhp,bkhnp->bkun", edec * dtf, xf, dS)
    dC = torch.einsum("bktuh,bkun->bktn", E, Bf) + torch.einsum(
        "bkth,bkthp,bkhnp->bktn", torch.exp(cs), dyf, S)
    # 4. the cumsum's gradient: direct terms (u side), row terms (t side)
    pn = edec * (bds * xf).sum(-1)                               # (b,nc,u,h)
    ddd = Z.sum(2) + pn
    dcs = (Z * dtf[:, :, None]).sum(3) - dtf * ddd + torch.exp(cs) * torch.einsum(
        "bktn,bkhnp,bkthp->bkth", Cf, S, dyf)
    dcs[:, :, -1] += dtot + (dtf * pn).sum(2)
    acc = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2])  # sum over rows >= i
    ddt = ddd + A.float() * acc
    return (dx.reshape(b, s, h, p), ddt.reshape(b, s, h), (dtf * acc).sum((0, 1, 2)),
            dB.reshape(b, s, n), dC.reshape(b, s, n), (xf * dyf).sum((0, 1, 2, 4)))


@pytest.mark.parametrize("s,chunk", SWEEP[:2])
def test_ssd_bwd_split_matches_jax(s, chunk):
    """The backward's chunk-parallel split, in f32, against jax.vjp of the
    reference's _ssd_jnp: all six gradients at 1e-4."""
    arrs = _ssd_np(40 + s, s=s)
    dy = np.random.default_rng(41).standard_normal(arrs[0].shape).astype(np.float32)
    jins, ins = _both(arrs, "float32")
    jgrads = _jit(lambda g, *a: jax.vjp(lambda *b: jops._ssd_jnp(*b, chunk), *a)[1](g),
                  jnp.asarray(dy), *jins)
    grads = _ssd_bwd_split(*ins, torch.from_numpy(dy), chunk)
    for name, jg, g, t in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), jgrads, grads, ins):
        assert g.shape == t.shape, name
        _close(jg, g)


@pytest.mark.parametrize("b,s,h,p,n,chunk", KERNEL_SSD_SHAPES)
@pytest.mark.parametrize("decay", ["test", "zamba2", "model"])
def test_ssd_bwd_bf16_rounding_fits_the_gate(b, s, h, p, n, chunk, decay):
    """The bf16 backward rounds K and E to bf16 for its tensor-core products
    and splits B o g, C o exp(cs), S_{k-1} and dS into bf16 pairs: emulated
    exactly that on the CPU, each gradient stays within half of the 2e-2
    gate that tests/test_torch_gpu.py and chip_smoke hold the kernels to,
    ddt and dA (direct + A acc, which cancels at A = -16) included.
    "model" draws dt = softplus(N(0, 1)), as the model's init gives it:
    decays of hundreds of e-folds inside a chunk."""
    rng = np.random.default_rng(7 * b * s + h * p + n)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    x, B, C, dy = (t.to(torch.bfloat16) for t in (f(b, s, h, p), f(b, s, n), f(b, s, n),
                                                  f(b, s, h, p)))
    dt = torch.nn.functional.softplus(f(b, s, h)) if decay == "model" else (f(b, s, h) * 0.1).abs()
    A = -f(h).abs() if decay == "test" else -torch.linspace(1.0, 16.0, h)
    D = f(h)
    got = _ssd_bwd_split(x, dt, A, B, C, D, dy, chunk, bf16_points=True)
    refs = ssd.ssd_scan_bwd_plain(x.float(), dt, A, B.float(), C.float(), D, dy.float(),
                                  chunk=chunk)
    for name, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, refs):
        assert _rel(r.numpy(), g) < 1e-2, name


@pytest.mark.parametrize("dtype", DTYPES)
def test_naive_ssd_matches_jax(dtype):
    (jx, jdt, jA, jB, jC, jD), ins = _both(_ssd_np(1, s=48), dtype)
    assert _rel(_jit(jref.naive_ssd, jx, jdt, jA, jB, jC, jD), ref.naive_ssd(*ins)) < \
        DTYPES[dtype][2]


def test_ssd_final_state_matches_jax():
    jins, ins = _both(_ssd_np(2, s=256), "float32")
    jy, jst = _jit(lambda *a: jops._ssd_jnp(*a, 64, return_final_state=True), *jins)
    y, st = ops.ssd_scan(*ins, chunk=64, return_final_state=True)
    assert st.shape == (2, 2, 16, 8) and st.dtype == torch.float32
    assert _rel(jy, y) < 2e-5 and _rel(jst, st) < 2e-5


def test_ssd_scan_asserts_divisible_chunks():
    _, ins = _both(_ssd_np(3, s=96), "float32")
    with pytest.raises(AssertionError, match="not divisible"):
        ssd.ssd_scan(*ins, chunk=64)


@pytest.mark.parametrize("s,chunk", SWEEP[:2])
def test_ssd_scan_grads_match_jax(s, chunk):
    arrs = _ssd_np(4 + s, s=s)
    dy = np.random.default_rng(5).standard_normal(arrs[0].shape).astype(np.float32)
    jins, ins = _both(arrs, "float32")
    jgrads = _jit(lambda g, *a: jax.vjp(lambda *b: jops._ssd_jnp(*b, chunk), *a)[1](g),
                  jnp.asarray(dy), *jins)
    grads = ssd.ssd_scan_bwd_plain(*ins, torch.from_numpy(dy), chunk=chunk)
    for name, jg, g, t in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), jgrads, grads, ins):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _close(jg, g)


def test_ssd_scan_keeps_the_log_space_mask():
    """A decay strong enough that exp(+segment sum) overflows: the masked
    gates stay finite, and so do the gradients."""
    arrs = list(_ssd_np(6, s=64))
    arrs[1] = np.full_like(arrs[1], 4.0)               # dt
    arrs[2] = np.full_like(arrs[2], -16.0)             # A
    _, ins = _both(arrs, "float32")
    ins = [t.requires_grad_(True) for t in ins]
    ssd.ssd_scan(*ins, chunk=64).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in ins)


# --------------------------------------------------- flash attention backward
@pytest.mark.parametrize("B,S,H,K,D", [(1, 64, 4, 4, 32), (2, 96, 8, 2, 64),
                                       (1, 80, 4, 1, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_plain_matches_jax_grad(B, S, H, K, D, causal):
    rng = np.random.default_rng(B * S + H)
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32)
                   for sh in ((B, S, H, D), (B, S, K, D), (B, S, K, D), (B, S, H, D)))
    jgrads = _jit(lambda g, *a: jax.vjp(
        lambda *b: jref.naive_attention(*b, causal=causal), *a)[1](g),
        *(jnp.asarray(a) for a in (do, q, k, v)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    grads = fa.flash_attention_bwd_plain(*t, torch.from_numpy(do), causal=causal)
    for jg, g in zip(jgrads, grads):
        _close(jg, g)
    # and autograd through the wrapper's CPU path gives the same
    ts = [a.clone().requires_grad_(True) for a in t]
    ops.attention(*ts, causal=causal).backward(torch.from_numpy(do))
    for jg, a in zip(jgrads, ts):
        _close(jg, a.grad)


# ------------------------------------------------------------------ Mamba-2
@pytest.fixture(scope="module")
def zamba():
    """Reduced zamba2 and one Mamba-2 layer's params, JAX-initialised."""
    jcfg, cfg = jreduced("zamba2_1p2b"), reduced("zamba2_1p2b")
    jlp = _jit(lambda key: jssm.init_mamba2(key, jcfg), jax.random.PRNGKey(0))
    return jcfg, cfg, jlp, {k: torch.from_numpy(np.array(v)) for k, v in jlp.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(7)
    x, w, b = (rng.standard_normal(sh).astype(np.float32) for sh in ((2, 9, 6), (4, 6), (6,)))
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state else None
    jy, jst = _jit(lambda *a: jssm._causal_conv(*a, None if st is None else jnp.asarray(st)),
                   jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    y, tst = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                              None if st is None else torch.from_numpy(st))
    _close(jy, y)
    _close(jst, tst)


def test_mamba2_fwd_matches_jax(zamba):
    jcfg, cfg, jlp, tlp = zamba
    x = np.random.default_rng(8).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    jy, _ = _jit(lambda p, a: jssm.mamba2_fwd(p, a, jcfg), jlp, jnp.asarray(x))
    y, st = ssm.mamba2_fwd(tlp, torch.from_numpy(x), cfg)
    assert st is None
    _close(jy, y)


def test_mamba2_recurrent_branches_raise(zamba):
    _, cfg, _, tlp = zamba
    x = torch.zeros(1, 1, cfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        ssm.mamba2_fwd(tlp, x, cfg, return_state=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        ssm.mamba2_fwd(tlp, x, cfg, state=object())


# ------------------------------------------------------------- the two repairs
def test_check_inputs_takes_a_dtype_per_argument():
    x = torch.zeros(2, 8, dtype=torch.bfloat16)
    dt = torch.zeros(2, 8)
    assert _build.check_inputs("k", x, (dt, torch.float32), x) == 1
    assert _build.check_inputs("k", dt, dt) == 0
    with pytest.raises(ValueError, match="expected"):
        _build.check_inputs("k", x, dt)                      # a bare f32 beside bf16
    with pytest.raises(ValueError, match="expected"):
        _build.check_inputs("k", x, (x, torch.float32))      # a declared dtype not met
    with pytest.raises(TypeError, match="not supported"):
        _build.check_inputs("k", torch.zeros(2, dtype=torch.float16))


def test_from_jax_params_keeps_each_leafs_dtype():
    """Under bf16 params the Mamba-2 a_log, d_skip and dt_bias stay f32, as
    `init_params` and the reference keep them."""
    jcfg = jreduced("zamba2_1p2b").with_(param_dtype="bfloat16")
    cfg = reduced("zamba2_1p2b").with_(param_dtype="bfloat16")
    jp = _jit(lambda key: jmodel.init_params(key, jcfg), jax.random.PRNGKey(1))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    meta = init_params(cfg, device="meta")
    got = jax.tree.map(lambda t: t.dtype, tp)
    assert got == jax.tree.map(lambda t: t.dtype, meta)
    for key in ("a_log", "d_skip", "dt_bias"):
        assert got["layers"][key] == torch.float32
        assert jp["layers"][key].dtype == jnp.float32
        assert np.array_equal(tp["layers"][key].numpy(), np.asarray(jp["layers"][key]))
    assert got["layers"]["w_x"] == torch.bfloat16
    assert got["shared_attn"]["attn"]["wq"] == torch.bfloat16
