"""Card-only tests of the port's hand-written CUDA kernels.

Each kernel is held against its plain torch version on the same inputs, on
the GPU.  Every test takes the `cuda` fixture, which skips when no CUDA card
is present, so each worker collects the same tests.  Run them on a machine
with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: 1e-4 in float32 (same f32 math, another summation order), 2e-2
in bfloat16 against the plain version computed in f32 from the same inputs
(the output's rounding to bf16; for decode, the scale applied in f32; for
the attention kernels, P and dS rounded to bf16 for their tensor-core
products, which `tests/test_torch_kernels.py` shows stays under 1e-2 on
these shapes).  The SSD scan and the backward kernels are held
scale-relative (error over the largest magnitude of the reference), as
`tests/test_kernels.py` holds the SSD kernel: their outputs span orders of
magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rnd(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=device, dtype=dtype)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("B,Sq,Skv,H,K,D", [
    (1, 128, 128, 4, 4, 32),    # MHA
    (2, 256, 256, 8, 2, 64),    # GQA 4:1
    (1, 256, 256, 4, 1, 64),    # MQA
    (1, 512, 512, 2, 2, 128),
    (1, 192, 192, 2, 1, 32),    # ragged: not a multiple of 128
    (2, 100, 100, 4, 2, 128),   # ragged tail tile
    (1, 64, 200, 4, 2, 64),     # Sq < Skv, end-aligned
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_vs_plain(cuda, B, Sq, Skv, H, K, D, dtype, causal):
    rng = np.random.default_rng(0)
    q = _rnd(rng, (B, Sq, H, D), dtype, cuda)
    k, v = _rnd(rng, (B, Skv, K, D), dtype, cuda), _rnd(rng, (B, Skv, K, D), dtype, cuda)
    n0 = fa.flash_attention.launches
    o = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
    assert o.dtype == dtype and o.shape == q.shape
    assert _err(o, ref) < TOL[dtype]


@pytest.mark.parametrize("B,S,H,K,D,Dv,vl", [
    (2, 256, 8, 2, 64, 64, 100),     # GQA, partial cache
    (1, 512, 4, 4, 32, 32, 512),     # MHA, full cache
    (2, 128, 4, 1, 32, 32, 1),       # MQA, single valid token
    (1, 256, 8, 8, 128, 128, 37),
    (2, 1024, 32, 8, 128, 128, 513),  # llama3-8b widths
    (1, 192, 32, 1, 128, 128, 192),  # MQA, 32 heads: several CTAs per kv head
    (2, 300, 4, 2, 128, 64, 299),    # Dv != D, ragged
    # split-KV: one run at vlen 1, runs not a multiple of the vlen, vlen = S,
    # a long cache at batch 1, MQA split over many runs
    (8, 1024, 32, 8, 128, 128, 1),
    (8, 1024, 32, 8, 128, 128, 1024),
    (1, 4096, 32, 8, 128, 128, 3001),
    (2, 1024, 32, 1, 128, 128, 777),
    (3, 512, 8, 2, 64, 32, 33),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_vs_plain(cuda, B, S, H, K, D, Dv, vl, dtype):
    rng = np.random.default_rng(1)
    q = _rnd(rng, (B, 1, H, D), dtype, cuda)
    k, v = _rnd(rng, (B, S, K, D), dtype, cuda), _rnd(rng, (B, S, K, Dv), dtype, cuda)
    n0 = fd.flash_decode.launches
    o = fd.flash_decode(q, k, v, vl)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == n0 + 1
    ref = fd.flash_decode_plain(q.float(), k.float(), v.float(), vl)
    assert o.dtype == dtype and o.shape == (B, 1, H, Dv)
    assert _err(o, ref) < TOL[dtype]


def test_ops_dispatches_to_kernels(cuda):
    rng = np.random.default_rng(2)
    q = _rnd(rng, (2, 96, 8, 64), torch.float32, cuda)
    k, v = _rnd(rng, (2, 96, 2, 64), torch.float32, cuda), _rnd(rng, (2, 96, 2, 64),
                                                               torch.float32, cuda)
    n_fa, n_fd = fa.flash_attention.launches, fd.flash_decode.launches
    o = ops.attention(q, k, v, causal=True)
    o1 = ops.attention(q[:, -1:], k, v, kv_valid_len=96)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fd.flash_decode.launches) == (n_fa + 1, n_fd + 1)
    assert _err(o, fa.flash_attention_plain(q, k, v)) < 1e-4
    assert _err(o1, o[:, -1:]) < 1e-4


def test_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        fd.flash_decode(q[:, :1], q, q, 8)


def _rel(a, ref):
    return _err(a, ref) / (float(ref.float().abs().max()) + 1e-6)


def _ssd_inputs(rng, b, s, h, p, n, dtype, device):
    x = _rnd(rng, (b, s, h, p), dtype, device)
    dt = torch.from_numpy(np.abs(rng.standard_normal((b, s, h)) * 0.1).astype(np.float32)
                          ).to(device)
    A = -torch.from_numpy(np.abs(rng.standard_normal(h)).astype(np.float32)).to(device)
    B, C = _rnd(rng, (b, s, n), dtype, device), _rnd(rng, (b, s, n), dtype, device)
    D = _rnd(rng, (h,), torch.float32, device)
    return x, dt, A, B, C, D


SSD_SHAPES = [  # (b, s, h, p, n, chunk)
    (2, 128, 2, 16, 8, 32),      # the sweep of tests/test_kernels.py
    (2, 256, 2, 16, 8, 64),
    (2, 512, 2, 16, 8, 128),
    (2, 128, 8, 32, 16, 32),     # reduced zamba2
    (1, 512, 4, 64, 64, 256),    # zamba2-1.2b's head widths
    (1, 300, 3, 24, 12, 100),    # chunk not a multiple of the 64-row tile
    # the bf16 tensor-core split at chunks 32 to 256, n and p in {16, 32, 64}
    (2, 512, 4, 64, 64, 256),
    (1, 256, 3, 16, 32, 64),
    (1, 512, 2, 32, 16, 128),
    (2, 128, 4, 64, 16, 32),
    (1, 512, 2, 16, 64, 256),
    # n = p = 64 (TMA tiles) at chunks under 64 and not a multiple of it:
    # tile rows past the chunk hold the next chunk's values, masked
    (2, 256, 4, 64, 64, 32),
    (1, 300, 2, 64, 64, 100),
    # chunks of several blocks of four 64-row tiles (TMA; cp.async)
    (1, 1024, 2, 64, 64, 512),
    (1, 1024, 2, 32, 16, 1024),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_vs_plain(cuda, b, s, h, p, n, chunk, dtype):
    x, dt, A, B, C, D = _ssd_inputs(np.random.default_rng(3), b, s, h, p, n, dtype, cuda)
    n0 = ssd.ssd_scan.launches
    y = ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == n0 + 1
    ref = ssd.ssd_scan_plain(x.float(), dt, A, B.float(), C.float(), D, chunk=chunk)
    assert y.dtype == dtype and y.shape == x.shape
    assert _rel(y, ref) < TOL[dtype]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_kernel_vs_plain(cuda, b, s, h, p, n, chunk, dtype):
    rng = np.random.default_rng(4)
    ins = _ssd_inputs(rng, b, s, h, p, n, dtype, cuda)
    dy = _rnd(rng, (b, s, h, p), dtype, cuda)
    n0 = ssd._launch_bwd.launches
    got = ssd._launch_bwd(*ins, dy, chunk)
    torch.cuda.synchronize()
    assert ssd._launch_bwd.launches == n0 + 1
    x, dt, A, B, C, D = ins
    ref = ssd.ssd_scan_bwd_plain(x.float(), dt, A, B.float(), C.float(), D, dy.float(),
                                 chunk=chunk)
    for name, g, r, t in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref, ins):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        assert _rel(g, r) < TOL[dtype], (name, _rel(g, r))


def test_ssd_scan_autograd_uses_the_kernels(cuda):
    x, dt, A, B, C, D = (t.requires_grad_(True) for t in _ssd_inputs(
        np.random.default_rng(5), 2, 128, 4, 32, 16, torch.float32, cuda))
    n0 = (ssd.ssd_scan.launches, ssd._launch_bwd.launches)
    y = ops.ssd_scan(x, dt, A, B, C, D, chunk=32)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert (ssd.ssd_scan.launches, ssd._launch_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    ins = [t.detach() for t in (x, dt, A, B, C, D)]
    ref = ssd.ssd_scan_bwd_plain(*ins, 2 * ssd.ssd_scan_plain(*ins, chunk=32), chunk=32)
    for t, r in zip((x, dt, A, B, C, D), ref):
        assert _rel(t.grad, r) < 1e-4


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 2048, 64, 64, 64, 256), (2, 512, 2, 16, 8, 128),
                                             (1, 300, 3, 24, 12, 100)])
def test_ssd_scan_bwd_bf16_at_the_models_decay(cuda, b, s, h, p, n, chunk):
    """dt = softplus(N(0, 1)) and A in [-16, -1], as the model's init gives
    them: hundreds of e-folds of decay inside a chunk, where ddt and dA are
    small differences of large row and column sums of the gated terms."""
    rng = np.random.default_rng(14)
    x, _, _, B, C, D = _ssd_inputs(rng, b, s, h, p, n, torch.bfloat16, cuda)
    dt = torch.nn.functional.softplus(_rnd(rng, (b, s, h), torch.float32, cuda))
    A = -torch.linspace(1.0, 16.0, h, device=cuda)
    dy = _rnd(rng, (b, s, h, p), torch.bfloat16, cuda)
    got = ssd._launch_bwd(x, dt, A, B, C, D, dy, chunk)
    ref = ssd.ssd_scan_bwd_plain(x.float(), dt, A, B.float(), C.float(), D, dy.float(),
                                 chunk=chunk)
    for name, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref):
        assert _rel(g, r) < 2e-2, (name, _rel(g, r))


@pytest.mark.parametrize("seed", range(6))
def test_ssd_scan_bwd_bf16_dA_over_draws(cuda, seed):
    """dA sums dt times a cumsum of differences of large sums: with the bf16
    forward's own entering states (B o g and S_{k-1} rounded to bf16) it
    moved by up to 5e-2 of its scale over draws like these; the backward
    recomputes them to about 16 bits."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, s, h, p, n, chunk = 2, 512, 2, 16, 8, 128
    x, dy = (torch.randn((b, s, h, p), generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    B, C = (torch.randn((b, s, n), generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    dt = (torch.randn((b, s, h), generator=g, device=cuda) * 0.1).abs()
    A, D = -torch.linspace(1.0, 16.0, h, device=cuda), torch.ones(h, device=cuda)
    got = ssd._launch_bwd(x, dt, A, B, C, D, dy, chunk)
    ref = ssd.ssd_scan_bwd_plain(x.float(), dt, A, B.float(), C.float(), D, dy.float(),
                                 chunk=chunk)
    for name, gr, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref):
        assert _rel(gr, r) < 2e-2, (name, _rel(gr, r))


@pytest.mark.parametrize("seed", range(4))
def test_ssd_scan_bwd_f32_at_the_models_decay_against_f64(cuda, seed):
    """The f32 backward keeps the chunk cumsum, the row and column sums of
    the gated terms and their reverse cumsum in f64: at the model's decay
    its six gradients stay within 1e-5 of the plain version computed in f64
    (the plain version in f32 is itself off by more than that there)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, s, h, p, n, chunk = 1, 1024, 8, 64, 64, 256
    x, dy = (torch.randn((b, s, h, p), generator=g, device=cuda) for _ in range(2))
    B, C = (torch.randn((b, s, n), generator=g, device=cuda) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device=cuda))
    A, D = -torch.linspace(1.0, 16.0, h, device=cuda), torch.ones(h, device=cuda)
    got = ssd._launch_bwd(x, dt, A, B, C, D, dy, chunk)
    ref = ssd.ssd_scan_bwd_plain(*(t.double() for t in (x, dt, A, B, C, D, dy)), chunk=chunk)
    for name, gr, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref):
        assert _rel(gr, r) < 1e-5, (name, _rel(gr, r))


def test_ssd_scan_bwd_bf16_is_deterministic(cuda):
    """The bf16 backward sums its partials in a fixed order, no atomics: two
    calls give the same bits, at zamba2's widths (TMA tiles, heads in
    groups) and at a ragged chunk."""
    for b, s, h, p, n, chunk in ((2, 512, 16, 64, 64, 256), (1, 300, 3, 24, 12, 100)):
        rng = np.random.default_rng(12)
        ins = _ssd_inputs(rng, b, s, h, p, n, torch.bfloat16, cuda)
        dy = _rnd(rng, (b, s, h, p), torch.bfloat16, cuda)
        first, second = (ssd._launch_bwd(*ins, dy, chunk) for _ in range(2))
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_flash_decode_split_is_deterministic(cuda):
    """Several runs merged in a fixed order: the same bits every call, one
    launch counted per call."""
    rng = np.random.default_rng(10)
    q = _rnd(rng, (2, 1, 32, 128), torch.bfloat16, cuda)
    k, v = (_rnd(rng, (2, 2048, 8, 128), torch.bfloat16, cuda) for _ in range(2))
    n0 = fd.flash_decode.launches
    outs = [fd.flash_decode(q, k, v, 1999) for _ in range(3)]
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == n0 + 3
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert fd.split_plan(2, 8, 4, 1999, 132)[0] > 1


def test_ssd_scan_bf16_autograd_uses_the_kernels(cuda):
    """The bf16 tensor-core forward under autograd, as the train step runs
    it: one forward and one backward launch, gradients held at the bf16
    gate."""
    x, dt, A, B, C, D = (t.requires_grad_(True) for t in _ssd_inputs(
        np.random.default_rng(11), 2, 256, 4, 64, 64, torch.bfloat16, cuda))
    n0 = (ssd.ssd_scan.launches, ssd._launch_bwd.launches)
    y = ops.ssd_scan(x, dt, A, B, C, D, chunk=64)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (ssd.ssd_scan.launches, ssd._launch_bwd.launches) == (n0[0] + 1, n0[1] + 1)
    ins = [t.detach().float() for t in (x, dt, A, B, C, D)]
    ref_y = ssd.ssd_scan_plain(*ins, chunk=64)
    assert _rel(y.detach(), ref_y) < 2e-2
    ref = ssd.ssd_scan_bwd_plain(*ins, 2 * y.detach().float(), chunk=64)
    for t, r in zip((x, dt, A, B, C, D), ref):
        assert _rel(t.grad, r) < 2e-2


@pytest.mark.parametrize("B,Sq,Skv,H,K,D", [
    (2, 256, 256, 8, 8, 64),    # MHA, the zamba2 shared block's head width
    (2, 256, 256, 8, 2, 128),   # GQA 4:1
    (1, 192, 192, 4, 1, 32),    # MQA
    (2, 200, 200, 4, 2, 64),    # ragged tail tile
    (1, 64, 200, 4, 2, 64),     # Sq < Skv, end-aligned
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_kernel_vs_plain(cuda, B, Sq, Skv, H, K, D, dtype, causal):
    rng = np.random.default_rng(6)
    q = _rnd(rng, (B, Sq, H, D), dtype, cuda)
    k, v = _rnd(rng, (B, Skv, K, D), dtype, cuda), _rnd(rng, (B, Skv, K, D), dtype, cuda)
    do = _rnd(rng, (B, Sq, H, D), dtype, cuda)
    scale = D ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    n0 = fa._launch_bwd.launches
    got = fa._launch_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert fa._launch_bwd.launches == n0 + 1
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                       causal=causal, scale=scale)
    for name, g, r, t in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape, name
        assert _rel(g, r) < TOL[dtype], (name, _rel(g, r))


def test_flash_attention_autograd_uses_the_kernels(cuda):
    rng = np.random.default_rng(7)
    q = _rnd(rng, (2, 128, 8, 64), torch.float32, cuda).requires_grad_(True)
    k = _rnd(rng, (2, 128, 2, 64), torch.float32, cuda).requires_grad_(True)
    v = _rnd(rng, (2, 128, 2, 64), torch.float32, cuda).requires_grad_(True)
    n0 = (fa.flash_attention.launches, fa._launch_bwd.launches)
    ops.attention(q, k, v, causal=True).square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa._launch_bwd.launches) == \
        (n0[0] + 1, n0[1] + 1)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    ref = fa.flash_attention_bwd_plain(qd, kd, vd, 2 * fa.flash_attention_plain(qd, kd, vd))
    for t, r in zip((q, k, v), ref):
        assert _rel(t.grad, r) < 1e-4


def test_flash_attention_without_grad_writes_no_logsumexp(cuda):
    """Serving calls the forward kernel alone (no autograd node, no lse);
    its output is the training path's, bit for bit."""
    rng = np.random.default_rng(9)
    q = _rnd(rng, (2, 128, 8, 128), torch.bfloat16, cuda)
    k, v = (_rnd(rng, (2, 128, 2, 128), torch.bfloat16, cuda) for _ in range(2))
    o_lse, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=128 ** -0.5)
    n0 = fa.flash_attention.launches
    with torch.no_grad():
        o = ops.attention(q.requires_grad_(True), k, v, causal=True)
    assert fa.flash_attention.launches == n0 + 1
    assert o.grad_fn is None and lse.shape == (2, 8, 128)
    assert torch.equal(o, o_lse)


def test_ssd_kernel_rejects_unsupported_widths(cuda):
    """p = 128 is over the kernels' 64: with or without the final state the
    call raises before any launch.  p = 16 they take, state included."""
    x, dt, A, B, C, D = _ssd_inputs(np.random.default_rng(8), 1, 64, 2, 128, 8,
                                    torch.float32, cuda)
    n0 = (ssd.ssd_scan.launches, ssd.ssd_scan.final_state_launches)
    with pytest.raises(ValueError, match="unsupported"):
        ssd.ssd_scan(x, dt, A, B, C, D, chunk=32)
    with pytest.raises(ValueError, match="unsupported"):
        ops.ssd_scan(x, dt, A, B, C, D, chunk=32, return_final_state=True)
    assert (ssd.ssd_scan.launches, ssd.ssd_scan.final_state_launches) == n0
    y, st = ops.ssd_scan(x[..., :16], dt, A, B, C, D, chunk=32, return_final_state=True)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.final_state_launches == n0[1] + 1
    ry, rst = ssd.ssd_scan_plain(x[..., :16], dt, A, B, C, D, chunk=32,
                                 return_final_state=True)
    assert _rel(y, ry) < TOL[torch.float32] and _rel(st, rst) < TOL[torch.float32]


FINAL_STATE_SHAPES = [  # (b, s, h, p, n, chunk)
    (2, 64, 8, 32, 16, 32),      # reduced zamba2's 64-token prefill
    (2, 24, 8, 32, 16, 32),      # a prompt shorter than the chunk
    (2, 512, 4, 64, 64, 256),    # zamba2-1.2b's widths, two chunks (TMA in bf16)
    (1, 300, 3, 24, 12, 100),    # ragged tiles, odd widths
    (2, 128, 4, 64, 16, 32),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", FINAL_STATE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_final_state_kernel_vs_plain(cuda, b, s, h, p, n, chunk, dtype):
    """The forward kernels' final state (b, h, p, n), f32, and their y, against
    `ssd_scan_plain(..., return_final_state=True)` in f32 on the same inputs;
    the state seeds decode and takes no gradient."""
    x, dt, A, B, C, D = _ssd_inputs(np.random.default_rng(13), b, s, h, p, n, dtype, cuda)
    n0 = (ssd.ssd_scan.launches, ssd.ssd_scan.final_state_launches)
    y, st = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk, return_final_state=True)
    torch.cuda.synchronize()
    assert (ssd.ssd_scan.launches, ssd.ssd_scan.final_state_launches) == (n0[0] + 1, n0[1] + 1)
    ry, rst = ssd.ssd_scan_plain(x.float(), dt, A, B.float(), C.float(), D, chunk=chunk,
                                 return_final_state=True)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n) and y.dtype == dtype
    assert _rel(y, ry) < TOL[dtype] and _rel(st, rst) < TOL[dtype]
    # the y of a call without the state is the same launch's y, bit for bit
    assert torch.equal(ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk), y)
    xg = x.detach().requires_grad_(True)
    y2, st2 = ssd.ssd_scan(xg, dt, A, B, C, D, chunk=chunk, return_final_state=True)
    assert y2.requires_grad and not st2.requires_grad


# --- the live seam on the card ----------------------------------------------
# tests/test_runtime.py's SMALL_CFG: d_head 16, a width no kernel takes
SMALL = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
             d_ff=128, vocab=256, tie_embeddings=True, param_dtype="float32",
             compute_dtype="float32", attn_block_q=32, attn_block_kv=32)


def _launch_counts():
    return (fa.flash_attention.launches, fa._launch_bwd.launches,
            fd.flash_decode.launches, ssd.ssd_scan.launches, ssd._launch_bwd.launches)


def _to(tree, device):
    """A copy of tree on device (a train step updates its params in place)."""
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device, copy=True)
            for k, v in tree.items()}


def test_head_dim_16_on_the_card_raises_before_any_launch(cuda):
    """No kernel takes d_head 16 and `ops` gives way to no plain version on
    the card: a train step and a serve of SMALL_CFG raise `ValueError`
    before any launch (the runtime contracts at that width run on the CPU,
    tests/test_torch_runtime.py)."""
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.training import (AdamW, make_train_state, make_train_step,
                                      synthetic_batch)

    cfg = ModelConfig(**SMALL)
    assert cfg.d_head == 16
    opt = AdamW(lr=1e-3, eps=1e-3, warmup=1, total_steps=4)
    params = init_params(cfg, seed=0, device="cuda")
    n0 = _launch_counts()
    with pytest.raises(ValueError, match="unsupported shapes"):
        make_train_step(cfg, opt)(make_train_state(_to(params, "cuda"), opt),
                                  synthetic_batch(cfg, 4, 32, device="cuda"))
    reqs = [Request(rid=0, prompt=np.arange(12, dtype=np.int32), max_new_tokens=4)]
    with pytest.raises(ValueError, match="unsupported shapes"):
        ServeEngine(cfg, params, max_seq=64, device="cuda").serve_batch(reqs)
    torch.cuda.synchronize()
    assert _launch_counts() == n0


def test_elastic_job_preempt_and_resume_on_the_card(cuda, tmp_path):
    """Reduced zamba2 (every training kernel) on the card: a malleable
    preempt checkpoints the exact step and moves the state to the host; a
    fresh job resumes on the card with the params bit for bit."""
    from repro_torch.configs.reduced import reduced
    from repro_torch.runtime import ElasticJob
    from repro_torch.runtime.elastic import _state_leaves

    cfg = reduced("zamba2_1p2b").with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    job = ElasticJob(3, cfg, batch=2, seq=64, ckpt_dir=str(tmp_path), ckpt_every=100)
    n0 = _launch_counts()
    job.start([cuda] * 2)
    losses = [job.step()["loss"] for _ in range(3)]
    assert all(np.isfinite(losses))
    fwd, bwd, _, ssd_fwd, ssd_bwd = (a - b for a, b in zip(_launch_counts(), n0))
    assert min(fwd, bwd, ssd_fwd, ssd_bwd) > 0
    job.resize([cuda])
    assert job.resize_costs[-1] >= 0
    at_preempt = [t.clone() for t in _state_leaves(job.state.params)]
    assert all(t.is_cuda for t in at_preempt)
    job.preempt(warning=True)
    assert all(t.device.type == "cpu" for t in _state_leaves(job.state))
    job2 = ElasticJob(3, cfg, batch=2, seq=64, ckpt_dir=str(tmp_path))
    job2.resume([cuda] * 3)
    assert job2.step_idx == 3
    restored = _state_leaves(job2.state.params)
    assert all(t.is_cuda for t in restored)
    assert all(torch.equal(a, b) for a, b in zip(at_preempt, restored))
    assert np.isfinite(job2.step()["loss"])


def test_elastic_cluster_reduced_on_the_card(cuda):
    from repro_torch.launch import elastic_cluster

    n0 = _launch_counts()
    stats = elastic_cluster.main(["--reduced", "--speed", "inf", "--target-steps", "12",
                                  "--ckpt-every", "6"])
    torch.cuda.synchronize()
    events = [e["event"] for e in stats["cluster_log"]]
    assert {"od_acquire", "shrink", "expand"} <= set(events)
    assert all(j["steps_done"] == 12 and all(np.isfinite(j["losses"]))
               for j in stats["jobs"].values())
    assert stats["device"].startswith("cuda")
    assert all(a > b for a, b in zip(_launch_counts(), n0))


def test_hybrid_serving_reduced_on_the_card(cuda):
    """Reduced zamba2 in f32 served on the card (ssd_scan with its final
    state, flash_attention, flash_decode) against the same params on the
    CPU (the plain versions): prefill logits within 1e-4 and every cache
    leaf within 1e-4 (atol and rtol, as tests/test_torch_hybrid_serving.py
    holds the CPU against the reference: the SSD states grow past 1), then
    8 greedy decode steps with logits within 1e-4 and equal tokens."""
    from repro_torch.configs.reduced import reduced
    from repro_torch.models import decode_step, init_params, prefill

    cfg = reduced("zamba2_1p2b")
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 64)))
    out = {}
    n0 = _launch_counts()
    for dev, p in (("cpu", params), ("cuda", _to(params, "cuda"))):
        logits, cache = prefill(p, toks.to(dev), cfg)
        # copies: decode_step updates the cache in place
        pre = (logits.cpu(), [t.cpu().clone() for t in (*cache["mamba"], *cache["attn"])])
        cache["attn"] = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 8))
                              for c in cache["attn"])
        tok, steps = logits.argmax(-1), []
        for i in range(8):
            logits, cache = decode_step(p, cache, tok[:, None], 64 + i, cfg)
            tok = logits.argmax(-1)
            steps.append((logits.cpu(), tok.tolist()))
        out[dev] = pre, steps
    torch.cuda.synchronize()
    (cl, cc), cs = out["cpu"]
    (gl, gc), gs = out["cuda"]
    assert _err(gl, cl) < 1e-4
    for name, g, c in zip(("conv_x", "conv_bc", "ssm", "k", "v"), gc, cc):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, name=name: f"{name}: {m}")
    for (g, gt), (c, ct) in zip(gs, cs):
        assert gt == ct and _err(g, c) < 1e-4
    fwd, bwd, dec, ssd_fwd, ssd_bwd = (a - b for a, b in zip(_launch_counts(), n0))
    groups = cfg.n_layers // cfg.attn_every
    assert (fwd, bwd, dec, ssd_fwd, ssd_bwd) == (groups, 0, 8 * groups, cfg.n_layers, 0)


def test_decision_sweep_on_the_card_equals_the_cpu(cuda):
    """The batched decision sweep (plain torch ops, no hand-written kernel)
    on a small captured grid of all 13 mechanisms: every output on the card
    equals the CPU's exactly in float64, the replay is parity_ok against
    the numpy engine, and float32 on the card meets the reference's
    invariants (decision_torch's contract)."""
    from repro_torch.core import Experiment, WorkloadConfig, registered_mechanisms
    from repro_torch.core import decision_torch as T

    res = Experiment(mechanisms=registered_mechanisms(),
                     workloads=[WorkloadConfig(n_jobs=40, notice_mix=m) for m in ("W1", "W4")],
                     seeds=(0, 1), processes=0, device="torch", device_capture=32).run()
    rep = res.device_report
    assert rep.parity_ok and rep.n_mismatches == 0 and rep.n_calls > 0
    cells = [(str(i), r.decision_trace) for i, r in enumerate(res.runs)]
    batches, _index, _pads = T._build_batches(cells, "float64")
    assert len(batches) == 5
    on_card = T.to_numpy(T._sweep_program(T.to_device(batches, "cuda")))
    on_cpu = T.to_numpy(T._sweep_program(T.to_device(batches, "cpu")))
    for kernel, outs in on_cpu.items():
        outs = outs if isinstance(outs, tuple) else (outs,)
        card = on_card[kernel] if isinstance(on_card[kernel], tuple) else (on_card[kernel],)
        for g, c in zip(card, outs):
            assert g.dtype == c.dtype and np.array_equal(g, c), kernel
    rep32 = T.run_device_sweep(cells, dtype="float32", device="cuda")
    assert rep32.parity_ok, rep32.mismatches[:5]


def test_campaign_grid_replay_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """The `faulty` campaign's grid (examples/campaigns/faulty.toml, offline)
    replayed through the decision sweep on the card equals the same replay
    on the CPU: in float64 both are parity_ok with no mismatch and no
    dropped call, over the same calls, and every output is equal."""
    import dataclasses
    from pathlib import Path

    from repro_torch.campaign import CampaignSpec
    from repro_torch.core import decision_torch as T

    monkeypatch.setenv("REPRO_OFFLINE", "1")
    toml = Path(__file__).resolve().parents[1] / "examples" / "campaigns" / "faulty.toml"
    exp, _regimes = CampaignSpec.load(str(toml)).to_experiment(offline=True, processes=0)
    exp = dataclasses.replace(exp, device="torch", device_capture=4096)
    on_card = exp.run()
    on_cpu = dataclasses.replace(exp, sweep_device="cpu").run()
    reports = (on_card.device_report, on_cpu.device_report)
    for rep in reports:
        assert rep.dtype == "float64" and rep.parity_ok
        assert rep.n_mismatches == 0 and rep.n_dropped == 0
    assert reports[0].n_calls == reports[1].n_calls > 2000
    cells = [(str(i), r.decision_trace) for i, r in enumerate(on_card.runs)]
    batches, _index, _pads = T._build_batches(cells, "float64")
    card = T.to_numpy(T._sweep_program(T.to_device(batches, "cuda")))
    cpu = T.to_numpy(T._sweep_program(T.to_device(batches, "cpu")))
    for kernel, outs in cpu.items():
        outs = outs if isinstance(outs, tuple) else (outs,)
        got = card[kernel] if isinstance(card[kernel], tuple) else (card[kernel],)
        for g, c in zip(got, outs, strict=True):
            assert g.dtype == c.dtype and np.array_equal(g, c), kernel


def _moe_variant(name):
    """Reduced olmoe (f32) as it is, with capacity factor 0.5 ("dropping":
    prefill drops assignments), or with a shared expert and a dense first
    block ("shared_dense")."""
    import dataclasses

    from repro_torch.configs.reduced import reduced
    cfg = reduced("olmoe_1b_7b")
    if name == "dropping":
        return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    if name == "shared_dense":
        return cfg.with_(moe=dataclasses.replace(cfg.moe, n_shared=1, first_dense=1,
                                                 d_first_dense=256))
    return cfg


def _moe_prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in (40, 57, 64, 33)]


@pytest.mark.parametrize("variant", ["base", "dropping", "shared_dense"])
def test_moe_reduced_on_the_card(cuda, variant):
    """Reduced olmoe in f32 on the card (flash_attention, flash_decode and
    the attention backward) against the same seeded params on the CPU:
    prefill logits within 1e-4, `ServeEngine`'s greedy tokens equal, and
    one train step's loss, grad norm and params within 1e-4 (AdamW eps
    1e-3, as tests/test_torch_training.py explains)."""
    from repro_torch.models import init_params, prefill
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.training import (AdamW, make_train_state, make_train_step,
                                      synthetic_batch)
    from repro_torch.training.optimizer import tree_leaves

    cfg = _moe_variant(variant)
    params = init_params(cfg, seed=0, device="cpu")
    prompts = _moe_prompts(cfg, 5)
    toks = torch.from_numpy(np.stack([np.pad(p, (64 - len(p), 0)) for p in prompts]))
    opt = AdamW(lr=1e-3, eps=1e-3, warmup=1, total_steps=4)
    out = {}
    n0 = _launch_counts()
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, _ = prefill(p, toks.to(dev), cfg)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=8) for i, pr in enumerate(prompts)]
        ServeEngine(cfg, p, max_seq=128, device=dev).serve_batch(reqs)
        state, m = make_train_step(cfg, opt)(make_train_state(p, opt),
                                             synthetic_batch(cfg, 2, 64, device=dev))
        out[dev] = (logits.cpu(), [r.tokens_out for r in reqs], m, state.params)
    torch.cuda.synchronize()
    (lc, tc, mc, pc), (lg, tg, mg, pg) = out["cpu"], out["cuda"]
    assert _err(lg, lc) < 1e-4
    assert tg == tc
    for k in ("loss", "grad_norm", "aux"):
        assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * max(1.0, abs(float(mc[k]))), k
    for a, b in zip(tree_leaves(pc), tree_leaves(pg)):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    fwd, bwd, dec, ssd_fwd, ssd_bwd = (a - b for a, b in zip(_launch_counts(), n0))
    L = cfg.n_layers
    # prefill twice (one alone, one in the engine), 7 decode steps, one step
    assert (fwd, bwd, dec, ssd_fwd, ssd_bwd) == (3 * L, L, 7 * L, 0, 0)


def test_moe_serving_on_the_card_is_deterministic(cuda):
    """bf16 reduced olmoe with a shared expert and a dense first block: a
    second serve of the same requests on the same engine gives the same
    tokens (no float atomics in dispatch or combine)."""
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServeEngine

    cfg = _moe_variant("shared_dense").with_(param_dtype="bfloat16",
                                             compute_dtype="bfloat16")
    engine = ServeEngine(cfg, init_params(cfg, seed=0, device="cuda"), max_seq=128,
                         device="cuda")
    tokens = []
    for _ in range(2):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(_moe_prompts(cfg, 6))]
        engine.serve_batch(reqs)
        tokens.append([r.tokens_out for r in reqs])
    assert tokens[0] == tokens[1]
    assert all(len(t) == 16 for t in tokens[0])
