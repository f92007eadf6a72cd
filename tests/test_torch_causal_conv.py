"""The causal depthwise conv + SiLU dispatch point, `ops.causal_conv_silu`.

On the CPU (these count in tier 1) the dispatch takes the plain version,
which must equal the chain the Mamba-2 and mLSTM blocks ran before the
kernel existed (a zero pad, W shifted multiplies, the bias, `F.silu`, kept
here as `_chain`) exactly, values and gradients; the inputs the kernel does
not take raise `ValueError` before any launch on any other device; and the
blocks' conv tails for decode are those the chain gave.

On a card (`gpu` marker; they skip elsewhere) the kernels are held against
the plain version computed in f32 from the same inputs, scale-relative
(error over the reference's largest magnitude; dw and dbias are sums over
every batch row and time): 2e-5 in f32 (the same f32 products summed in
another order) and 2e-2 in bf16 (one rounding of each output to bf16).
Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_causal_conv.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import launch_counts, ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _chain(x, w, b):
    """The blocks' conv before the kernel: zero history, W shifted
    multiplies summed from 0, the bias, then the SiLU."""
    W = w.shape[0]
    xp = torch.cat([x.new_zeros((x.shape[0], W - 1, x.shape[2])), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(W))
    return F.silu(y + b[None, None])


def _inputs(shape, W, dtype=torch.float32, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    B, S, C = shape
    x, w, b = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(
        device=device, dtype=dtype) for sh in ((B, S, C), (W, C), (C,)))
    return x, 0.5 * w, b


# ------------------------------------------------------------------- CPU
@pytest.mark.parametrize("shape,W", [((2, 9, 6), 4), ((3, 1, 16), 4), ((1, 2, 8), 4),
                                     ((2, 40, 24), 3), ((2, 5, 7), 1), ((1, 17, 8), 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatch_equals_the_chain_exactly(shape, W, dtype):
    """Any shape on the CPU, also those the kernel refuses (W = 5, C = 6):
    values and all three gradients bit for bit, and no launch counted."""
    ins = _inputs(shape, W, dtype)
    a = [t.clone().requires_grad_(True) for t in ins]
    r = [t.clone().requires_grad_(True) for t in ins]
    before = launch_counts()
    y = ops.causal_conv_silu(*a)
    ref = _chain(*r)
    dy = torch.randn(ref.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    ga = torch.autograd.grad(y, a, dy)
    gr = torch.autograd.grad(ref, r, dy)
    assert y.dtype == dtype and torch.equal(y, ref)
    for g, h in zip(ga, gr):
        assert torch.equal(g, h)
    assert launch_counts() == before


@pytest.mark.parametrize("case", ["width 5", "channels 12", "float16", "dtypes differ",
                                  "w's channels", "bias shape", "x not 3-d"])
def test_refused_inputs_raise_value_error_before_any_launch(case):
    """`supports` is false and the kernel path raises `ValueError` for
    inputs the kernel does not take, on any device but the CPU: checked on
    the CPU itself (`refuse`) and through the dispatch on the meta device,
    which has no kernel and so reaches the same checks."""
    x, w, b = _inputs((2, 8, 16), 4)
    x, w, b = {"width 5": (x, torch.zeros(5, 16), b),
               "channels 12": (x[..., :12], w[:, :12], b[:12]),
               "float16": (x.half(), w.half(), b.half()),
               "dtypes differ": (x.bfloat16(), w, b),
               "w's channels": (x, w[:, :8], b),
               "bias shape": (x, w, b[:8]),
               "x not 3-d": (x[0], w, b)}[case]
    assert not cc.supports(x, w, b)
    with pytest.raises(ValueError, match="unsupported"):
        cc.refuse(x, w, b)
    before = launch_counts()
    with pytest.raises(ValueError, match="unsupported"):
        ops.causal_conv_silu(*(t.to("meta") for t in (x, w, b)))
    assert launch_counts() == before


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_supported_inputs_off_the_card_have_no_kernel(W, dtype):
    x, w, b = _inputs((2, 3, 16), W, dtype)
    assert cc.supports(x, w, b)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        cc.refuse(x, w, b)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.causal_conv_silu(*(t.to("meta") for t in (x, w, b)))


def test_launch_counters_are_listed_and_reset():
    from repro_torch.kernels import reset_launch_counts
    counts = launch_counts()
    assert {"causal_conv", "causal_conv_bwd"} <= set(counts)
    cc.causal_conv_silu.launches += 2
    cc._launch_bwd.launches += 1
    assert launch_counts()["causal_conv"] == counts["causal_conv"] + 2
    assert launch_counts()["causal_conv_bwd"] == counts["causal_conv_bwd"] + 1
    reset_launch_counts()
    assert launch_counts()["causal_conv"] == launch_counts()["causal_conv_bwd"] == 0


@pytest.mark.parametrize("S,chunk", [(1, 1), (2, 2), (3, 3), (2048, 256)])
def test_mamba2_prefill_conv_tails_are_the_chains(S, chunk):
    """`mamba2_fwd(..., return_state=True)`: each conv tail is what the
    plain conv gave (the last W - 1 rows of the zero history followed by
    the projected input), zero-padded in front when S < W - 1, bit for bit,
    and a tensor of its own; the output is the one without the state."""
    cfg = reduced("zamba2_1p2b")
    cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    y, st = ssm.mamba2_fwd(p, x, cfg, return_state=True)
    y0, none = ssm.mamba2_fwd(p, x, cfg)
    assert none is None and torch.equal(y, y0)
    for proj, wk, bk, tail in (("w_x", "conv_x_w", "conv_x_b", st.conv_x),
                               ("w_bc", "conv_bc_w", "conv_bc_b", st.conv_bc)):
        xi = x @ p[proj]
        _, want = ssm._causal_conv(xi, p[wk], p[bk], None)
        W = cfg.ssm.conv_width
        assert tail.shape == (2, W - 1, xi.shape[2]) and torch.equal(tail, want)
        assert tail.untyped_storage().data_ptr() != xi.untyped_storage().data_ptr()


@pytest.mark.parametrize("S", [1, 2, 64])
def test_mlstm_prefill_conv_tail_is_the_chains(S):
    cfg = reduced("xlstm_350m")
    cfg = cfg.with_(xlstm=dataclasses.replace(cfg.xlstm, chunk=min(S, 32)))
    p = ssm.init_mlstm(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    y, st = ssm.mlstm_fwd(p, x, cfg, return_state=True)
    y0, _ = ssm.mlstm_fwd(p, x, cfg)
    assert torch.equal(y, y0)
    xi = torch.chunk(x @ p["w_up"], 2, dim=-1)[0]
    _, want = ssm._causal_conv(xi, p["conv_w"], p["conv_b"], None)
    assert torch.equal(st.conv, want)


def test_decode_keeps_the_plain_conv_from_its_tail():
    """A decode token after its carried tail: the plain conv and SiLU, and
    the tail advanced by one row, on the CPU as on the card."""
    x, w, b = _inputs((2, 1, 16), 4)
    tail = torch.randn(2, 3, 16, generator=torch.Generator().manual_seed(2))
    y, new = ssm._conv_silu(x, w, b, tail, True)
    pre, want = ssm._causal_conv(x, w, b, tail)
    assert torch.equal(y, F.silu(pre)) and torch.equal(new, want)
    assert torch.equal(new[:, :2], tail[:, 1:]) and torch.equal(new[:, 2:], x)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("layers,every", [(4, 2), (6, 3)])
def test_xlstm_train_step_conv_calls_match_chip_smokes_count(monkeypatch, remat, layers,
                                                             every):
    """chip_smoke phase 19 asserts the conv's launches per xLSTM train step
    from the group structure and the remat nesting (under remat "full" an
    mLSTM block three times, a group's last twice); on the CPU the same
    path calls the conv's plain version where the card launches the
    kernel.  Groups of one and of two mLSTM blocks."""
    import importlib.util
    from pathlib import Path

    from repro_torch.models import init_params
    from repro_torch.training import AdamW, make_train_state, make_train_step, synthetic_batch
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = reduced("xlstm_350m")
    cfg = cfg.with_(n_layers=layers, remat=remat,
                    xlstm=dataclasses.replace(cfg.xlstm, chunk=16, slstm_every=every))
    calls = []
    orig = cc.causal_conv_silu_plain
    monkeypatch.setattr(cc, "causal_conv_silu_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    opt = AdamW()
    make_train_step(cfg, opt, microbatches=2)(
        make_train_state(init_params(cfg, seed=0, device="cpu"), opt),
        synthetic_batch(cfg, 2, 16, device="cpu"))
    want = chip_smoke.train_launches(cfg, microbatches=2)
    groups, n_m = layers // every, every - 1
    per_group = (3 * n_m - 1) if remat == "full" else n_m
    assert len(calls) == want["causal_conv"] == 2 * groups * per_group
    assert want["causal_conv_bwd"] == 2 * groups * n_m
    assert not any(want[k] for k in ("ssd_scan", "ssd_scan_bwd", "flash_attention",
                                     "flash_attention_bwd"))


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, r):
    a, r = a.detach().float(), r.detach().float()
    return float((a - r).abs().max()) / (float(r.abs().max()) + 1e-6)


def _plain_grads(x, w, b, dy):
    live = [t.detach().float().requires_grad_(True) for t in (x, w, b)]
    y = cc.causal_conv_silu_plain(*live)
    return y, torch.autograd.grad(y, live, dy.float())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 2048, 4096), (8, 2048, 128), (8, 2048, 2048),
                                   (3, 1, 64), (3, 2, 64), (3, 3, 64), (2, 37, 136),
                                   (5, 100, 8), (1, 17, 256), (3, 2, 2048), (2, 45, 1032)])
@pytest.mark.parametrize("W", [4, 3, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_vs_plain(cuda, shape, W, dtype):
    """Forward and backward (dx, dw, dbias) at the model's widths (zamba2's
    4096 and 128 channels, xLSTM's 2048, at 8 x 2048), at S below the halo
    and not a multiple of the kernels' segments (8 times forward; backward
    8 under 1024 channels, 32 from there), and at C not a multiple of a
    CTA's channels."""
    if W != 4 and shape[1] == 2048:
        pytest.skip("the model's widths run W = 4 alone")
    x, w, b = _inputs(shape, W, dtype, cuda, seed=sum(shape) + W)
    dy = torch.randn(shape, device=cuda).to(dtype)
    n0 = launch_counts()
    y = cc.causal_conv_silu(x, w, b)
    dx, dw, db = cc._launch_bwd(x, w, b, dy)
    torch.cuda.synchronize()
    n1 = launch_counts()
    assert n1["causal_conv"] == n0["causal_conv"] + 1
    assert n1["causal_conv_bwd"] == n0["causal_conv_bwd"] + 1
    ref, grads = _plain_grads(x, w, b, dy)
    for got, want in zip((y, dx, dw, db), (ref, *grads)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel(got, want) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_halo_crosses_batch_rows(cuda, dtype):
    """Rows of very different scale side by side: a halo read from the row
    before would show as an error of that row's scale in the next row's
    first W - 1 outputs (and in dx's last ones)."""
    x, w, b = _inputs((4, 19, 64), 4, dtype, cuda, seed=3)
    x = x * torch.tensor([1e3, 1e-3, 1e2, 1.0], device=cuda, dtype=dtype)[:, None, None]
    dy = torch.randn(x.shape, device=cuda).to(dtype)
    y = cc.causal_conv_silu(x, w, b)
    dx = cc._launch_bwd(x, w, b, dy)[0]
    ref, (rdx, _, _) = _plain_grads(x, w, b, dy)
    for row in range(4):
        assert _rel(y[row], ref[row]) < TOL[dtype]
        assert _rel(dx[row], rdx[row]) < TOL[dtype]


@pytest.mark.gpu
def test_backward_repeats_bit_for_bit(cuda):
    x, w, b = _inputs((8, 2048, 4096), 4, torch.bfloat16, cuda, seed=4)
    dy = torch.randn(x.shape, device=cuda).to(torch.bfloat16)
    first = cc._launch_bwd(x, w, b, dy)
    second = cc._launch_bwd(x, w, b, dy)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.gpu
def test_autograd_and_ops_use_the_kernels(cuda):
    """`ops.causal_conv_silu` on CUDA tensors: one forward launch, one
    backward launch through autograd, gradients those of the plain version;
    a view of stacked params and a column slice of a projection (the mLSTM's
    x) are taken."""
    x, w, b = _inputs((2, 64, 256), 4, torch.float32, cuda, seed=5)
    up = torch.cat([x, x], dim=-1)
    stacked = torch.stack([w, w])
    live = [up.requires_grad_(True), stacked.requires_grad_(True), b.requires_grad_(True)]
    n0 = launch_counts()
    y = ops.causal_conv_silu(live[0][..., :256], live[1][1], live[2])
    dy = torch.randn(y.shape, device=cuda)
    g = torch.autograd.grad(y, live, dy)
    n1 = launch_counts()
    assert (n1["causal_conv"] - n0["causal_conv"], n1["causal_conv_bwd"]
            - n0["causal_conv_bwd"]) == (1, 1)
    ref, (rdx, rdw, rdb) = _plain_grads(x, w, b, dy)
    assert _rel(y, ref) < TOL[torch.float32]
    assert _rel(g[0][..., :256], rdx) < TOL[torch.float32]
    assert float(g[0][..., 256:].abs().max()) == 0.0
    assert _rel(g[1][1], rdw) < TOL[torch.float32] and float(g[1][0].abs().max()) == 0.0
    assert _rel(g[2], rdb) < TOL[torch.float32]


@pytest.mark.gpu
def test_kernel_refuses_before_any_launch_on_the_card(cuda):
    x, w, b = _inputs((2, 8, 12), 4, torch.float32, cuda)
    n0 = launch_counts()
    with pytest.raises(ValueError, match="unsupported"):
        ops.causal_conv_silu(x, w, b)
    with pytest.raises(ValueError, match="unsupported"):
        ops.causal_conv_silu(*(t.half() for t in _inputs((2, 8, 16), 4, device=cuda)))
    assert launch_counts() == n0
