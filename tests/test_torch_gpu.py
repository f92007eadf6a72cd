"""Card-only tests of the port's hand-written CUDA kernels.

Each kernel is held against its plain torch version on the same inputs, on
the GPU.  Every test takes the `cuda` fixture, which skips when no CUDA card
is present, so each worker collects the same tests.  Run them on a machine
with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: 1e-4 in float32 (same f32 math, another summation order), 2e-2
in bfloat16 against the plain version computed in f32 from the same inputs
(only the output's rounding to bf16 differs, plus, for decode, the scale
applied in f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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
