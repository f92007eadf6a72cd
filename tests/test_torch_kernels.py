"""The port's attention kernels' plain versions and CPU dispatch against JAX.

Same numpy inputs (from a seed) go through `repro.kernels` (the JAX
reference: its oracle, its jnp dispatch path, and one interpret-mode call of
each Pallas kernel) and through `repro_torch.kernels` on the CPU, where each
wrapper takes its plain torch version and launches nothing.  bf16 inputs are
rounded from the same f32 numbers on both sides.

Tolerances: 1e-5 in f32 (both sides compute an f32 softmax; only the
summation order differs), 2e-2 in bf16 (the outputs round to bf16 from f32
values that agree to ~1e-6, so they differ by at most one bf16 ulp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# the shape sweeps of tests/test_kernels.py (flash attention, flash decode)
FA_SHAPES = [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 256, 4, 1, 64),
             (1, 512, 2, 2, 128)]
FD_SHAPES = [(2, 256, 8, 2, 64, 100), (1, 512, 4, 4, 32, 512),
             (2, 128, 4, 1, 32, 1), (1, 256, 8, 8, 128, 37)]


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _err(j, t):
    return float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())


@pytest.mark.parametrize("B,S,H,K,D", FA_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_jax_oracle(B, S, H, K, D, dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs(0, dtype, (B, S, H, D), (B, S, K, D), (B, S, K, D))
    o = fa.flash_attention(q, k, v, causal=causal)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert _err(jref.naive_attention(jq, jk, jv, causal=causal), o) < DTYPES[dtype][2]


@pytest.mark.parametrize("B,S,H,K,D", FA_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_matches_jax_ops(B, S, H, K, D, dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs(1, dtype, (B, S, H, D), (B, S, K, D), (B, S, K, D))
    o = ops.attention(q, k, v, causal=causal)
    jo = jops.attention(jq, jk, jv, causal=causal)
    assert _err(jo, o) < DTYPES[dtype][2]


def test_ops_attention_matches_jax_causal_binary():
    """The reference's exact-FLOPs causal path (S > block_q) against the
    port's single kernel dispatch."""
    (jq, jk, jv), (q, k, v) = _inputs(9, "float32", (2, 512, 4, 32), (2, 512, 2, 32),
                                      (2, 512, 2, 32))
    jo = jops.attention(jq, jk, jv, causal=True, block_q=128, block_kv=256)
    assert _err(jo, ops.attention(q, k, v, causal=True, block_q=128, block_kv=256)) < 1e-5


@pytest.mark.parametrize("B,S,H,K,D,vl", FD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_plain_matches_jax_oracle(B, S, H, K, D, vl, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(2, dtype, (B, 1, H, D), (B, S, K, D), (B, S, K, D))
    o = fd.flash_decode(q, k, v, vl)
    assert o.dtype == q.dtype and o.shape == (B, 1, H, D)
    jo = jref.naive_attention(jq, jk, jv, kv_valid_len=jnp.asarray(vl))
    assert _err(jo, o) < DTYPES[dtype][2]


@pytest.mark.parametrize("B,S,H,K,D,vl", FD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ops_decode_matches_jax_ops(B, S, H, K, D, vl, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(3, dtype, (B, 1, H, D), (B, S, K, D), (B, S, K, D))
    o = ops.attention(q, k, v, causal=False, kv_valid_len=vl, block_kv=64)
    jo = jops.attention(jq, jk, jv, causal=False, kv_valid_len=jnp.asarray(vl, jnp.int32),
                        block_kv=64)
    assert _err(jo, o) < DTYPES[dtype][2]


def test_flash_attention_matches_pallas_interpret():
    from repro.kernels.flash_attention import flash_attention as pallas_fa
    (jq, jk, jv), (q, k, v) = _inputs(4, "float32", (1, 192, 2, 32), (1, 192, 1, 32),
                                      (1, 192, 1, 32))
    jo = pallas_fa(jq, jk, jv, causal=True, block_q=64, block_kv=64, interpret=True)
    assert _err(jo, fa.flash_attention(q, k, v, causal=True)) < 1e-5


def test_flash_decode_matches_pallas_interpret():
    from repro.kernels.flash_decode import flash_decode as pallas_fd
    (jq, jk, jv), (q, k, v) = _inputs(5, "float32", (2, 1, 8, 64), (2, 256, 2, 64),
                                      (2, 256, 2, 64))
    jo = pallas_fd(jq, jk, jv, jnp.asarray(100), block_kv=64, interpret=True)
    assert _err(jo, fd.flash_decode(q, k, v, 100)) < 1e-5


@pytest.mark.parametrize("Sq,Skv", [(64, 200), (1, 37), (5, 40)])
def test_ops_rectangular_paths_match_jax(Sq, Skv):
    """Causal Sq < Skv and multi-token decode stay on the plain torch path."""
    (jq, jk, jv), (q, k, v) = _inputs(6, "float32", (2, Sq, 4, 32), (2, Skv, 2, 32),
                                      (2, Skv, 2, 32))
    assert _err(jops.attention(jq, jk, jv, causal=True), ops.attention(q, k, v)) < 1e-5
    jo = jops.attention(jq, jk, jv, kv_valid_len=jnp.asarray(Skv - 3))
    assert _err(jo, ops.attention(q, k, v, kv_valid_len=Skv - 3)) < 1e-5


def test_naive_attention_takes_dv_unlike_d():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 6, 4, 48)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 6, 2, 48)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 6, 2, 32)).astype(np.float32))
    o = ref.naive_attention(q, k, v, causal=True)
    assert o.shape == (1, 6, 4, 32)
    # row 0 sees only key 0: its output is v[0] of its kv head
    assert torch.allclose(o[0, 0, 0], v[0, 0, 0]) and torch.allclose(o[0, 0, 3], v[0, 0, 1])


def test_cpu_calls_launch_no_kernel():
    (_, _, _), (q, k, v) = _inputs(8, "float32", (1, 16, 2, 32), (1, 16, 1, 32),
                                   (1, 16, 1, 32))
    before = (fa.flash_attention.launches, fd.flash_decode.launches)
    fa.flash_attention(q, k, v)
    fd.flash_decode(q[:, :1], k, v, 9)
    ops.attention(q, k, v)
    ops.attention(q[:, :1], k, v, kv_valid_len=9)
    assert (fa.flash_attention.launches, fd.flash_decode.launches) == before


def test_wrapper_refuses_devices_without_a_kernel():
    q = torch.zeros((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        fd.flash_decode(q[:, :1], q, q, 4)
