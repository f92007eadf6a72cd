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
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

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


# --- the split-KV decode, as csrc/flash_decode.cu cuts it -------------------
def _split_decode(q, k, v, vlen, splits, rows, scale):
    """flash_decode in plain torch, decomposed as the kernel does it: each run
    of `rows` cache positions gives f32 partial (m, l, acc) rows, and the
    runs are merged in run order.  A test oracle; nothing on the CUDA path
    calls it."""
    B, _, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, K, H // K, D).float() * scale
    ms, ls, accs = [], [], []
    for r in range(splits):
        lo, hi = r * rows, min(vlen, (r + 1) * rows)
        sc = torch.einsum("bkgd,btkd->bkgt", qg, k[:, lo:hi].float())
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p, v[:, lo:hi].float()))
    mx = torch.stack(ms).amax(0)
    w = [torch.exp(m - mx) for m in ms]
    num = sum(wi[..., None] * a for wi, a in zip(w, accs))
    den = sum(wi * li for wi, li in zip(w, ls))
    return (num / den[..., None]).reshape(B, 1, H, -1).to(q.dtype)


# (vlen, SMs) -> the runs split_plan gives B=2, K=2, G=4: one run at vlen 1
# or with few SMs, two, and one run per 32-row stage
SPLIT_CASES = [(1, 132, 1), (100, 2, 1), (100, 4, 2), (100, 132, 4), (256, 4, 2),
               (256, 132, 8), (77, 132, 3)]


@pytest.mark.parametrize("vlen,sms,splits", SPLIT_CASES)
def test_split_decode_matches_jax(vlen, sms, splits):
    B, S, H, K, D = 2, 256, 8, 2, 64
    (jq, jk, jv), (q, k, v) = _inputs(10, "float32", (B, 1, H, D), (B, S, K, D), (B, S, K, D))
    got_splits, rows = fd.split_plan(B, K, H // K, vlen, sms)
    assert got_splits == splits and rows % fd.ROWS == 0
    assert (splits - 1) * rows < vlen <= splits * rows   # no run empty
    o = _split_decode(q, k, v, vlen, splits, rows, D ** -0.5)
    assert _err(jref.naive_attention(jq, jk, jv, kv_valid_len=jnp.asarray(vlen)), o) < 2e-5
    assert float((o - fd.flash_decode_plain(q, k, v, vlen)).abs().max()) < 2e-5


def test_split_decode_matches_pallas_interpret():
    from repro.kernels.flash_decode import flash_decode as pallas_fd
    (jq, jk, jv), (q, k, v) = _inputs(11, "float32", (2, 1, 8, 64), (2, 256, 2, 64),
                                      (2, 256, 2, 64))
    splits, rows = fd.split_plan(2, 2, 4, 200, 132)
    assert splits > 1
    jo = pallas_fd(jq, jk, jv, jnp.asarray(200), block_kv=64, interpret=True)
    assert _err(jo, _split_decode(q, k, v, 200, splits, rows, 64 ** -0.5)) < 2e-5


def test_split_plan_fills_the_card_twice():
    """The serve shape (B=8, K=8, G=4) on 132 SMs: at least 264 CTAs, one run
    at vlen 1, never more runs than 32-row stages or than MAX_SPLITS."""
    for vlen in (1, 31, 32, 33, 513, 1024):
        splits, rows = fd.split_plan(8, 8, 4, vlen, 132)
        assert splits * rows >= vlen and (splits - 1) * rows < max(vlen, 1)
        if vlen <= fd.ROWS:
            assert splits == 1
        else:  # twice the SMs, or already one stage a run
            assert 64 * splits >= 264 or rows == fd.ROWS
    assert fd.split_plan(8, 8, 4, 513, 132) == (5, 128)
    assert fd.split_plan(1, 1, 1, 1 << 20, 132)[0] == fd.MAX_SPLITS


def test_cpu_calls_launch_no_kernel():
    (_, _, _), (q, k, v) = _inputs(8, "float32", (1, 16, 2, 32), (1, 16, 1, 32),
                                   (1, 16, 1, 32))
    before = (fa.flash_attention.launches, fd.flash_decode.launches)
    fa.flash_attention(q, k, v)
    fd.flash_decode(q[:, :1], k, v, 9)
    ops.attention(q, k, v)
    ops.attention(q[:, :1], k, v, kv_valid_len=9)
    assert (fa.flash_attention.launches, fd.flash_decode.launches) == before


def _shape_refused(check, *args) -> bool:
    """Whether `check` (a kernel's input check) refuses these CPU tensors
    for their shapes.  Its shape test comes first; a shape that passes it
    fails later for the device (no card here), which is not a refusal."""
    try:
        check(*args)
    except ValueError as e:
        return "unsupported shapes" in str(e)
    except (AssertionError, RuntimeError):  # torch.cuda without a card
        return False
    return False


@pytest.mark.parametrize("D", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("H,K,Bk,Dv", [(4, 4, 2, None), (4, 2, 2, None), (4, 3, 2, None),
                                       (6, 4, 2, None), (4, 2, 1, None), (4, 2, 2, 32)])
def test_flash_attention_supports_is_its_check(D, H, K, Bk, Dv):
    q, k = torch.zeros((2, 8, H, D)), torch.zeros((Bk, 8, K, D))
    v = torch.zeros((Bk, 8, K, Dv or D))
    ok = fa.supports(q, k, v)
    assert ok == (not _shape_refused(fa._check, "flash_attention", q, k, v))
    assert ok == (D in (32, 64, 128) and H % K == 0 and Bk == 2 and (Dv or D) == D)


@pytest.mark.parametrize("D,Dv", [(16, 16), (32, 32), (64, 128), (128, 32), (48, 64),
                                  (64, 16), (256, 256)])
@pytest.mark.parametrize("sq,H,K", [(1, 8, 2), (1, 8, 8), (1, 6, 4), (2, 8, 2)])
def test_flash_decode_supports_is_its_check(D, Dv, sq, H, K):
    q, k, v = torch.zeros((2, sq, H, D)), torch.zeros((2, 16, K, D)), torch.zeros((2, 16, K, Dv))
    ok = fd.supports(q, k, v)
    assert ok == (not _shape_refused(fd._validate, q, k, v))
    assert ok == (sq == 1 and H % K == 0 and D in (32, 64, 128) and Dv in (32, 64, 128))


@pytest.mark.parametrize("p,n", [(16, 8), (64, 64), (80, 16), (32, 65), (1, 1)])
@pytest.mark.parametrize("s,chunk", [(64, 32), (96, 64), (2048, 1024), (4096, 2048),
                                     (64, 0)])
def test_ssd_scan_supports_is_its_check(p, n, s, chunk):
    b, h = 1, 2
    x, dt = torch.zeros((b, s, h, p)), torch.zeros((b, s, h))
    B = C = torch.zeros((b, s, n))
    A = D = torch.zeros((h,))
    ok = ssd.supports(x, B, chunk)
    assert ok == (not _shape_refused(ssd._check, x, dt, A, B, C, D, chunk))
    assert ok == (p <= 64 and n <= 64 and 0 < chunk <= 1024 and s % chunk == 0)


def test_ops_takes_the_plain_path_for_unsupported_shapes_on_the_cpu():
    """On a CPU tensor, head dim 16 and SSD widths over 64 (which the
    kernels refuse on the card) take the plain versions, launching nothing."""
    (_, _, _), (q, k, v) = _inputs(3, "float32", (1, 16, 2, 16), (1, 16, 1, 16),
                                   (1, 16, 1, 16))
    assert not fa.supports(q, k, v) and not fd.supports(q[:, :1], k, v)
    assert _err(ref.naive_attention(q, k, v, causal=True).numpy(), ops.attention(q, k, v)) == 0
    assert _err(ref.naive_attention(q[:, :1], k, v, kv_valid_len=9).numpy(),
                ops.attention(q[:, :1], k, v, kv_valid_len=9)) == 0
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 64, 2, 80)).astype(np.float32))
    dt = torch.from_numpy(np.abs(rng.standard_normal((1, 64, 2))).astype(np.float32) * 0.1)
    B, C = (torch.from_numpy(rng.standard_normal((1, 64, 8)).astype(np.float32))
            for _ in range(2))
    A, D = -torch.ones(2), torch.ones(2)
    assert not ssd.supports(x, B, 32)
    before = ssd.ssd_scan.launches
    y = ops.ssd_scan(x, dt, A, B, C, D, chunk=32)
    assert ssd.ssd_scan.launches == before
    assert _err(ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=32).numpy(), y) == 0


def test_wrapper_refuses_devices_without_a_kernel():
    q = torch.zeros((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        fd.flash_decode(q[:, :1], q, q, 4)


# --- the bf16 tensor-core kernels' rounding, emulated in plain torch --------
# csrc/flash_attention*.cu round P (forward and backward) and dS (backward)
# to bf16 before their tensor-core products, where the plain version keeps
# f32.  Emulating exactly that on the CPU, from bf16 inputs, must stay
# within half of the 2e-2 gate that tests/test_torch_gpu.py and chip_smoke
# hold the kernels to, so that the gate is not met by luck.  Shapes: those
# of test_flash_attention_kernel_vs_plain and
# test_flash_attention_bwd_kernel_vs_plain.
RT = 1e-2  # half of the bf16 gate


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _probs(q, k, causal, scale):
    """f32 scores (B, H, Sq, Skv) with the end-aligned mask, GQA expanded."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    ke = k.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, ke) * scale
    if causal:
        i = torch.arange(Sq)[:, None] + (Skv - Sq)
        s = s.masked_fill(torch.arange(Skv)[None, :] > i, float("-inf"))
    return s


def _fwd_rounded(q, k, v, causal, scale):
    """The forward as the kernel rounds it: P in bf16 for P.V, l in f32."""
    H, K = q.shape[2], k.shape[2]
    s = _probs(q, k, causal, scale)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", _bf16(p), v.repeat_interleave(H // K, dim=2))
    lse = s.amax(-1) + torch.log(p.sum(-1))
    return _bf16(o / p.sum(-1).transpose(1, 2)[..., None]), lse


def _bwd_rounded(q, k, v, do, causal, scale):
    """dq, dk, dv as the kernels round them: P and dS in bf16 for their
    products, Delta from the bf16 forward output."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    o, lse = _fwd_rounded(q, k, v, causal, scale)
    p = torch.exp(_probs(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.repeat_interleave(G, dim=2))
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = _bf16(p * (dp - delta))
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.repeat_interleave(G, dim=2))
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), do)
    Skv = k.shape[1]
    dk, dv = (t.reshape(B, Skv, K, G, D).sum(3) for t in (dk, dv))
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _bf16_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [_bf16(torch.from_numpy(rng.standard_normal(s).astype(np.float32))) for s in shapes]


@pytest.mark.parametrize("B,Sq,Skv,H,K,D", [
    (1, 128, 128, 4, 4, 32), (2, 256, 256, 8, 2, 64), (1, 256, 256, 4, 1, 64),
    (1, 512, 512, 2, 2, 128), (1, 192, 192, 2, 1, 32), (2, 100, 100, 4, 2, 128),
    (1, 64, 200, 4, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_rounding_fits_the_forward_gate(B, Sq, Skv, H, K, D, causal):
    q, k, v = _bf16_inputs(0, (B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D))
    o, _ = _fwd_rounded(q, k, v, causal, D ** -0.5)
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    assert float((o - ref).abs().max()) < RT


@pytest.mark.parametrize("B,Sq,Skv,H,K,D", [
    (2, 256, 256, 8, 8, 64), (2, 256, 256, 8, 2, 128), (1, 192, 192, 4, 1, 32),
    (2, 200, 200, 4, 2, 64), (1, 64, 200, 4, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_and_ds_rounding_fits_the_backward_gate(B, Sq, Skv, H, K, D, causal):
    q, k, v, do = _bf16_inputs(6, (B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D),
                               (B, Sq, H, D))
    scale = D ** -0.5
    got = _bwd_rounded(q, k, v, do, causal, scale)
    refs = fa.flash_attention_bwd_plain(q, k, v, do, causal=causal, scale=scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        rel = float((g - r).abs().max()) / float(r.abs().max())
        assert rel < RT, (name, rel)


SASS_EXCERPT = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]

	code for sm_90a
		Function : _ZN11repro_torch2tc8fwd_sm90ILi64EEEvv
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
                                                                            /* 0x000fe40000000800 */
        /*0010*/                   UTMALDG.4D [UR8], [UR4] ;                /* 0x00000008040075b4 */
        /*0020*/              @!P0 HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0030*/                   FFMA.FTZ R0, R1, R2, R3 ;
        /*0040*/                   HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR8], R24, gsb0 ;
        /*0050*/                   EXIT ;
		..........

		Function : _ZN11repro_torch9dq_kernelIfLi64EEEvv
        /*0000*/                   FFMA R4, R5, R6, R4 ;
        /*0010*/               @P1 FFMA R7, R5, R6, R7 ;
        /*0020*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;
        /*0030*/                   BRA 0x30;
"""


def test_sass_parser_counts_instructions_per_kernel():
    from repro_torch.kernels import _build
    counts = _build.parse_sass(SASS_EXCERPT)
    assert counts == {
        "_ZN11repro_torch2tc8fwd_sm90ILi64EEEvv":
            {"HGMMA": 2, "HMMA": 0, "UTMALDG": 1, "FFMA": 1},
        "_ZN11repro_torch9dq_kernelIfLi64EEEvv":
            {"HGMMA": 0, "HMMA": 1, "UTMALDG": 0, "FFMA": 2},
    }
