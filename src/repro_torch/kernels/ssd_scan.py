"""Mamba-2 SSD chunked scan: the Hopper kernels' wrappers and their plain
versions.

Counterpart of `repro.kernels.ssd_scan.ssd_scan` (a Pallas TPU kernel) and
of the jnp path `repro.kernels.ops._ssd_jnp`.  In bf16 both directions are
the chunk-parallel split on the tensor cores: the forward is
`csrc/ssd_scan_fwd.cu` (chunk states, state passing, chunk scan: three
kernels a call), the backward `csrc/ssd_scan_bwd.cu` (six kernels a call;
it recomputes the states it needs to about 16 bits).  In f32 both are
`csrc/ssd_scan.cu` (one CTA per (head, batch) looping over the chunks).  A
`torch.autograd.Function` joins them.

A CUDA tensor launches the kernels (or the wrapper raises); a CPU tensor
takes `ssd_scan_plain`, the port of `_ssd_jnp`, and autograd through it.
The tests and `chip_smoke.py` hold the kernels against those plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_DIM = 64  # the kernels take n, p <= 64
MAX_CHUNK = 1024
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SM90_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SM90_BWD_ARGTYPES = [ctypes.c_void_p] * 30 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
HEADS_PER_GROUP = 8  # heads a bf16 backward CTA sums dB and dC over


def ssd_scan_plain(x, dt, A, B, C, D, *, chunk: int = 256,
                   return_final_state: bool = False):
    """The chunked SSD in plain torch (`_ssd_jnp`): chunk-local quadratic
    attention form plus the carried inter-chunk state, computed in f32 (in
    f64 for f64 inputs, a reference for the kernels' own rounding).  With
    return_final_state, also returns the (b, h, p, n) state after the last
    token."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    c = min(chunk, s)
    nc = s // c
    assert s % c == 0, f"seq {s} not divisible by chunk {c}"
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ct).reshape(b, nc, c, h, p)
    dtf = dt.to(ct).reshape(b, nc, c, h)
    Bf = B.to(ct).reshape(b, nc, c, n)
    Cf = C.to(ct).reshape(b, nc, c, n)
    la = dtf * A.to(ct)[None, None, None, :]         # log decay per step (<=0)
    cs = torch.cumsum(la, dim=2)                     # within-chunk cumulative
    total = cs[:, :, -1, :]                          # (b,nc,h)

    # ---- intra-chunk (attention form): y_t = sum_{u<=t} C_t.B_u dA(u->t) x_u
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (b,nc,t,u,h)
    idx = torch.arange(c, device=x.device)
    causal = (idx[None, :] <= idx[:, None])[None, None, :, :, None]
    # mask in log space: exp of a masked +big region would give inf * 0
    # = NaN in the backward pass
    gate = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    cb = torch.einsum("bktn,bkun->bktu", Cf, Bf)
    w = cb[..., None] * gate
    y_intra = torch.einsum("bktuh,bkuhp->bkthp", w, xf * dtf[..., None])

    # ---- chunk states & inter-chunk scan -----------------------------------
    decay_to_end = torch.exp(total[:, :, None, :] - cs)   # (b,nc,c,h)
    states = torch.einsum("bkch,bkcn,bkchp->bkhpn", decay_to_end * dtf, Bf, xf)
    st = x.new_zeros((b, h, p, n), dtype=ct)
    prev = []
    for k in range(nc):                              # emit the state BEFORE chunk k
        prev.append(st)
        st = st * torch.exp(total[:, k])[:, :, None, None] + states[:, k]
    prev = torch.stack(prev, dim=1)                  # (b,nc,h,p,n)
    y_inter = torch.einsum("bkcn,bkch,bkhpn->bkchp", Cf, torch.exp(cs), prev)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = y + x.to(ct) * D.to(ct)[None, None, :, None]
    y = y.to(x.dtype)
    return (y, st) if return_final_state else y


def ssd_scan_bwd_plain(x, dt, A, B, C, D, dy, *, chunk: int = 256):
    """Gradients (dx, ddt, dA, dB, dC, dD) of `ssd_scan_plain` for an
    upstream dy, by autograd, each in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C, D)]
        y = ssd_scan_plain(*ins, chunk=chunk)
        return torch.autograd.grad(y, ins, dy)


def supports(x, B, chunk: int) -> bool:
    """Whether the kernels take these widths: x (b, s, h, p) and B (b, s, n)
    with p, n <= MAX_DIM, 0 < chunk <= MAX_CHUNK and s % chunk == 0.  With
    the model's own dt, A, C and D shapes, exactly the shape test of
    `_check`, which raises for any other shape on the card."""
    b, s, _, p = x.shape
    n = B.shape[-1]
    return (B.shape == (b, s, n) and 0 < p <= MAX_DIM and 0 < n <= MAX_DIM
            and 0 < chunk <= MAX_CHUNK and s % chunk == 0)


def _check(x, dt, A, B, C, D, chunk: int) -> int:
    b, s, h, _ = x.shape
    if (not supports(x, B, chunk) or dt.shape != (b, s, h) or A.shape != (h,)
            or D.shape != (h,) or C.shape != B.shape):
        raise ValueError(f"ssd_scan: unsupported shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} A{tuple(A.shape)} B{tuple(B.shape)} "
                         f"C{tuple(C.shape)} D{tuple(D.shape)} chunk {chunk} "
                         f"(n, p <= {MAX_DIM}, chunk <= {MAX_CHUNK}, s % chunk == 0)")
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    f32 = torch.float32
    return _build.check_inputs("ssd_scan", x, (dt, f32), (A, f32), B, C, (D, f32))


def _launch_fwd(x, dt, A, B, C, D, chunk: int) -> torch.Tensor:
    code = _check(x, dt, A, B, C, D, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), y.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:  # the chunk-parallel tensor-core split
            f32 = dict(device=x.device, dtype=torch.float32)
            states = torch.empty((b, s // chunk, h, n, p), **f32)
            sprev = torch.empty_like(states, dtype=torch.bfloat16)
            totals = torch.empty((b, s // chunk, h), **f32)
            fn = _build.load("ssd_scan_fwd", "ssd_scan_fwd_sm90", _SM90_ARGTYPES)
            err = fn(*ptrs, states.data_ptr(), sprev.data_ptr(), totals.data_ptr(), b, s, h,
                     p, n, chunk, stream)
        else:
            fn = _build.load("ssd_scan", "ssd_scan_fwd", _FWD_ARGTYPES)
            err = fn(*ptrs, b, s, h, p, n, chunk, code, stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return y


def _launch_bwd(x, dt, A, B, C, D, dy, chunk: int):
    """(dx, ddt, dA, dB, dC, dD) of `ssd_scan` for the upstream gradient dy,
    on CUDA tensors: bf16 launches `csrc/ssd_scan_bwd.cu`, f32 the backward
    of `csrc/ssd_scan.cu`."""
    code = _check(x, dt, A, B, C, D, chunk)
    _build.check_inputs("ssd_scan_bwd", x, dy)
    if dy.shape != x.shape:
        raise ValueError(f"ssd_scan_bwd: dy{tuple(dy.shape)} != x{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    f32 = dict(device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, s, h), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    if x.dtype == torch.bfloat16:
        hg = min(h, HEADS_PER_GROUP)
        groups, n_t, parts = -(-h // hg), -(-chunk // 64), 8 * -(-(n * p) // 256)
        dB, dC, dA, dD = (torch.empty_like(t) for t in (B, C, A, D))
        scratch = (
            torch.empty((b, nc, h), **f32),                    # dA per chunk
            torch.empty((b, nc, h), **f32),                    # chunk decay totals
            torch.empty((b, nc, n_t, h), **f32),               # dD per 64-row tile
            torch.empty((b, s, groups, n), **f32),             # dB per head group
            torch.empty((b, s, groups, n), **f32),             # dC per head group
            *(torch.empty((b, nc, h, chunk), **f32) for _ in range(5)),  # cs, dt, ddd, pn, dcs
            torch.empty((b, nc, h, n, p), **f32),              # chunk states
            torch.empty((b, nc, h, n, p), **f32),              # their gradients
            *(torch.empty((b, nc, h, n, p), dtype=torch.bfloat16, device=x.device)
              for _ in range(4)),                              # S, dS as bf16 pairs
            torch.empty((b, nc, h, parts), **f32))             # dtot per warp of the pass
        fn = _build.load("ssd_scan_bwd", "ssd_scan_bwd_sm90", _SM90_BWD_ARGTYPES)
        with torch.cuda.device(x.device):
            err = fn(*(t.data_ptr() for t in (x, dt, A, B, C, D, dy, dx, dB, dC, ddt, dA, dD,
                                              *scratch)),
                     b, s, h, p, n, chunk, hg, stream)
        out = (dx, ddt, dA, dB, dC, dD)  # every sum in a fixed order: deterministic
    else:
        dBh = torch.empty((b, s, h, n), **f32)
        dCh = torch.empty((b, s, h, n), **f32)
        dA = torch.empty((b, h), **f32)
        dD = torch.empty((b, h), **f32)
        states = torch.empty((b, h, nc, MAX_DIM, MAX_DIM), **f32)
        fn = _build.load("ssd_scan", "ssd_scan_bwd", _BWD_ARGTYPES)
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                     C.data_ptr(), D.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                     ddt.data_ptr(), dBh.data_ptr(), dCh.data_ptr(), dA.data_ptr(),
                     dD.data_ptr(), states.data_ptr(), b, s, h, p, n, chunk, code, stream)
        # B and C are shared by the heads: per-head partials, summed in a
        # fixed order
        out = (dx, ddt, dA.sum(0), dBh.sum(2), dCh.sum(2), dD.sum(0))
    if err:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError {err}")
    _launch_bwd.launches += 1
    dx, ddt, dA, dB, dC, dD = out
    return dx, ddt, dA, dB.to(B.dtype), dC.to(C.dtype), dD


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous tensor of its own (a fresh allocation is aligned;
    a view into a stacked (L, h) param need not be)."""
    return t.contiguous() if t.data_ptr() % 16 == 0 else t.clone()


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ins = [_fresh(t) for t in (x, dt, A, B, C, D)]
        ctx.save_for_backward(*ins)
        ctx.chunk = chunk
        return _launch_fwd(*ins, chunk)

    @staticmethod
    def backward(ctx, dy):
        grads = _launch_bwd(*ctx.saved_tensors, _fresh(dy), ctx.chunk)
        return (*grads, None)


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256) -> torch.Tensor:
    """x (b, s, h, p) and B, C (b, s, n) in float32 or bfloat16; dt (b, s, h),
    A (h,) and D (h,) in float32.  s must divide by min(chunk, s).  Returns
    y (b, s, h, p) in x's dtype, differentiable in all six inputs."""
    s = x.shape[1]
    c = min(chunk, s)
    assert s % c == 0, f"seq {s} not divisible by chunk {c}"
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=c)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    return _SSDScan.apply(x, dt, A, B, C, D, c)


ssd_scan.launches = 0      # forward calls that launched kernels since the last reset
                           # (one a call: bf16 launches three kernels, f32 one)
_launch_bwd.launches = 0   # backward calls that launched kernels since the last reset
                           # (one a call: bf16 launches six kernels, f32 one)
