"""Kernel dispatch: the port's counterpart of `repro.kernels.ops.attention`
and `ops.ssd_scan`.

The three dispatch points are the reference's (`ops.py:216`, `:221` and
`:263`):

  * causal self-attention with Sq == Skv (prefill, training)
                                                     -> `flash_attention`;
  * one query token against a cache (`kv_valid_len`) -> `flash_decode`;
  * the SSD scan, with or without its final state (training; hybrid
    prefill)                                         -> `ssd_scan`.

The reference sends the SSD scan with a final state to its jnp path (its
Pallas kernel has no state output); the port's kernels write the state as
one more output, so hybrid prefill runs them too.

The routing rule, decided by shape before any launch:

  * a CPU tensor takes the kernels' plain versions (each wrapper does so);
  * a CUDA tensor launches the kernel of its dispatch point.  A shape that
    kernel's `supports` refuses (head dims other than 32, 64 and 128 for
    the attention kernels, but for flash_attention's forward the MLA pairs
    (D, Dv) = (192, 128) and (48, 32); n or p over 64, a chunk over 1024
    or s not a multiple of it for the SSD scan) raises `ValueError` before
    any launch: no call on the card gives way to a plain version.

Everything else (non-causal and cross attention, Sq != Skv, the one-token
SSD recurrence `ssd_step` of hybrid decode, and the xLSTM's chunked mLSTM
scan `mlstm_scan`, which the reference writes in jnp alone) is plain torch,
as it is jnp in the reference.  The reference's `_causal_binary` /
`_rect_chunked` (and `_merge`) exist to keep XLA's FLOP counts exact and
come with the dry-run slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import flash_attention as fa
from . import flash_decode as fd
from . import ssd_scan as ssd
from .ref import naive_attention


def attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              kv_valid_len=None, block_q: int = 512, block_kv: int = 1024):
    """Multi-head attention with GQA.

    q: (B, Sq, H, D); k/v: (B, Skv, K, Dk/Dv), H % K == 0.
      * kv_valid_len set -> decode against a cache (mask t >= kv_valid_len).
      * causal           -> causal self-attention, end-aligned.
      * else             -> full (cross/encoder) attention.
    block_q / block_kv keep the reference's signature; the CUDA kernels
    tile by 64 rows and need no block sizes.
    """
    Sq, D = q.shape[1], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    if kv_valid_len is None and causal and Sq == k.shape[1]:
        return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=True, scale=scale)

    if kv_valid_len is not None and Sq == 1:
        return fd.flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                               kv_valid_len, scale=scale)

    # small / cross path: plain torch, as it is jnp in the reference
    return naive_attention(q, k, v, causal=causal, scale=scale,
                           kv_valid_len=kv_valid_len)


# ================================================================== SSD scan
def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256,
             return_final_state: bool = False):
    """Mamba-2 SSD (matches `ref.naive_ssd`): the hand-written kernel on a
    CUDA tensor (widths it does not `supports` raise), its plain version on
    a CPU tensor.  With `return_final_state`, also the f32 (b, h, p, n)
    state after the last token (prefill -> decode handoff)."""
    return ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                        return_final_state=return_final_state)


def ssd_step(state, x_t, dt_t, A, B_t, C_t, D):
    """One decode step of the SSD recurrence, in f32 (`ops.ssd_step` of the
    reference).  state: (b, h, p, n) f32; x_t (b, h, p); dt_t (b, h);
    B_t, C_t (b, n).  Returns (new state, y_t (b, h, p) in x_t's dtype)."""
    xf = x_t.float()
    dtf = dt_t.float()
    decay = torch.exp(dtf * A[None, :])
    st = state * decay[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xf * dtf[..., None], B_t.float())
    y = torch.einsum("bhpn,bn->bhp", st, C_t.float())
    y = y + xf * D[None, :, None]
    return st, y.to(x_t.dtype)


# ================================================================ mLSTM scan
def mlstm_scan(q, k, v, i_gate, f_gate, *, chunk: int = 256,
               return_final_state: bool = False):
    """Chunked-parallel mLSTM (matches `ref.naive_mlstm`), plain torch on
    any device, as the reference's is jnp alone.  q, k, v: (b, s, h, d);
    i_gate, f_gate: (b, s, h) pre-activations.  A sequence longer than
    `chunk` must be a multiple of it.  Returns y (b, s, h, d) in q's dtype;
    with `return_final_state` also the f32 (C (b, h, d, d), n (b, h, d),
    m (b, h)) matrix memory after the last token."""
    return _mlstm_chunked(q, k, v, i_gate, f_gate, min(chunk, q.shape[1]),
                          return_final_state)


def _mlstm_chunked(q, k, v, ig, fg, chunk: int, return_final_state: bool = False):
    """The reference's `_mlstm_jnp` in (b, h, chunk, c, ...) layout, every
    product an explicit batched matmul: torch.einsum's contraction order
    for the reference's three-operand einsums could build a (b, nc, c, h,
    d, d) temporary (17 GB at xlstm-350m's d = 512, 2 x 2048 tokens).  The
    carry over chunks is a Python loop from m = -1e30, as the reference's
    `lax.scan`.  The intra-chunk denominator is the row sum of the weighted
    scores, the same sum as the reference's (w @ k) . q."""
    b, s, h, d = q.shape
    c = chunk
    assert s % c == 0, f"seq {s} not divisible by chunk {c}"
    nc = s // c

    def heads_first(t):  # (b, s, h, ...) -> (b, h, nc, c, ...)
        t = t.float().reshape(b, nc, c, h, *t.shape[3:])
        return t.permute(0, 3, 1, 2, *range(4, t.dim()))

    qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
    logf = F.logsigmoid(heads_first(fg))               # (b,h,nc,c)
    ii = heads_first(ig)
    csf = torch.cumsum(logf, dim=-1)
    total = csf[..., -1]                               # (b,h,nc)

    # log-weights: within-chunk decay from u to t plus input gate at u
    lw = csf[..., :, None] - csf[..., None, :] + ii[..., None, :]   # (b,h,nc,t,u)
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    lw = lw.masked_fill(~causal, float("-inf"))
    m_intra = lw.amax(dim=-1)                          # (b,h,nc,t)

    # inter-chunk stabilized matrix memory, carried chunk by chunk
    Cs = qf.new_zeros((b, h, d, d))
    ns = qf.new_zeros((b, h, d))
    m = qf.new_full((b, h), -1e30)
    Cprev, nprev, mprev = [], [], []
    for j in range(nc):
        Cprev.append(Cs)
        nprev.append(ns)
        mprev.append(m)
        lw_end = total[..., j, None] - csf[..., j, :] + ii[..., j, :]   # (b,h,c)
        m_new = torch.maximum(m + total[..., j], lw_end.amax(dim=-1))
        wk = torch.exp(lw_end - m_new[..., None])[..., None] * kf[:, :, j]
        scale_old = torch.exp(m + total[..., j] - m_new)
        Cs = Cs * scale_old[..., None, None] + wk.transpose(-1, -2) @ vf[:, :, j]
        ns = ns * scale_old[..., None] + wk.sum(dim=-2)
        m = m_new
    Cprev = torch.stack(Cprev, dim=2)                  # state entering chunk
    nprev = torch.stack(nprev, dim=2)
    mprev = torch.stack(mprev, dim=2)                  # (b,h,nc)

    # combine intra + inter with a shared stabilizer
    m_inter = mprev[..., None] + csf                   # (b,h,nc,c)
    m_tot = torch.maximum(m_intra, m_inter)
    w_qk = (qf @ kf.transpose(-1, -2)) * torch.exp(lw - m_tot[..., None])
    num = w_qk @ vf
    den = w_qk.sum(dim=-1)
    w_int = torch.exp(m_inter - m_tot)
    num = num + w_int[..., None] * (qf @ Cprev)
    den = den + w_int * (qf @ nprev[..., None])[..., 0]
    den = torch.maximum(torch.abs(den), torch.exp(-m_tot))
    y = (num / den[..., None]).permute(0, 2, 3, 1, 4).reshape(b, s, h, d)
    y = y.to(q.dtype)
    return (y, (Cs, ns, m)) if return_final_state else y
