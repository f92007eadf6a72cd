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
    the attention kernels; n or p over 64, a chunk over 1024 or s not a
    multiple of it for the SSD scan) raises `ValueError` before any
    launch: no call on the card gives way to a plain version.

Everything else (non-causal and cross attention, Sq != Skv, and the
one-token SSD recurrence `ssd_step` of hybrid decode) is plain torch, as it
is jnp in the reference.  The reference's `_causal_binary` /
`_rect_chunked` (and `_merge`) exist to keep XLA's FLOP counts exact and
come with the dry-run slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

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

    if kv_valid_len is None and causal and Sq == k.shape[1] and v.shape[-1] == D:
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
