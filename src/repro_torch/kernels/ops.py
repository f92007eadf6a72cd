"""Kernel dispatch: the port's counterpart of `repro.kernels.ops.attention`
and `ops.ssd_scan`.

The three dispatch points are the reference's (`ops.py:216`, `:221` and
`:263`):

  * causal self-attention with Sq == Skv (prefill, training)
                                                     -> `flash_attention`;
  * one query token against a cache (`kv_valid_len`) -> `flash_decode`;
  * the SSD scan without a final state (training)    -> `ssd_scan`.

The routing rule, decided by shape before any launch:

  * a CPU tensor takes the kernels' plain versions (each wrapper does so);
  * a CUDA tensor launches the kernel of its dispatch point.  A shape that
    kernel's `supports` refuses (head dims other than 32, 64 and 128 for
    the attention kernels; n or p over 64, a chunk over 1024 or s not a
    multiple of it for the SSD scan) raises `ValueError` before any
    launch: no call on the card gives way to a plain version.

Everything else (non-causal and cross attention, Sq != Skv) is plain
torch, as it is jnp in the reference.  The reference's `_causal_binary` /
`_rect_chunked` (and `_merge`) exist to keep XLA's FLOP counts exact and
come with the dry-run slice.
"""
from __future__ import annotations

import math
from typing import Optional

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
    """Mamba-2 SSD (matches `ref.naive_ssd`), the reference's dispatch
    (`ops.py:254-266`): without `return_final_state` the hand-written
    kernel (its plain version on a CPU tensor; on a CUDA tensor widths it
    does not `supports` raise).  The kernel does not emit the final
    state, so on a CUDA tensor `return_final_state` raises (hybrid prefill,
    ROADMAP queue 1); on the CPU it takes `ssd_scan_plain`."""
    if not return_final_state:
        return ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    if x.device.type != "cpu":
        raise NotImplementedError("ssd_scan with return_final_state has no "
                                  "kernel yet: ROADMAP queue 1, hybrid serving")
    return ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk,
                              return_final_state=True)
