"""Plain-torch oracles for the kernels (small shapes; tests).

`naive_attention` is the counterpart of `repro.kernels.ref.naive_attention`:
it materializes the full score matrix in float32.  `naive_ssd` is that of
`repro.kernels.ref.naive_ssd`, the sequential Mamba-2 recurrence, and
`naive_mlstm` that of `repro.kernels.ref.naive_mlstm`, the sequential xLSTM
matrix-memory recurrence (the oracle of `ops.mlstm_scan`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    kv_valid_len=None) -> torch.Tensor:
    """Softmax attention, materializing full scores.

    q: (B, Sq, H, D); k: (B, Skv, K, D); v: (B, Skv, K, Dv), H % K == 0.
    With kv_valid_len: mask positions t >= valid_len (decode against a
    cache); query i sits at position valid_len - Sq + i.  Otherwise, with
    causal, query i sits at i + Skv - Sq (end-aligned).
    Returns (B, Sq, H, Dv) in q's dtype.
    """
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, K, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    ti = torch.arange(Skv, device=q.device)
    qi = torch.arange(Sq, device=q.device)
    mask = None
    if kv_valid_len is not None:
        mask = ti[None, :] <= (kv_valid_len - Sq + qi)[:, None]
    elif causal:
        mask = ti[None, :] <= (qi + (Skv - Sq))[:, None]
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", a, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def naive_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD reference: sequential recurrence over time.

    x: (b, s, h, p) input per head; dt: (b, s, h) positive step sizes;
    A: (h,) negative decay rate per head; B, C: (b, s, n) input/output
    projections shared across heads; D: (h,) skip.  Returns (b, s, h, p)
    in x's dtype; the state is f32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    decay = torch.exp(dtf * A.float()[None, None, :])           # (b,s,h)
    st = x.new_zeros((b, h, p, n), dtype=torch.float32)
    ys = []
    for t in range(s):
        db = dtf[:, t, :, None, None] * Bf[:, t, None, None, :]  # (b,h,1,n)
        st = st * decay[:, t, :, None, None] + xf[:, t, :, :, None] * db
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None, :, None]
    return y.to(x.dtype)


def naive_mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_gate: torch.Tensor, f_gate: torch.Tensor) -> torch.Tensor:
    """xLSTM mLSTM reference: sequential matrix-memory recurrence.

    q, k, v: (b, s, h, d); i_gate, f_gate: (b, s, h) pre-activations.
    Stabilized exponential gating per the xLSTM paper; the stabilizer
    starts at -inf, as the reference's does.  Returns (b, s, h, d) in q's
    dtype; the state is f32.
    """
    b, s, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    logf = F.logsigmoid(f_gate.float())                   # (b,s,h)
    i_ = i_gate.float()
    Cm = qf.new_zeros((b, h, d, d))
    nm = qf.new_zeros((b, h, d))
    m = qf.new_full((b, h), float("-inf"))
    ys = []
    for t in range(s):
        m_new = torch.maximum(logf[:, t] + m, i_[:, t])
        fd = torch.exp(logf[:, t] + m - m_new)            # (b,h)
        id_ = torch.exp(i_[:, t] - m_new)
        Cm = Cm * fd[..., None, None] + id_[..., None, None] * \
            (kf[:, t, :, :, None] * vf[:, t, :, None, :])
        nm = nm * fd[..., None] + id_[..., None] * kf[:, t]
        num = (qf[:, t, :, None, :] @ Cm)[:, :, 0]
        den = torch.abs((qf[:, t] * nm).sum(-1))
        ys.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(ys, dim=1).to(q.dtype)
