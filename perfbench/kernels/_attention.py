"""Operations and bytes of causal attention calls, from their shapes.

Each input is read once, each output written once, and only the causal
(query, key) pairs are counted; a decode call reads its cache up to its
valid length.  The arithmetic of the port's kernel table (`chip_smoke.py`'s
`attention_cost` and its backward), copied so that the benchmark keeps
its own yardstick.
"""


def forward(B, Sq, Skv, H, K, D, Dv, esize, causal=True, vlen=None, lse=False):
    """(FLOPs, bytes) of one forward call; lse adds the f32 log-sum-exp a
    training forward writes for its backward."""
    if vlen is not None:
        pairs, kv_rows = Sq * vlen, vlen
    elif causal:
        shift = Skv - Sq
        if shift == 0:
            pairs = Sq * (Sq + 1) // 2
        else:
            pairs = sum(min(Skv, max(0, i + shift + 1)) for i in range(Sq))
        kv_rows = Skv
    else:
        pairs, kv_rows = Sq * Skv, Skv
    flops = 2 * B * H * pairs * (D + Dv)
    nbytes = esize * (B * Sq * H * D + B * kv_rows * K * (D + Dv) + B * Sq * H * Dv)
    return flops, nbytes + (4 * B * H * Sq if lse else 0)


def backward(B, S, H, K, D, Dv, esize):
    """(FLOPs, bytes) of the dQ and dK / dV kernels of one causal call: S,
    dK and dQ over D, dP and dV over Dv on the causal pairs; q, k, v, o, dO
    and the log-sum-exp read, dQ, dK and dV written."""
    flops, nbytes = forward(B, S, S, H, K, D, Dv, esize)
    flops = flops // (D + Dv) * (3 * D + 2 * Dv)
    nbytes += esize * (B * S * H * (D + Dv) + B * S * K * (D + Dv)) + 4 * B * H * S
    return flops, nbytes


def heads(model):
    d, H = model["d_model"], model["n_heads"]
    return H, model["n_kv"], model.get("d_head") or d // H
