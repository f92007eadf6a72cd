"""Operations and bytes of the SSD scan and its backward, from shapes: only
the causal (t, u) pairs of each chunk; each input read once, each output
written once.  B and C are shared by the heads, so C.B^T (and, in the
backward, dB and dC from the head-summed gate gradient) is one product per
(batch, chunk).  Per head and chunk, forward: W.x over the pairs, C.S and
the state update; backward: dy.x^T and dx over the pairs, and five (n x p x
chunk) products.  The arithmetic of the port's kernel table
(`chip_smoke.py`'s `ssd_cost`), copied."""


def cost(b, s, h, p, n, chunk, esize, backward=False):
    pairs = chunk * (chunk + 1) // 2
    if backward:
        per_head = 2 * pairs * 2 * p + 5 * 2 * chunk * n * p
        shared = 3 * 2 * pairs * n
    else:
        per_head = 2 * pairs * p + 2 * 2 * chunk * n * p
        shared = 2 * pairs * n
    ins = esize * (b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + 2 * h)
    ys = esize * b * s * h * p
    flops = b * (s // chunk) * (h * per_head + shared)
    return flops, (2 * ins + ys) if backward else (ins + ys)


def shape(model):
    """(h, p, n, chunk) of the model's scan."""
    s = model["ssm"]
    d_in = s["expand"] * model["d_model"]
    return d_in // s["d_head"], s["d_head"], s["d_state"], s["chunk"]
