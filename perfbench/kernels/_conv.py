"""Operations and bytes of the causal depthwise conv + SiLU and its
backward, from shapes.  Only the compulsory bytes: forward, x read once, y
written once, the taps and the bias read; backward, dy and x read once, dx
written once, the taps read and their gradient and the bias's written.  The
operations, 2 W B S C a direction (the taps' multiply-adds), are far below
the card's ridge: the bytes bound it.  A Mamba-2 layer runs the conv twice,
on its x projection (expand x d_model channels) and on its B and C
projection (2 d_state)."""


def cost(B, S, C, W, esize, backward=False):
    flops = 2 * W * B * S * C
    if backward:
        return flops, esize * (3 * B * S * C + 2 * W * C + C)
    return flops, esize * (2 * B * S * C + W * C + C)


def calls(model, unit, launches, backward=False):
    """[(count, FLOPs, bytes)] of a unit's launches, split evenly between
    the layer's two convs (one of each a `mamba2_fwd`); none for a model
    with no Mamba-2 layer."""
    s = model.get("ssm")
    if not s or not launches:
        return []
    half = launches // 2
    return [(n, *cost(unit["B"], unit["S"], C, s["conv_width"], 2, backward))
            for n, C in ((launches - half, s["expand"] * model["d_model"]),
                         (half, 2 * s["d_state"]))]
