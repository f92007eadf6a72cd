"""AdamW's kernels over a train step: the clip norm's sum of squares (one
launch a leaf, then one sum of the partials) and the update (one launch a
leaf), counted from the program's element counter, `adamw_elems`: every
element the update launches wrote in the traced steps.  Only the compulsory
bytes: g read twice (the norm, the update), p read and written, the f32
moments m and v each read and written, 2 esize(g) + 2 esize(p) + 16 bytes an
element, with both esizes the configuration's `param_dtype` (the few f32
leaves, a router or an SSM's A, D and dt bias, are counted at bf16's: the
share can only read low).  About 18 operations an element (the norm's
multiply-add, the update's 16), far below the card's ridge: the bytes bound
it.  A program without the counter reads nothing."""

COUNTER = "adamw"
ELEMS = "adamw_elems"
ESIZE = {"bfloat16": 2, "float32": 4}
FLOPS_PER_ELEM = 18


def cost(n, esize_p, esize_g=None):
    """(FLOPs, bytes) of one step over n elements."""
    esize_g = esize_p if esize_g is None else esize_g
    return FLOPS_PER_ELEM * n, n * (2 * esize_g + 2 * esize_p + 16)


def calls(model, unit, launches):
    """[(1, FLOPs, bytes)] of the unit's updated elements; none without any."""
    n = unit["launches"].get(ELEMS, 0)
    return [(1, *cost(n, ESIZE[model["param_dtype"]]))] if n else []
