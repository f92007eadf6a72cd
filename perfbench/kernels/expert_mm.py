"""`expert_mm`, the dropless MoE's grouped products over the experts: R =
T * top_k rows sorted by expert against (E, K, N) weights, three calls a
layer (w1 and w3: K = d_model, N = d_expert; w2 the other way), recomputed
forwards included.  Dropless keeps every row, so R is known from the
shapes.  A forward call is one grouped GEMM: 2 R K N FLOPs; it reads its
rows and every expert's weight once and writes its rows out.  A backward
call is two, counted from the program's own backward counter: dX = dY w^T
and dW = x^T dY, 4 R K N FLOPs; it reads dY, x and the weights once and
writes dX and dW.  The three calls of a layer cost alike: K and N only
trade places."""

COUNTER = "expert_mm"
BWD_COUNTER = "expert_mm_bwd"
ESIZE = {"bfloat16": 2, "float32": 4}


def cost(R, K, N, E, esize, backward=False):
    """(FLOPs, bytes) of one call over R rows."""
    if backward:
        return 4 * R * K * N, esize * (R * N + 2 * R * K + 2 * E * K * N)
    return 2 * R * K * N, esize * (R * K + E * K * N + R * N)


def calls(model, unit, launches):
    """[(count, FLOPs, bytes)] of the unit's forward launches and of its
    backward launches."""
    moe = model.get("moe")
    if not moe:
        return []
    R = unit["B"] * unit["S"] * moe["top_k"]
    shape = (R, model["d_model"], moe["d_expert"], moe["n_experts"],
             ESIZE[model["compute_dtype"]])
    bwd = unit["launches"].get(BWD_COUNTER, 0)
    return ([(launches, *cost(*shape))] if launches else []) + \
        ([(bwd, *cost(*shape, backward=True))] if bwd else [])
