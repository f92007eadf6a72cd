"""AdamW's kernels' wrapper and its plain version (`kernels/adamw.py`), on
the CPU.

* The plain version is bit for bit the update the optimizer made before the
  kernels (the oracle below: the global norm, the clip, the bias
  corrections from scalars copied to the device, ~20 elementwise passes a
  leaf), over bf16 and f32 leaves, with the gradients in the params' dtype
  or in f32 (microbatch accumulation), clipped and not, and through the
  block-of-rows path.
* Dispatch: a CPU leaf takes the plain version and builds no kernel; a
  mesh job's DTensor leaves take it on each rank's shards (on the card the
  kernels take those shards); a dtype the kernels do not take raises
  `ValueError` before any kernel is built or launched.
* On a 2 x 2 mesh of gloo ranks, leaves split over either mesh dim, both,
  neither, unevenly, and a partial-sum gradient: every rank clips by the
  whole tree's norm, and the gathered params and moments equal the
  one-process update's bit for bit given that norm.
* The state keeps its tree, shapes and dtypes, updated in place; the bias
  corrections are made with no host copy, and the optimizer's span counts
  no host sync.

The kernels themselves run on the card alone (`tests/test_torch_gpu.py`).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.kernels import _build, adamw, launch_counts  # noqa: E402
from repro_torch.training import AdamW, global_norm  # noqa: E402
from repro_torch.training.optimizer import AdamWState, tree_leaves, tree_map  # noqa: E402


def _oracle_update(opt, grads, state, params, slice_elems):
    """The optimizer's update as it was written before the kernels, on
    copies: returns (params, m, v, gnorm, step)."""
    params, m, v = (tree_map(lambda t: t.clone(), t) for t in (params, state.m, state.v))
    gnorm = torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(grads)))
    scale = torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = opt.lr_at(step)
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(opt.b1, device=stepf.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(opt.b2, device=stepf.device), stepf)

    def upd(g, m, v, p):
        if p.dim() > 1 and p.numel() > slice_elems:
            rows = slice_elems // math.prod(p.shape[1:])
            if rows <= 1:
                blocks = zip(g, m, v, p)
            else:
                blocks = ((t[i:i + rows] for t in (g, m, v, p))
                          for i in range(0, p.shape[0], rows))
            for parts in blocks:
                upd(*parts)
            return p
        g = g.float() * scale
        m.mul_(opt.b1).add_((1 - opt.b1) * g)
        v.mul_(opt.b2).add_((1 - opt.b2) * g * g)
        u = (m / c1) / (torch.sqrt(v / c2) + opt.eps)
        u = u + opt.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        return p

    tree_map(upd, grads, m, v, params)
    return params, m, v, gnorm, step


def _tree(gen, dtype=torch.bfloat16):
    """bf16 matrices (one over the lowered block limit), an f32 leaf (as a
    router or zamba2's a_log), a nested dict."""
    return {"w": torch.randn(6, 40, generator=gen).to(dtype),
            "router": torch.randn(5, 3, generator=gen),
            "blk": {"norm": torch.randn(7, generator=gen).to(dtype),
                    "big": torch.randn(9, 8, 4, generator=gen).to(dtype)}}


def _grads(gen, params, grad_dtype, scale):
    return tree_map(lambda p: (torch.randn(p.shape, generator=gen) * scale).to(
        p.dtype if grad_dtype is None else grad_dtype), params)


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


@pytest.mark.parametrize("grad_dtype", [None, torch.float32], ids=["as_params", "f32"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("slice_elems", [1 << 30, 100], ids=["whole", "blocks"])
def test_plain_update_is_bit_for_bit_the_old_update(monkeypatch, grad_dtype, grad_scale,
                                                     slice_elems):
    monkeypatch.setattr(adamw, "UPDATE_SLICE_ELEMS", slice_elems)
    gen = torch.Generator().manual_seed(3)
    opt = AdamW(lr=1e-2, warmup=2, total_steps=6)
    params = _tree(gen)
    state = opt.init(params)
    n0 = launch_counts()
    for _ in range(3):
        grads = _grads(gen, params, grad_dtype, grad_scale)
        want_p, want_m, want_v, want_n, want_step = _oracle_update(opt, grads, state, params,
                                                                  slice_elems)
        params, state, gnorm = opt.update(grads, state, params)
        assert _equal(params, want_p) and _equal(state.m, want_m) and _equal(state.v, want_v)
        assert torch.equal(gnorm, want_n) and torch.equal(state.step, want_step)
    assert (grad_scale > 1) == (float(want_n) > opt.clip_norm)   # clipped where named so
    assert launch_counts() == n0                                  # no kernel on the CPU


def test_bias_corrections_equal_the_old_host_scalars_over_many_steps():
    opt = AdamW()
    stepf = torch.arange(1, 20_001, dtype=torch.int32).to(torch.float32)
    for b in (opt.b1, opt.b2, 0.999):
        assert torch.equal(1 - b ** stepf, 1 - torch.pow(torch.tensor(b), stepf))


def test_global_norm_on_the_cpu_is_the_plain_sum():
    gen = torch.Generator().manual_seed(0)
    tree = _tree(gen)
    want = torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))
    assert torch.equal(global_norm(tree), want)


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was built or launched")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def test_cpu_leaves_take_the_plain_version(monkeypatch):
    _no_build(monkeypatch)
    calls = []
    plain = adamw.adamw_update_plain
    monkeypatch.setattr(adamw, "adamw_update_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    gen = torch.Generator().manual_seed(1)
    opt = AdamW()
    params = _tree(gen)
    opt.update(_grads(gen, params, None, 1.0), opt.init(params), params)
    assert calls == [1]


@pytest.fixture
def one_rank_mesh():
    import torch.distributed as dist
    from repro_torch.launch.mesh import fake_world, make_mesh
    fake_world(1)
    yield make_mesh((1,), ("data",))
    dist.destroy_process_group()


def test_dtensor_leaves_take_the_plain_version(monkeypatch, one_rank_mesh):
    """A mesh job's leaves (and step) are DTensors: the plain version runs on
    each rank's shards, in place, and equals the update of the plain
    tensors; the norm comes back replicated on the mesh."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    _no_build(monkeypatch)
    gen = torch.Generator().manual_seed(2)
    opt = AdamW(lr=1e-2, warmup=1, total_steps=4)
    params = _tree(gen)
    grads = _grads(gen, params, torch.float32, 1.0)
    state = opt.init(params)
    want_p, want_s, want_n = opt.update(grads, state, tree_map(lambda t: t.clone(), params))

    def on_mesh(t):
        return distribute_tensor(t.clone(), one_rank_mesh, [Replicate()])
    dp, dg = tree_map(on_mesh, params), tree_map(on_mesh, grads)
    ds = AdamWState(step=on_mesh(state.step), m=tree_map(on_mesh, opt.init(params).m),
                    v=tree_map(on_mesh, opt.init(params).v))
    got_p, got_s, got_n = opt.update(dg, ds, dp)
    assert all(isinstance(t, DTensor) for t in tree_leaves(got_p))
    local = lambda t: t.to_local()  # noqa: E731
    assert _equal(tree_map(local, got_p), want_p)
    assert _equal(tree_map(local, got_s.m), want_s.m)
    assert _equal(tree_map(local, got_s.v), want_s.v)
    assert torch.equal(got_n.to_local(), want_n)


# a 2 x 2 mesh ("data", "model"): each leaf's param placements, and its
# gradient's where they differ (a partial sum over "model", which the
# update redistributes to the param's first)
MESH_LEAVES = {"w": ((8, 12), torch.bfloat16, ("S0", "R"), ("S0", "P")),
               "h": ((6, 16), torch.bfloat16, ("R", "S1"), None),
               "both": ((8, 8), torch.float32, ("S0", "S1"), None),
               "norm": ((7,), torch.bfloat16, ("R", "R"), None),
               "odd": ((5, 3), torch.float32, ("S0", "R"), None)}      # 3 + 2 rows
MESH_STEPS = 3


def _mesh_tree():
    """(params, grads of each step): the same on every rank."""
    gen = torch.Generator().manual_seed(9)
    params = {k: (torch.randn(shape, generator=gen) * 0.5).to(dt)
              for k, (shape, dt, _, _) in MESH_LEAVES.items()}
    grads = [{k: (torch.randn(shape, generator=gen) * 0.3).to(dt)
              for k, (shape, dt, _, _) in MESH_LEAVES.items()} for _ in range(MESH_STEPS)]
    return params, grads


def _placements(names):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [Shard(int(n[1])) if n[0] == "S" else Partial() if n == "P" else Replicate()
            for n in names]


def sharded_update_on_ranks():
    """In each of 4 gloo ranks: MESH_STEPS updates of the tree as DTensors on a
    2 x 2 mesh; returns (each step's norm, params, m, v gathered)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    params, grads = _mesh_tree()
    opt = AdamW(lr=1e-2, warmup=1, total_steps=6, clip_norm=1.0)

    def place(t, names):
        return distribute_tensor(t.clone(), mesh, _placements(names), src_data_rank=None)

    def grad(k, g):
        _, _, p_pl, g_pl = MESH_LEAVES[k]
        if g_pl is None:
            return place(g, p_pl)
        # rank (i, 0) holds the data shard, (i, 1) zeros: their sum is g
        local = place(g, ("S0", "R")).to_local() * (mesh.get_coordinate()[1] == 0)
        return DTensor.from_local(local, mesh, _placements(g_pl), run_check=False,
                                  shape=g.shape, stride=g.stride())
    state = opt.init(params)
    dp = {k: place(t, MESH_LEAVES[k][2]) for k, t in params.items()}
    ds = AdamWState(step=place(state.step, ("R", "R")),
                    m={k: place(t, MESH_LEAVES[k][2]) for k, t in state.m.items()},
                    v={k: place(t, MESH_LEAVES[k][2]) for k, t in state.v.items()})
    norms = []
    for g in grads:
        dp, ds, gnorm = opt.update({k: grad(k, t) for k, t in g.items()}, ds, dp)
        assert isinstance(gnorm, DTensor)
        norms.append(gnorm.to_local().clone())
    full = lambda tree: {k: t.full_tensor() for k, t in tree.items()}  # noqa: E731
    out = norms, full(dp), full(ds.m), full(ds.v)
    dist.barrier()
    return out


def test_sharded_leaves_on_gloo_ranks_equal_the_one_process_update():
    from repro_torch.runtime.ranks import RankGroup
    with RankGroup([f"cpu:{i}" for i in range(4)], timeout=120.0) as group:
        outs = group.results(sharded_update_on_ranks)
    norms, got_p, got_m, got_v = outs[0]
    for other in outs[1:]:                    # every rank clipped by one norm
        assert all(torch.equal(a, b) for a, b in zip(other[0], norms, strict=True))
    params, grads = _mesh_tree()
    opt = AdamW(lr=1e-2, warmup=1, total_steps=6, clip_norm=1.0)
    state = opt.init(params)
    for i, g in enumerate(grads):
        want = math.sqrt(sum(float(torch.sum(t.double() ** 2)) for t in g.values()))
        assert abs(float(norms[i]) - want) <= 1e-6 * want and want > opt.clip_norm
        step = torch.tensor(i + 1, dtype=torch.int32)
        stepf = step.to(torch.float32)
        quads = [(g[k], state.m[k], state.v[k], params[k]) for k in params]
        adamw.adamw_update_plain(quads, opt.lr_at(step), 1 - opt.b1 ** stepf,
                                 1 - opt.b2 ** stepf, b1=opt.b1, b2=opt.b2, eps=opt.eps,
                                 weight_decay=opt.weight_decay, clip_norm=opt.clip_norm,
                                 gnorm=norms[i])
    assert _equal(got_p, params) and _equal(got_m, state.m) and _equal(got_v, state.v)


def _meta_quads(p_dtype, g_dtype):
    p = torch.empty((4, 8), dtype=p_dtype, device="meta")
    m = torch.empty((4, 8), dtype=torch.float32, device="meta")
    return [(torch.empty((4, 8), dtype=g_dtype, device="meta"), m, m.clone(), p)]


@pytest.mark.parametrize("p_dtype,g_dtype", [(torch.float16, torch.bfloat16),
                                             (torch.bfloat16, torch.float16),
                                             (torch.float64, torch.float64)])
def test_a_dtype_the_kernels_do_not_take_raises_before_any_launch(monkeypatch, p_dtype,
                                                                   g_dtype):
    """Off the CPU (here the meta device, which stands for the card: the
    dtypes are checked before the device), a leaf the kernels do not take
    raises before anything is built or launched."""
    _no_build(monkeypatch)
    s = torch.ones((), device="meta")
    with pytest.raises(ValueError, match="unsupported leaf 0"):
        adamw.adamw_update(_meta_quads(p_dtype, g_dtype), s, s, s, b1=0.9, b2=0.95, eps=1e-8,
                           weight_decay=0.1, clip_norm=1.0)


def test_a_leaf_the_kernels_take_is_refused_only_for_its_device(monkeypatch):
    _no_build(monkeypatch)
    s = torch.ones((), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        adamw.adamw_update(_meta_quads(torch.bfloat16, torch.float32), s, s, s, b1=0.9,
                           b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)


def test_the_state_keeps_its_tree_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(4)
    opt = AdamW()
    params = _tree(gen)
    state = opt.init(params)
    ids = [id(t) for t in (*tree_leaves(params), *tree_leaves(state.m),
                           *tree_leaves(state.v))]
    shapes = tree_map(lambda t: (t.shape, t.dtype), params)
    new_p, new_s, gnorm = opt.update(_grads(gen, params, torch.float32, 1.0), state, params)
    assert tree_map(lambda t: (t.shape, t.dtype), new_p) == shapes
    for tree in (new_s.m, new_s.v):
        assert tree_map(lambda t: t.shape, tree) == tree_map(lambda t: t.shape, params)
        assert all(t.dtype == torch.float32 for t in tree_leaves(tree))
    assert [id(t) for t in (*tree_leaves(new_p), *tree_leaves(new_s.m),
                            *tree_leaves(new_s.v))] == ids      # in place
    assert new_s.step.dtype == torch.int32 and int(new_s.step) == 1
    assert gnorm.dtype == torch.float32 and gnorm.dim() == 0


def test_the_bias_corrections_copy_nothing_from_the_host(monkeypatch):
    """No `torch.tensor` (a host value copied to the device) in the step,
    and the optimizer's span counts no host sync."""
    gen = torch.Generator().manual_seed(5)
    opt = AdamW()
    params = _tree(gen)
    state = opt.init(params)
    grads = _grads(gen, params, None, 1.0)

    def copied(*a, **k):
        raise AssertionError("a host value copied to the device")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):     # tracing is on while it records
        monkeypatch.setattr(torch, "tensor", copied)
        opt.update(grads, state, params)
        monkeypatch.undo()
    spans = [s for s in tracing.spans() if s["name"] == "training.optimizer"]
    tracing.reset()
    assert len(spans) == 1 and not spans[0]["counts"]


def test_norm_parts_are_a_function_of_the_size_alone():
    assert [adamw.norm_parts(n) for n in (1, 2048, 2049, 2048 * 1024, 1_073_741_824)] == \
        [1, 1, 2, 1024, 1024]
