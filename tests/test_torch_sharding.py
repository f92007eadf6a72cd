"""The port's placements, `models.dist` and MoE's expert-parallel branch.

* Placements: for every config at full width, on the production meshes
  (16, 16) and (2, 16, 16) and with layout="fsdp" (not for MoE, which the
  reference refuses), the port's per-leaf placements
  (`repro_torch.sharding`) turned back into PartitionSpec form equal the
  reference's `tree_shardings` specs, computed on a `jax.sharding.AbstractMesh`
  from `jax.eval_shape` (no devices).  The same for `batch_sharding` of each
  applicable shape's inputs and `cache_shardings` of its cache.  The port's
  trees are built on the meta device, its meshes on the `fake` backend.
* `dist.constrain*` with no mesh return their argument itself.
* MoE's expert-parallel branch on a 4 x 2 mesh of 8 gloo processes on the
  CPU equals the single-device branch on the same inputs where nothing
  drops, and the reference's `shard_map` branch on 8 forced CPU devices at
  the published capacity factor, where tokens drop; each with and without
  `token_chunk`.
"""
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

import repro.sharding as jsh  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.sharding.rules import path_str  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import input_specs as jinput_specs  # noqa: E402
from repro.training import make_train_state as jmake_train_state  # noqa: E402
from repro_torch import sharding as tsh  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_production_mesh  # noqa: E402
from repro_torch.models import applicable_shapes, dist, init_cache, init_params  # noqa: E402
from repro_torch.training import AdamW, input_specs, make_train_state  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _cfgs(arch, fsdp_layout):
    over = {"layout": "fsdp"} if fsdp_layout else {}
    return jget_config(arch).with_(**over), get_config(arch).with_(**over)


@functools.lru_cache(maxsize=None)
def _mesh(multi_pod):
    """The port's production mesh, on a fake process group of its size."""
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod)


@pytest.fixture(scope="module", autouse=True)
def _no_process_group_after_the_module():
    """The fake process group `_mesh` makes is this module's alone."""
    yield
    _mesh.cache_clear()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.fixture
def mesh_pair():
    def get(multi_pod):
        shape, axes = MESHES[multi_pod]
        return AbstractMesh(shape, axes), _mesh(multi_pod)
    return get


def _norm(spec, ndim):
    """A PartitionSpec-like tuple, padded to ndim, one-axis tuples unwrapped."""
    out = list(spec) + [None] * (ndim - len(spec))
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in out)


def _ref_specs(tree_sh):
    flat = jax.tree_util.tree_flatten_with_path(tree_sh)[0]
    return {path_str(p): s.spec for p, s in flat}


def _ref_shapes(tree):
    return {path_str(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree_pl, tree, mesh):
    """Path -> spec of the port's placements, at the data tree's leaves."""
    return {p: tsh.spec_of(tsh.at_path(tree_pl, p), mesh, t.ndim)
            for p, t in tsh.leaves_with_paths(tree)}


def _assert_equal(ref_sh, ref_tree, port_pl, port_tree, mesh):
    ref = _ref_specs(ref_sh)
    ref_shapes = _ref_shapes(ref_tree)
    port = _port_specs(port_pl, port_tree, mesh)
    port_shapes = {p: tuple(t.shape) for p, t in tsh.leaves_with_paths(port_tree)}
    assert sorted(port) == sorted(ref)
    assert port_shapes == ref_shapes
    bad = {p: (port[p], _norm(s, len(ref_shapes[p]))) for p, s in ref.items()
           if port[p] != _norm(s, len(ref_shapes[p]))}
    assert not bad, bad


@functools.lru_cache(maxsize=None)
def _ref_state(arch, fsdp_layout):
    jcfg, _ = _cfgs(arch, fsdp_layout)
    return jax.eval_shape(lambda k: jmake_train_state(jinit_params(k, jcfg), JAdamW()),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_state(arch, fsdp_layout):
    _, cfg = _cfgs(arch, fsdp_layout)
    return make_train_state(init_params(cfg, device="meta"), AdamW())


CASES = [(a, mp, fl) for a in ARCH_IDS for mp in (False, True) for fl in (False, True)
         if not (fl and get_config(a).moe)]


@pytest.mark.parametrize("arch,multi_pod,fsdp_layout", CASES)
def test_train_state_placements_equal_the_references(arch, multi_pod, fsdp_layout, mesh_pair):
    jmesh, mesh = mesh_pair(multi_pod)
    jcfg, cfg = _cfgs(arch, fsdp_layout)
    ref_tree, tree = _ref_state(arch, fsdp_layout), _port_state(arch, fsdp_layout)
    _assert_equal(jsh.tree_shardings(ref_tree, jcfg, jmesh), ref_tree,
                  tsh.tree_shardings(tree, cfg, mesh), tree, mesh)


@pytest.mark.parametrize("arch,multi_pod,fsdp_layout", CASES)
def test_batch_and_cache_placements_equal_the_references(arch, multi_pod, fsdp_layout,
                                                         mesh_pair):
    jmesh, mesh = mesh_pair(multi_pod)
    jcfg, cfg = _cfgs(arch, fsdp_layout)
    for shape in applicable_shapes(cfg):
        if shape.kind == "train":
            ref_in, port_in = jinput_specs(jcfg, shape), input_specs(cfg, shape)
            _assert_equal(jsh.batch_sharding(ref_in, jmesh, axes=jsh.dp_axes(jcfg, jmesh)),
                          ref_in, tsh.batch_sharding(port_in, mesh, axes=tsh.dp_axes(cfg, mesh)),
                          port_in, mesh)
            continue
        ref_tok = jinput_specs(jcfg, shape)["tokens"]
        port_tok = input_specs(cfg, shape)["tokens"]
        _assert_equal(jsh.batch_sharding({"t": ref_tok}, jmesh), {"t": ref_tok},
                      tsh.batch_sharding({"t": port_tok}, mesh), {"t": port_tok}, mesh)
        B, S = shape.global_batch, shape.seq_len
        ref_cache = jax.eval_shape(lambda: jinit_cache(jcfg, B, S))
        port_cache = init_cache(cfg, B, S, device="meta")
        _assert_equal(jsh.cache_shardings(ref_cache, jcfg, jmesh, shape), ref_cache,
                      tsh.cache_shardings(port_cache, cfg, mesh, shape), port_cache, mesh)


def test_input_specs_are_the_references():
    """Shapes and dtypes of every arch's train, prefill and decode inputs."""
    for arch in ARCH_IDS:
        jcfg, cfg = _cfgs(arch, False)
        for shape in applicable_shapes(cfg):
            ref = {path_str(p): x for p, x in
                   jax.tree_util.tree_flatten_with_path(jinput_specs(jcfg, shape))[0]}
            port = dict(tsh.leaves_with_paths(input_specs(cfg, shape)))
            assert sorted(ref) == sorted(port)
            for k, r in ref.items():
                assert tuple(r.shape) == tuple(port[k].shape) and port[k].is_meta
                assert str(r.dtype) == str(port[k].dtype).removeprefix("torch.")


def test_placements_round_trip():
    mesh = _mesh(True)
    for spec in [(None, "model", ("pod", "data")), (("pod", "data", "model"),), ()]:
        pl = tsh.placements(spec, mesh)
        assert _norm(tsh.spec_of(pl, mesh, 3), 3) == _norm(spec, 3)


# --------------------------------------------------------------- models.dist
def test_constrain_without_a_mesh_is_the_identity():
    dist.set_mesh(None)
    x = torch.randn(4, 8, 2, 16)
    assert dist.constrain(x, "batch", None, "model", None) is x
    assert dist.constrain_batch(x) is x
    assert dist.constrain_heads(x) is x
    tree = {"a": x, "b": {"c": x[0]}}
    assert dist.constrain_tree(tree, {"a": None, "b": {"c": None}}) is tree
    assert dist.constrain_batch(None) is None and dist.get_mesh() is None


# ------------------------------------------------------ MoE expert-parallel
#: the published capacity factor of both MoE configs (olmoe-1b-7b,
#: deepseek-v2-236b); 16 is one at which nothing drops
CAPACITY_FACTORS = (1.25, 16.0)
EP_SHAPE = (8, 64)   # (B, S): 2 x 64 = 128 tokens on each of 4 dp ranks

EP_WORKER = r"""
import sys, numpy as np, torch, torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs.reduced import reduced
from repro_torch.models import dist, moe
from repro_torch.sharding import batch_axes, placements
rank, world, port, tc, inp, out = (int(sys.argv[1]), 8, sys.argv[2], int(sys.argv[3]),
                                   sys.argv[4], sys.argv[5])
tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                         world_size=world)
a = np.load(inp)
p = {k: torch.from_numpy(a[k]) for k in ("router", "w1", "w3", "w2")}
x = torch.from_numpy(a["x"])
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
pl = {"router": placements((), mesh), "w1": placements(("model",), mesh),
      "w3": placements(("model",), mesh), "w2": placements(("model",), mesh)}
pd = {k: distribute_tensor(v, mesh, pl[k]) for k, v in p.items()}
xd = distribute_tensor(x, mesh, placements(("data",), mesh))
res = {}
for cf in (1.25, 16.0):
    cfg = reduced("olmoe_1b_7b")
    cfg = cfg.with_(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, "token_chunk": tc,
                                               "capacity_factor": cf}))
    dist.set_mesh(mesh, batch_axes(mesh))
    y, aux = moe.moe_fwd(pd, xd, cfg)
    res[f"y{cf}"], res[f"aux{cf}"] = y.full_tensor().numpy(), aux.full_tensor().numpy()
    dist.set_mesh(None)
    y1, aux1 = moe.moe_fwd(p, x, cfg)
    res[f"y1_{cf}"], res[f"aux1_{cf}"] = y1.numpy(), aux1.numpy()
if rank == 0:
    np.savez(out, **res)
tdist.destroy_process_group()
"""

REF_EP = r"""
import sys, dataclasses, numpy as np, jax
from jax.sharding import AxisType
from repro.configs.reduced import reduced
from repro.models import moe, set_mesh
from repro.sharding import batch_axes
tc, cf, inp, out = int(sys.argv[1]), float(sys.argv[2]), sys.argv[3], sys.argv[4]
a = np.load(inp)
p = {k: a[k] for k in ("router", "w1", "w3", "w2")}
cfg = reduced("olmoe_1b_7b")
cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, token_chunk=tc, capacity_factor=cf))
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
set_mesh(mesh, batch_axes(mesh))
with mesh:
    y, aux = jax.jit(lambda p, x: moe.moe_fwd(p, x, cfg))(p, a["x"])
np.savez(out, y=np.asarray(y), aux=np.asarray(aux))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ep_inputs(path):
    """f32 router and experts of reduced olmoe, and x with a constant
    offset: every token's logits share one bias per expert, so the load is
    skewed as a trained router's is and slots overflow at 1.25."""
    from repro_torch.configs.reduced import reduced
    cfg = reduced("olmoe_1b_7b")
    d, E, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
    rng = np.random.default_rng(0)
    a = {"router": rng.standard_normal((d, E)) * d ** -0.5,
         "w1": rng.standard_normal((E, d, f)) * d ** -0.5,
         "w3": rng.standard_normal((E, d, f)) * d ** -0.5,
         "w2": rng.standard_normal((E, f, d)) * f ** -0.5,
         "x": rng.standard_normal((*EP_SHAPE, d)) + 1.0}
    np.savez(path, **{k: v.astype(np.float32) for k, v in a.items()})


@functools.lru_cache(maxsize=None)
def _ep_runs(token_chunk, tmp):
    """The port's EP branch on 8 gloo processes (data 4 x model 2) and its
    single-device branch, at each of CAPACITY_FACTORS, and the reference's
    shard_map branch on 8 forced CPU devices at 1.25, on the same inputs."""
    tmp = Path(tmp)
    inp, out, ref = (str(tmp / f"{n}{token_chunk}.npz") for n in ("in", "ep", "ref"))
    _ep_inputs(inp)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", EP_WORKER, str(r), port,
                               str(token_chunk), inp, out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(8)]
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jproc = subprocess.run([sys.executable, "-c", REF_EP, str(token_chunk), "1.25", inp, ref],
                           env=jenv, capture_output=True, text=True, timeout=240)
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    assert jproc.returncode == 0, jproc.stderr[-4000:]
    return dict(np.load(out)), dict(np.load(ref))


@pytest.fixture(scope="module")
def ep_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ep"))


@pytest.mark.parametrize("token_chunk", [0, 32])
def test_moe_expert_parallel_equals_one_device(token_chunk, ep_tmp):
    """8 ranks (data 4 x model 2): each routes its 2 x 64 tokens (in chunks
    of 32 with token_chunk) and runs its 4 of 8 experts; the outputs are
    summed over `model`.  At capacity factor 16 nothing drops, so y and the
    aux loss equal the single-device branch's within f32 rounding (the
    sum of a token's experts runs in another order)."""
    r, _ = _ep_runs(token_chunk, ep_tmp)
    y, y1 = r["y16.0"], r["y1_16.0"]
    assert np.abs(y - y1).max() <= 1e-6 * max(1.0, np.abs(y1).max())
    assert abs(float(r["aux16.0"]) - float(r["aux1_16.0"])) <= 1e-6
    assert np.abs(y1).max() > 0


@pytest.mark.parametrize("token_chunk", [0, 32])
def test_moe_expert_parallel_equals_the_references(token_chunk, ep_tmp):
    """At the published capacity factor 1.25 tokens drop: each rank's
    capacity is the reference's for its 128 tokens (40 slots), or for a
    32-token chunk (16), and an expert's slots go to its tokens in the
    reference's order.  The port's y and aux loss equal the reference's
    shard_map branch on the same mesh shape within f32 rounding (1e-6 of
    y's largest magnitude; the aux loss to 1e-6), and some tokens did
    drop: y differs from the run at 16, where none does."""
    r, ref = _ep_runs(token_chunk, ep_tmp)
    y, y_all = r["y1.25"], r["y16.0"]
    scale = max(1.0, np.abs(ref["y"]).max())
    assert np.abs(y - ref["y"]).max() <= 1e-6 * scale
    assert abs(float(r["aux1.25"]) - float(ref["aux"])) <= 1e-6
    dropped = np.abs(y - y_all).max(axis=-1) > 1e-3 * scale
    assert dropped.sum() > 0
