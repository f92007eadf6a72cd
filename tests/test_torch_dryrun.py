"""The port's dry run (`launch/dryrun.py`) and its trace counts
(`launch/hlo_analysis.py`) against the reference's.

* FLOPs: for reduced llama3 at 2 x 64 the port's count of one traced step
  (`hlo_analysis.analyze`: torch's FLOP formulas over fake tensors, one
  device) equals the reference's `hlo_analysis.analyze` of its one-device
  CPU compile, exactly: prefill, decode, and a train step.  Both sides
  count every matrix product once where it runs: the train step's count is
  its forward's, plus the backward's two products per forward product
  (for each input), plus the forward again for each block under
  remat="full"; both include the full-sequence logits (training unembeds
  every position, 3 x 2 B S d V, where prefill unembeds the last row
  alone).  Nothing is dropped or added on either side, so the counts are
  held equal, not within a tolerance.
* FLOPs grow linearly in n_layers (the port has no `while` loop, so this
  takes the place of the reference's trip-count cases).
* FLOPs on a mesh are one rank's: a sharded product counts its local
  shapes, and DTensor's shape inference on global shapes is not counted.
* Collectives: an all-reduce is counted 2x its result bytes, an all-gather
  1x.
* The two mini cells of `tests/test_runtime.py` (reduced olmoe train with
  two microbatches and its expert-parallel MoE, reduced llama3 decode, on a
  4 x 2 mesh) trace with their memory, FLOPs and collectives; the
  reference compiles the same cells once its mesh has Auto axes.
* The CLI writes a cell's JSON, and skips long_500k for a full-attention
  arch with the reference's reason.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import dist as jdist  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import make_train_state as jmake_train_state  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro.training import synthetic_batch as jsynthetic_batch  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.models import (TrainBatch, decode_step, init_cache, init_params,  # noqa: E402
                                prefill)
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.sharding import map_with_path  # noqa: E402
from repro_torch.training import AdamW, make_train_state, make_train_step  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
B, S = 2, 64


@pytest.fixture(scope="module", autouse=True)
def _no_mesh_and_no_process_group_after():
    """No reference mesh during the one-device compiles; the fake process
    group a test makes is this module's alone."""
    saved = (jdist.get_mesh(), jdist.batch_axes())
    jdist.set_mesh(None)
    yield
    jdist.set_mesh(*saved)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _ref_flops(fn, *args):
    return jhlo.analyze(jax.jit(fn).lower(*args).compile().as_text())["dot_flops"]


def _fake(tree):
    """Uninitialised CPU tensors of the meta tree's shapes (call under
    FakeTensorMode: nothing is allocated)."""
    return map_with_path(lambda _, t: torch.empty(t.shape, dtype=t.dtype), tree)


def _port_flops(kind, cfg, microbatches=1):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        p = _fake(init_params(cfg, device="meta"))
        tok = torch.empty((B, S), dtype=torch.int64)
        if kind == "prefill":
            _, counts, _ = hlo_analysis.analyze(lambda: prefill(p, tok, cfg))
        elif kind == "decode":
            cache = _fake(init_cache(cfg, B, S, device="meta"))
            _, counts, _ = hlo_analysis.analyze(
                lambda: decode_step(p, cache, tok[:, :1], S - 1, cfg))
        else:
            opt = AdamW()
            step = make_train_step(cfg, opt, microbatches=microbatches)
            _, counts, _ = hlo_analysis.analyze(
                lambda: step(make_train_state(p, opt), TrainBatch(tok, tok)))
    assert counts["conv_flops"] == 0 and counts["collective_bytes"] == 0
    return counts["dot_flops"]


def _jparams(jcfg):
    return jax.eval_shape(lambda k: jinit_params(k, jcfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_dot_flops_equal_the_references(kind):
    jcfg, cfg = jreduced("llama3_8b"), reduced("llama3_8b")
    jp = _jparams(jcfg)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "prefill":
        ref = _ref_flops(lambda p, t: jprefill(p, t, jcfg), jp, tok)
        assert ref == 184_811_520
    else:
        cache = jax.eval_shape(lambda: jinit_cache(jcfg, B, S))
        ref = _ref_flops(lambda p, c, t: jdecode_step(p, c, t, S - 1, jcfg), jp, cache,
                         jax.ShapeDtypeStruct((B, 1), jnp.int32))
    assert _port_flops(kind, cfg) == ref


@pytest.mark.parametrize("remat,microbatches", [("none", 1), ("none", 2), ("full", 1)])
def test_train_step_dot_flops_equal_the_references(remat, microbatches):
    jcfg = jreduced("llama3_8b").with_(remat=remat)
    cfg = reduced("llama3_8b").with_(remat=remat)
    opt = JAdamW()
    state = jax.eval_shape(lambda k: jmake_train_state(jinit_params(k, jcfg), opt),
                           jax.random.PRNGKey(0))
    batch = jax.eval_shape(lambda: jsynthetic_batch(jcfg, B, S))
    ref = _ref_flops(jmake_train_step(jcfg, opt, microbatches=microbatches), state, batch)
    assert ref == {"none": 603_979_776, "full": 754_974_720}[remat]
    assert _port_flops("train", cfg, microbatches) == ref


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_flops_grow_linearly_in_layers(kind):
    """f(L) = a + b L: each layer is counted where it runs."""
    f = [_port_flops(kind, reduced("llama3_8b").with_(n_layers=n)) for n in (1, 2, 3, 5)]
    assert f[1] - f[0] == f[2] - f[1] == (f[3] - f[2]) / 2 > 0


def test_all_reduce_is_counted_twice():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    fake_world(8)
    mesh = make_mesh((4, 2), ("data", "model"))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(16, 32), mesh, (Shard(0), Partial()),
                               run_check=False, shape=(64, 32), stride=(32, 1))
        _, counts, summary = hlo_analysis.analyze(
            lambda: x.redistribute(mesh, (Shard(0), Replicate())))
        _, _, gathered = hlo_analysis.analyze(
            lambda: x.redistribute(mesh, (Shard(0), Replicate())).redistribute(
                mesh, (Replicate(), Replicate())))
    assert summary == {"all-reduce": {"count": 1, "bytes": 2 * 16 * 32 * 4},
                       "total_bytes": 2 * 16 * 32 * 4}
    assert counts["collective_ops"] == {"all-reduce": 1}
    assert gathered["all-gather"] == {"count": 1, "bytes": 64 * 32 * 4}


def test_flops_on_a_mesh_are_one_ranks():
    """Reduced llama3 prefill of 8 x 64 tokens on data 4 x model 2: every
    product is sharded over `model` (heads, FFN hidden, vocab) and the batch
    over `data`, so one rank does half the one-device FLOPs of its 2 x 64
    tokens, exactly.  DTensor infers output shapes by running ops on the
    global shapes; those calls are no rank's work and are not counted (they
    were: 194,117,632 in a fresh process)."""
    fake_world(8)
    res = dryrun.trace_cell(reduced("llama3_8b"), ShapeSpec("p", S, 4 * B, "prefill"),
                            make_mesh((4, 2), ("data", "model")))
    assert res["cost"]["flops"] == _port_flops("prefill", reduced("llama3_8b")) / 2


MINI_CELLS = {
    "moe_train": ("olmoe_1b_7b", {"train_microbatches": 2}, ("t", 64, 16, "train")),
    "dense_decode": ("llama3_8b", {}, ("d", 64, 8, "decode")),
}
REF_MINI = r"""
import sys
from jax.sharding import AxisType
import jax
from repro.configs.reduced import reduced
from repro.launch.dryrun import build_lowerable
from repro.models import set_mesh
from repro.models.config import ShapeSpec
from repro.sharding import batch_axes
arch, over, shape = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
cfg = reduced(arch).with_(**over)
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
set_mesh(mesh, batch_axes(mesh))
fn, args, in_sh, out_sh, donate = build_lowerable(cfg, ShapeSpec(*shape), mesh)
with mesh:
    jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
            donate_argnums=donate).lower(*args).compile()
print("compiled_ok")
"""


@pytest.mark.parametrize("cell", sorted(MINI_CELLS))
def test_mini_cells_trace_on_a_4x2_mesh(cell):
    arch, over, shape = MINI_CELLS[cell]
    fake_world(8)
    res = dryrun.trace_cell(reduced(arch).with_(**over), ShapeSpec(*shape),
                            make_mesh((4, 2), ("data", "model")))
    mem = res["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem.get("peak_bytes", mem["argument_bytes"]) >= mem["argument_bytes"]
    assert res["cost"]["flops"] > 0 and res["collectives"]["total_bytes"] > 0
    if cell == "moe_train":   # the experts' outputs summed over `model`
        assert res["collectives"]["all-reduce"]["count"] > 0
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", REF_MINI, arch, repr(over), repr(shape)],
                         env=env, capture_output=True, text=True, timeout=540)
    assert out.returncode == 0 and "compiled_ok" in out.stdout, out.stderr[-3000:]


def test_cli_writes_cells_and_skips_long_500k(tmp_path):
    argv = ["--arch", "llama3-8b", "--single-pod", "--out", str(tmp_path),
            "--set", "n_layers=1"]
    assert dryrun.main(argv + ["--shape", "decode_32k"]) == 0
    res = json.loads((tmp_path / "llama3_8b.decode_32k.1pod.json").read_text())
    assert res["status"] == "ok" and res["mesh"] == {"data": 16, "model": 16}
    assert res["cost"]["flops"] > 0 and res["memory"]["argument_bytes"] > 0
    assert dryrun.main(argv + ["--shape", "long_500k"]) == 0
    res = json.loads((tmp_path / "llama3_8b.long_500k.1pod.json").read_text())
    assert res["status"] == "skipped" and "full-attention" in res["reason"]
