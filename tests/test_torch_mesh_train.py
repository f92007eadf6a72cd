"""`launch/train.py --mesh` on real ranks: gloo processes on the CPU.

* The launcher on a mesh of rank processes (`runtime/ranks.py`: the world
  and the mesh are built as under torchrun) trains the reduced configs in
  f32 to the one-process run's losses within 1e-5 over 3 steps: llama3-8b
  on 2 x 2 (heads over `model`), zamba2-1.2b on 2 x 1 and 1 x 2 (the SSD
  scan's batch, then its heads, over the ranks) and olmoe-1b-7b on 2 x 2
  (the expert-parallel branch).  Every rank ends with the same losses; the
  grad norms agree within 1e-4.
* Under the mesh `kernels.flash_attention.flash_attention`,
  `kernels.ssd_scan.ssd_scan` and `kernels.causal_conv.causal_conv_silu`
  receive plain tensors, never DTensors (a spy in each rank): the card's
  kernels take raw pointers.
* Checkpoints cross between the paths: the 4-rank run's checkpoint resumes
  in the one-process launcher, the one-process run's on 4 ranks, each
  continuing the uninterrupted run's losses within 1e-5; restored on the
  ranks with the placements and gathered, every array equals the file's.

No JAX here: the port is held to itself, one process against many (its
one-process path is held to the reference elsewhere).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime.ranks import RankGroup  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
#: the grad norm: the hybrid's f32 SSD gradients are small differences of
#: long sums (dA, ddt), which the batch split sums in another order; the
#: repo holds whole-model f32 sums of the hybrid at 1e-4
GNORM_TOL = dict(atol=0, rtol=1e-4)
ARGV = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "64"]
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def ranks():
    """ranks(n): a group of n gloo rank processes, started once for the
    module (a start costs seconds, and DTensor's first step more)."""
    groups = {}

    def get(n):
        if n not in groups:
            groups[n] = RankGroup([f"cpu:{i}" for i in range(n)], timeout=TIMEOUT)
        return groups[n]
    yield get
    for g in groups.values():
        g.close()


def spied_train(argv):
    """`train.main(argv)` in a rank, with the kernels' entry points wrapped
    to record the type of each tensor they receive; returns its stats with
    {"kernel_inputs": {kernel: sorted type names}}."""
    from repro_torch.kernels import causal_conv as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    seen = {"flash_attention": set(), "ssd_scan": set(), "causal_conv": set()}
    real = {"flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd_scan,
            "causal_conv": cc.causal_conv_silu}

    def spy(name):
        def wrapped(*args, **kw):
            seen[name].update(type(a).__name__ for a in args if isinstance(a, torch.Tensor))
            return real[name](*args, **kw)
        return wrapped
    fa.flash_attention, ssd.ssd_scan = spy("flash_attention"), spy("ssd_scan")
    cc.causal_conv_silu = spy("causal_conv")
    try:
        out = train.main(argv)
    finally:
        fa.flash_attention, ssd.ssd_scan = real["flash_attention"], real["ssd_scan"]
        cc.causal_conv_silu = real["causal_conv"]
    out["kernel_inputs"] = {k: sorted(v) for k, v in seen.items()}
    return out


def restored_on_mesh(path, argv):
    """The launcher's state for argv restored from path on the rank's mesh
    with the placements, gathered: (step, the file's arrays by key)."""
    import argparse

    from repro_torch.configs import ALIASES, get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.models import init_params
    from repro_torch.sharding import tree_shardings
    from repro_torch.training import AdamW, checkpoint, make_train_state
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--mesh")
    args, _ = ap.parse_known_args(argv)
    cfg = reduce_config(get_config(ALIASES.get(args.arch, args.arch)))
    mesh = train.parse_mesh(args.mesh)
    template = make_train_state(init_params(cfg, device="meta"), AdamW())
    state = checkpoint.restore(path, template, placements=tree_shardings(template, cfg, mesh),
                               mesh=mesh)
    return checkpoint.latest_step(path), checkpoint._flatten(state)


@pytest.mark.parametrize("arch,mesh", [("llama3-8b", "2x2"), ("zamba2-1.2b", "2x1"),
                                       ("zamba2-1.2b", "1x2"), ("olmoe-1b-7b", "2x2")])
def test_mesh_train_matches_one_process(arch, mesh, ranks):
    argv = ["--arch", arch, *ARGV, "--steps", "3"]
    one = train.main(argv)
    n = int(np.prod([int(x) for x in mesh.split("x")]))
    outs = ranks(n).results(spied_train, argv + ["--mesh", mesh])
    assert outs[0]["mesh"] == dict(zip(("data", "model"), map(int, mesh.split("x"))))
    for out in outs:
        np.testing.assert_allclose(out["losses"], one["losses"], **TOL)
        np.testing.assert_allclose(out["grad_norms"], one["grad_norms"], **GNORM_TOL)
    reached = {k: v for k, v in outs[0]["kernel_inputs"].items() if v}
    assert reached["flash_attention"] == ["Tensor"]
    if arch.startswith("zamba2"):
        assert reached["ssd_scan"] == reached["causal_conv"] == ["Tensor"]
    assert all(v == ["Tensor"] for out in outs for v in out["kernel_inputs"].values() if v)


def test_checkpoints_cross_between_ranks_and_one_process(tmp_path, ranks):
    """Each run takes 3 steps and checkpoints at step 2; a resume takes the
    third step again, from the other path's checkpoint."""
    argv = ["--arch", "llama3-8b", *ARGV, "--steps", "3", "--ckpt-every", "2"]
    from_ranks, from_one = str(tmp_path / "ranks"), str(tmp_path / "one")
    mesh = ["--mesh", "2x2"]
    whole = train.main(argv + ["--ckpt-dir", from_one])["losses"]
    group = ranks(4)
    group.call(train.main, argv + mesh + ["--ckpt-dir", from_ranks])
    step, flat = group.call(restored_on_mesh, from_one, argv + mesh)
    on_ranks = group.call(train.main, argv + mesh + ["--ckpt-dir", from_one])
    resumed = train.main(argv + ["--ckpt-dir", from_ranks])
    assert resumed["steps"] == on_ranks["steps"] == 1
    np.testing.assert_allclose(resumed["losses"], whole[2:], **TOL)
    np.testing.assert_allclose(on_ranks["losses"], whole[2:], **TOL)
    assert step == 2
    with np.load(tmp_path / "one" / "step_00000002.npz") as data:
        assert sorted(flat) == sorted(data.files)
        for key, arr in flat.items():
            assert np.array_equal(arr, data[key]), key


def test_resize_cost_script_runs_its_plan():
    """`launch/resize_cost.py` on 2 gloo ranks, shrunk to one device (the
    state gathered to this process) and resumed on 2: every operation
    timed, the params bit-equal across the resize."""
    from repro_torch.launch import resize_cost
    out = resize_cost.main(["--device", "cpu", "--reduced", "--plan", "2,1"])
    assert [op["op"] for op in out["ops"]] == ["start 2", "resize 1", "preempt", "resume 2"]
    assert out["ops"][1]["params_bit_equal"] and set(out["ops"][1]["parts"]) == \
        {"gather_s", "place_s"}
    assert all(op["s"] > 0 for op in out["ops"]) and len(out["step_seconds"]) == 3
