"""OLMoE as published, on the CPU: the port's three options (`qk_norm`,
`MoEConfig.dropless`, `MoEConfig.norm_topk`) against the benchmark's plain
reference `perfbench/reference/olmoe_lm.py`, which imports nothing of the
port.

Every test runs the reduced sibling (`reduce_config(olmoe_1b_7b)`: 4 layers,
d_model 128, 4 heads of 32, 8 experts top-2 of width 64, vocab 512, f32)
with the three options on, on weights the benchmark draws from a seed.

Tolerances: logits 1e-4 and the loss 1e-5, relative (f32 on both sides; the
attention and the expert sums run in other orders, and the port's
whole-model sums hold at 1e-4 elsewhere, `tests/test_torch_moe.py`); each
leaf's gradient 1e-4 relative to the leaf's norm (the same sums through the
backward); one MoE layer and the expert products 1e-5 (a handful of
products); prefill and decode against the forward 1e-4 (the cache's k is
normed and rotated once, the forward's the same way).
"""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import weights  # noqa: E402
from perfbench.reference import moe_lm, olmoe_lm  # noqa: E402
from perfbench.reference.common import leaves  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels import expert_mm as emm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (TrainBatch, decode_step, forward, init_cache,  # noqa: E402
                                init_params, loss_fn, moe, prefill)

B, S = 2, 32
SEED = 2 ** 31 + 77


def published(cfg=None):
    """The reduced sibling with the three published options on."""
    cfg = cfg or reduced("olmoe_1b_7b")
    return cfg.with_(qk_norm=True, moe=dataclasses.replace(cfg.moe, dropless=True,
                                                           norm_topk=False))


def spec(cfg) -> dict:
    """The reference's dict of the sizes cfg runs."""
    return dataclasses.asdict(cfg)


@pytest.fixture(autouse=True)
def pinned_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig():
    cfg = published()
    m = spec(cfg)
    params = weights.make(olmoe_lm.param_specs(m), SEED, "cpu")
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    labels = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    return cfg, m, params, tokens, labels


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _program_grads(params, batch, cfg):
    flat = dict(leaves(params))
    live = {k: t.detach().clone().requires_grad_(True) for k, t in flat.items()}
    tree = weights.unflatten(live)
    loss, _ = loss_fn(tree, batch, cfg)
    gs = torch.autograd.grad(loss, list(live.values()))
    return float(loss.detach()), dict(zip(live, gs))


@pytest.mark.parametrize("what", ["logits", "loss", "grads"])
def test_published_variant_matches_the_reference(rig, what):
    cfg, m, params, tokens, labels = rig
    with torch.no_grad():
        ref_logits, ref_aux = olmoe_lm.forward(params, tokens, m)
    if what == "logits":
        with torch.no_grad():
            got = forward(params, tokens, cfg)
        assert _rel(got, ref_logits) < 1e-4
    elif what == "loss":
        with torch.no_grad():
            got, parts = loss_fn(params, TrainBatch(tokens, labels), cfg)
        want = olmoe_lm.objective(ref_logits, ref_aux, labels)
        assert abs(float(got) - float(want)) < 1e-5 * abs(float(want))
        assert abs(float(parts["aux"]) - float(ref_aux)) < 1e-5 * float(ref_aux)
    else:
        loss, got = _program_grads(params, TrainBatch(tokens, labels), cfg)
        bufs = {k: torch.zeros(t.shape) for k, t in leaves(params)}
        # one row a block: the reference's whole-batch assignment counts
        # carry the aux loss's sum across the blocks
        ref_loss = olmoe_lm.grads(params, bufs, tokens, labels, m, rows=1)
        assert abs(loss - ref_loss) < 1e-5 * abs(ref_loss)
        assert {"layers.attn.q_norm", "layers.attn.k_norm"} <= set(got)
        for k, g in got.items():
            assert _rel(g, bufs[k]) < 1e-4, k


def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"]["moe"].items()}


def _hidden(cfg, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, cfg.d_model, generator=gen)


def _ref_layer(x, lp, cfg):
    y, _, counts = olmoe_lm.experts(x.reshape(-1, cfg.d_model), lp, spec(cfg)["moe"],
                                    olmoe_lm.EXACT)
    return y.reshape(x.shape), counts


def test_dropless_drops_nothing_where_the_capacity_path_drops(rig):
    """A router biased so that expert 0 takes nearly every token: the
    dropless layer still computes every assignment (the reference's sum over
    all of them), where capacity 1.25 leaves most of expert 0's out."""
    cfg, _, params, _, _ = rig
    lp = dict(_layer(params))
    lp["router"] = lp["router"].clone()
    lp["router"][:, 0] += 10.0
    x = _hidden(cfg)
    want, counts = _ref_layer(x, lp, cfg)
    assert counts[0] > 1.25 * counts.sum() / cfg.moe.n_experts
    y, _ = moe.moe_fwd(lp, x, cfg)
    assert _rel(y, want) < 1e-5
    capped = cfg.with_(moe=dataclasses.replace(cfg.moe, dropless=False, capacity_factor=1.25))
    assert _rel(moe.moe_fwd(lp, x, capped)[0], want) > 0.1


@pytest.mark.parametrize("norm_topk", [True, False])
def test_dropless_equals_the_capacity_path_when_nothing_can_drop(rig, norm_topk):
    cfg, _, params, _, _ = rig
    base = cfg.with_(moe=dataclasses.replace(
        cfg.moe, norm_topk=norm_topk, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    x = _hidden(cfg).requires_grad_(True)
    outs = []
    for dropless in (False, True):
        c = base.with_(moe=dataclasses.replace(base.moe, dropless=dropless))
        lp = {k: t.clone().requires_grad_(True) for k, t in _layer(params).items()}
        y, aux = moe.moe_fwd(lp, x, c)
        gen = torch.Generator().manual_seed(11)
        dy = torch.randn(y.shape, generator=gen)
        gs = torch.autograd.grad((y * dy).sum() + aux, [x, *lp.values()])
        outs.append((y, aux, gs))
    (y0, a0, g0), (y1, a1, g1) = outs
    assert _rel(y1, y0) < 1e-5 and abs(float((a1 - a0).detach())) < 1e-6
    for a, b in zip(g1, g0):
        assert _rel(a, b) < 1e-5


def test_prefill_and_greedy_decode_with_qk_norm_match_the_forward(rig):
    cfg, _, params, tokens, _ = rig
    n_new = 6
    with torch.no_grad():
        logits, cache = prefill(params, tokens, cfg)
        full = init_cache(cfg, B, S + n_new, device="cpu")
        for name, (k, v) in cache.items():
            full[name][0][:, :, :S] = k
            full[name][1][:, :, :S] = v
        seq, steps = tokens, [logits]
        for j in range(n_new):
            nxt = steps[-1].argmax(dim=-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            step_logits, full = decode_step(params, full, nxt[:, None], S + j, cfg)
            steps.append(step_logits)
        want = forward(params, seq, cfg)[:, S - 1:, :cfg.vocab]
    got = torch.stack(steps, dim=1)
    assert _rel(got, want[:, :n_new + 1]) < 1e-4


def _per_expert(x, w, counts):
    """Each row times its own expert's weight, by a gathered batched product."""
    e = torch.repeat_interleave(torch.arange(len(counts)), torch.tensor(counts))
    return torch.bmm(x[:, None, :], w[e])[:, 0]


@pytest.mark.parametrize("counts", [[0, 5, 0, 9, 1, 0], [7, 0, 0, 0], [3, 3, 3]])
def test_expert_mm_cpu_path_matches_per_expert_matmuls(counts):
    gen = torch.Generator().manual_seed(len(counts))
    R, K, N = sum(counts), 16, 24
    x = torch.randn(R, K, generator=gen, requires_grad=True)
    w = torch.randn(len(counts), K, N, generator=gen, requires_grad=True)
    offsets = torch.tensor(counts).cumsum(0).to(torch.int32)
    y = ops.expert_mm(x, w, offsets)
    want = _per_expert(x, w, counts)
    assert y.shape == (R, N) and _rel(y, want) < 1e-6
    dy = torch.randn(R, N, generator=gen)
    got = torch.autograd.grad((y * dy).sum(), [x, w])
    ref = torch.autograd.grad((want * dy).sum(), [x, w])
    for a, b in zip(got, ref):
        assert _rel(a, b) < 1e-6
    empty = [i for i, c in enumerate(counts) if c == 0]
    assert float(got[1][empty].abs().sum()) == 0.0


def test_expert_mm_refuses_what_the_grouped_gemm_cannot_take():
    x = torch.zeros(4, 16, dtype=torch.bfloat16)
    w = torch.zeros(2, 16, 24, dtype=torch.bfloat16)
    offsets = torch.tensor([1, 4], dtype=torch.int32)
    assert emm.supports(x, w, offsets)
    assert not emm.supports(x.float(), w.float(), offsets)
    assert not emm.supports(x, w[:, :, :20], offsets)
    assert not emm.supports(x, w, offsets.long())
    with pytest.raises(ValueError, match="no kernel"):
        emm.refuse(x, w, offsets)


@pytest.mark.parametrize("option", ["none", "qk_norm", "dropless", "norm_topk"])
def test_options_off_keep_the_tree_the_reference_has(option):
    """Off, the options leave the tree the JAX-parity reference draws
    (`moe_lm`); QK-norm alone adds its two scales."""
    base = reduced("olmoe_1b_7b")
    cfg = {"none": base, "qk_norm": base.with_(qk_norm=True),
           "dropless": base.with_(moe=dataclasses.replace(base.moe, dropless=True)),
           "norm_topk": base.with_(moe=dataclasses.replace(base.moe, norm_topk=False))}[option]
    got = weights.layout(init_params(cfg, device="meta"))
    want = {p: (shape, weights.DTYPES[d]) for p, shape, d, _ in moe_lm.param_specs(spec(cfg))}
    if option == "qk_norm":
        L, HD = cfg.n_layers, cfg.n_heads * cfg.d_head
        want.update({"layers.attn.q_norm": ((L, HD), torch.float32),
                     "layers.attn.k_norm": ((L, cfg.n_kv * cfg.d_head), torch.float32)})
    assert got == want


def _no_host_reads(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a value read on the host")
    for name in ("item", "tolist", "nonzero", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)


def _masked_expert_mm(x, w, offsets):
    """The grouped product from the offsets on the device, reading nothing on
    the host (each row's expert is the number of group ends at or below it)."""
    e = (torch.arange(x.shape[0])[:, None] >= offsets[None, :]).sum(dim=1)
    return torch.bmm(x[:, None, :], w[e])[:, 0]


def test_the_dropless_dispatch_reads_nothing_on_the_host(rig, monkeypatch):
    """Routing, sort, offsets, gathers and combine run with every host read of
    a tensor refused (the grouped products swapped for a version that takes
    the offsets on the device, since the CPU path slices by them), and a
    traced layer's spans count no host sync."""
    cfg, _, params, _, _ = rig
    x = _hidden(cfg).requires_grad_(True)
    lp = _layer(params)
    want, _ = moe.moe_fwd(lp, x, cfg)
    monkeypatch.setattr(emm, "expert_mm_plain", _masked_expert_mm)
    from torch.profiler import ProfilerActivity, profile
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with monkeypatch.context() as mp:
            _no_host_reads(mp)
            y, aux = moe.moe_fwd(lp, x, cfg)
            (y.sum() + aux).backward()
    got = [s for s in tracing.spans() if s["name"].startswith("models.moe.")]
    tracing.reset()
    assert sorted({s["name"] for s in got}) == [f"models.moe.{n}" for n in
                                                ("combine", "dispatch", "experts", "route")]
    assert sum(s["counts"].get("host_syncs", 0) for s in got) == 0
    assert _rel(y, want) < 1e-6 and x.grad is not None


def test_the_expert_parallel_branch_refuses_dropless(rig):
    """Dropless runs on one device; the mesh branch keeps the reference's
    capacity dispatch and says so before touching the mesh."""
    cfg, _, params, _, _ = rig
    with pytest.raises(NotImplementedError, match="dropless"):
        moe._moe_ep(_layer(params), _hidden(cfg), cfg, mesh=None)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_expert_mm_calls_match_chip_smokes_count(monkeypatch, remat):
    """chip_smoke asserts the grouped GEMMs' launches per dropless train step
    (three a MoE block's forward, recomputed forwards included, and three
    backward calls); on the CPU the same path calls the per-expert loop where
    the card launches the grouped GEMM.  The capacity path calls neither."""
    from repro_torch.training import AdamW, make_train_state, make_train_step, synthetic_batch
    calls = []
    orig = emm.expert_mm_plain
    monkeypatch.setattr(emm, "expert_mm_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    opt = AdamW()
    want = {}
    for cfg in (published().with_(remat=remat), reduced("olmoe_1b_7b").with_(remat=remat)):
        calls.clear()
        make_train_step(cfg, opt, microbatches=2)(
            make_train_state(init_params(cfg, seed=0, device="cpu"), opt),
            synthetic_batch(cfg, 2, 32, device="cpu"))
        want[cfg.moe.dropless] = _chip_smoke().train_launches(cfg, microbatches=2)
        assert len(calls) == want[cfg.moe.dropless]["expert_mm"]
    n = 2 * 3 * published().n_layers
    assert want[True]["expert_mm"] == n * (2 if remat == "full" else 1)
    assert want[True]["expert_mm_bwd"] == n and want[False]["expert_mm_bwd"] == 0

