"""The `olmoe-train` cell on the CPU: its configuration file runs the
program at a reduced size, its reference counts FLOPs as by hand, the
grouped expert GEMMs' work counts, its three span readers on a made-up span
list, and whole tiny runs through the harness: a sound run is correct, half
of each batch left out is not."""
import json
import time

import pytest
import torch

from perfbench import harness, readers, weights
from perfbench.kernels import expert_mm
from perfbench.reference import olmoe_lm

harness.prepare_environment()
CELL = "olmoe-train"
SMALL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv": 4, "d_head": 16, "vocab": 256}


@pytest.fixture(autouse=True)
def _jax_may_be_loaded_already(monkeypatch):
    """A test worker runs other test files first, some of which import JAX
    into the same process; the runs here check everything but that."""
    monkeypatch.setattr(harness, "FORBIDDEN", ())


def small_model(**moe) -> dict:
    m = harness.cell(CELL).model
    return dict(m, **SMALL, moe={**m["moe"], "n_experts": 8, "top_k": 2, "d_expert": 32,
                                 **moe})


def test_the_configuration_runs_the_program_at_a_reduced_size():
    c = harness.cell(CELL)
    model = small_model()
    run = harness.Run(c, 0, 1, False, torch.device("cpu"), 0.0, model=model)
    cfg = harness.program_config(run)
    assert cfg.qk_norm and cfg.moe.dropless and not cfg.moe.norm_topk
    assert (cfg.n_layers, cfg.d_model, cfg.moe.n_experts) == (2, 64, 8)
    params = weights.make(olmoe_lm.param_specs(model), 2 ** 31 + 1, "cpu")
    harness.check_layout(params, cfg)
    assert params["layers"]["attn"]["q_norm"].shape == (2, 64)
    # at full size the file names every key it runs other than the program's
    full = harness.Run(c, 0, 1, False, torch.device("cpu"), 0.0, model=c.model)
    assert harness.program_config(full).n_layers == 8


def test_model_flops_per_token_match_a_hand_count():
    m = harness.cell(CELL).model
    # attention 2048 x 48 x 128 + 16 x 128 x 2048, router 2048 x 64, 8 of the
    # 64 experts 3 x 2048 x 1024, a layer; 8 layers and the 2048 x 50304 head
    weights_ = 8 * (12_582_912 + 4_194_304 + 131_072 + 8 * 6_291_456) + 103_022_592
    assert weights_ == 640_942_080
    attn = 8 * 4 * 16 * 128 * (2048 + 1) / 2
    assert olmoe_lm.model_flops_per_token(m, 2048) == 6 * weights_ + 3 * attn
    assert 4.04e9 < olmoe_lm.model_flops_per_token(m, 2048) < 4.06e9


def test_expert_mm_counts_match_hand_counts():
    # R 6, K 4, N 2, E 3, bf16
    assert expert_mm.cost(6, 4, 2, 3, 2) == (2 * 48, 2 * (24 + 24 + 12))
    assert expert_mm.cost(6, 4, 2, 3, 2, backward=True) == (4 * 48, 2 * (12 + 48 + 48))
    m = harness.cell(CELL).model
    unit = {"B": 8, "S": 2048, "launches": {"expert_mm": 48, "expert_mm_bwd": 24}}
    R = 8 * 2048 * 8
    assert expert_mm.calls(m, unit, 48) == [
        (48, *expert_mm.cost(R, 2048, 1024, 64, 2)),
        (24, *expert_mm.cost(R, 2048, 1024, 64, 2, backward=True))]
    # the w2 call's K and N swap places and cost the same
    assert expert_mm.cost(R, 1024, 2048, 64, 2) == expert_mm.cost(R, 2048, 1024, 64, 2)
    assert expert_mm.calls(m, dict(unit, launches={}), 0) == []
    assert expert_mm.calls(harness.cell("zamba2-train").model, unit, 48) == []


def test_expert_mm_roofline_on_a_record():
    m = harness.cell(CELL).model
    names = sorted(readers.kernel_names("expert_mm"))
    unit = {"B": 8, "S": 2048, "launches": {"expert_mm": 48, "expert_mm_bwd": 24}}
    rec = {"device_kind": "NVIDIA H100 80GB HBM3", "model": m, "reference": "olmoe_lm",
           "trace": {"kernel_s": {n: 0.1 / len(names) for n in names}, "busy_s": 1.0,
                     "window_s": 1.0, "units": [unit]}}
    bound = sum(n * max(f / 989e12, b / 3.35e12) for n, f, b in expert_mm.calls(m, unit, 48))
    got = harness.metric_reader("expert_mm_roofline.train").read(rec)
    assert got == pytest.approx(100 * bound / 0.1)
    rec["trace"]["kernel_s"] = {"nvjet_tst_192x192": 0.05}
    assert harness.metric_reader("expert_mm_roofline.train").read(rec) is None


def _span(name, step, device_ms=None, in_backward=False):
    return {"name": name, "id": 0, "parent": None, "thread": 1, "jid": 0, "step": step,
            "in_backward": in_backward, "host_ms": 0.0, "device_ms": device_ms,
            "attrs": {}, "counts": {}}


EXPECTED = {"moe_route_ms.train": 3.0, "moe_permute_ms.train": 18.0,
            "moe_experts_ms.train": 24.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_readers_mean_over_the_traced_steps(name):
    xs = []
    for k, scale in ((3, 1.0), (4, 2.0)):
        xs.append(_span("runtime.step", k))
        for rec in (False, True):     # the forward, and its recomputation
            xs += [_span("models.moe.route", k, 1.0 * scale, rec),
                   _span("models.moe.dispatch", k, 2.0 * scale, rec),
                   _span("models.moe.experts", k, 8.0 * scale, rec),
                   _span("models.moe.combine", k, 4.0 * scale, rec)]
    xs.append(_span("models.moe.experts", 9, 1000.0))      # outside the traced steps
    mod = harness.metric_reader(name)
    assert mod.value(xs) == pytest.approx(EXPECTED[name])
    # a program whose MoE spans record no device time, or that has none
    assert mod.value([_span("runtime.step", 3), _span("models.moe.route", 3),
                      _span("models.moe.dispatch", 3), _span("models.moe.experts", 3),
                      _span("models.moe.combine", 3)]) is None
    assert mod.value([_span("runtime.step", 3), _span("training.forward", 3, 5.0)]) is None


def tiny_run(seed: int = 2 ** 31 + 5) -> harness.Run:
    """The cell's driver, reference and limits at a tiny size, in float32:
    the limits were set from bfloat16 readings at full width, and at this
    width bfloat16 rounding alone moves a leaf's change past them."""
    c = harness.cell(CELL)
    c.mix = dict(c.mix, batch=4, seq=32, ref_rows=2)
    model = dict(small_model(), param_dtype="float32", compute_dtype="float32")
    return harness.Run(c, seed, 1.0, False, torch.device("cpu"), time.perf_counter(),
                       model=model)


def test_a_sound_run_is_correct():
    run = tiny_run()
    out = harness.execute(run)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in run.cell.end_to_end}
    json.dumps(harness.summary(run.rec))


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from repro_torch.runtime import elastic
    real = elastic.synthetic_batch

    def half(cfg, batch, seq, **kw):
        b = real(cfg, batch, seq, **kw)
        return type(b)(b.tokens[:batch // 2], b.labels[:batch // 2], b.extra)

    monkeypatch.setattr(elastic, "synthetic_batch", half)
    out = harness.execute(tiny_run())
    assert not out["correct"], out["checks"]
