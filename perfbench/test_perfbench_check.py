"""Whole runs of each cell on the CPU at a tiny size, past the harness's look
for a card: the program's output passes the reference's check, and it fails
when the control (the reference in fp8) stands in for the program or when
the timed path is broken underneath: a token altered where it is produced,
a training step that returns its state unchanged, half of each batch left
out with the mean taken over the rest.  (The cells run on one card, so
there is no exchange between cards to leave out.)"""
import json
import time

import pytest
import torch

from perfbench import harness, traffic
from perfbench.drivers import serve

harness.prepare_environment()


@pytest.fixture(autouse=True)
def _jax_may_be_loaded_already(monkeypatch):
    """A test worker runs other test files first, some of which import JAX
    into the same process; the runs here check everything but that."""
    monkeypatch.setattr(harness, "FORBIDDEN", ())

TINY = {
    "olmoe-serve-long": {
        # every expert on every token: no routing choice for rounding to flip,
        # which at this size moves a token's output by a whole expert
        "model": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv": 4, "d_head": 16,
                  "d_ff": 32, "vocab": 256,
                  "moe": {"n_experts": 4, "top_k": 4, "d_expert": 32, "n_shared": 0,
                          "capacity_factor": 1.25, "first_dense": 0, "d_first_dense": 0,
                          "token_chunk": 0}},
        # prompts over 16 tokens: the padded prompt stays the largest axis of
        # the cache leaves, as the cell's 256-token floor keeps it at full size
        "mix": {"rate_per_s": 8, "max_batch": 4, "max_seq": 64,
                "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 20,
                           "max": 48},
                "output": {"dist": "uniform", "min": 4, "max": 8}},
        "seconds": 2.0},
    "zamba2-train": {
        # wide enough that fp8 products move a leaf's gradient as they do
        # at full width, where narrower ones move it less
        "model": {"n_layers": 4, "d_model": 256, "n_heads": 4, "n_kv": 4, "d_head": 128,
                  "d_ff": 512, "vocab": 256, "attn_every": 2,
                  "ssm": {"d_state": 16, "expand": 2, "d_head": 32, "chunk": 32,
                          "conv_width": 4}},
        "mix": {"batch": 4, "seq": 64, "ref_rows": 2},
        "seconds": 1.0},
}


def tiny_run(name: str, seed: int = 2 ** 31 + 3) -> harness.Run:
    c = harness.cell(name)
    t = TINY[name]
    c.mix = dict(c.mix, **t["mix"])
    return harness.Run(c, seed, t["seconds"], False, torch.device("cpu"),
                       time.perf_counter(), model=dict(c.model, **t["model"]))


@pytest.mark.parametrize("name", list(TINY))
def test_a_sound_run_is_correct(name):
    run = tiny_run(name)
    out = harness.execute(run)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in run.cell.end_to_end}
    json.dumps(harness.summary(run.rec))      # what a run prints on standard error


def test_serve_control_is_not_correct():
    """The reference computed in fp8 in the program's place: the 99th
    percentile of its own first choices' gaps is over the cell's limit."""
    run = tiny_run("olmoe-serve-long")
    _, params, engine, probe = serve.build(run)
    arrivals = traffic.serve_schedule(run.cell.mix, run.seed, run.seconds, run.model["vocab"])
    _, batches, _, _ = serve.serve_window(run, engine, probe, arrivals)
    rs = [serve.judge(run, params, b, control=True) for b in batches]
    limit = run.cell.limits["logit_gap_p99"]
    assert serve.gap_p99([{"gaps": r["control_gaps"]} for r in rs]) > limit
    assert serve.gap_p99(rs) <= limit


def test_train_control_is_not_correct():
    from perfbench.drivers import train
    from perfbench.reference.common import Matmul
    run = tiny_run("zamba2-train")
    exact = train.reference_readings(run)
    got = train.compare(train.reference_readings(run, mm=Matmul(fp8=True)), exact)
    lim = run.cell.limits
    assert any(got[k] > lim[k] for k in train.CHECKED), got


def test_an_answer_altered_where_produced_is_not_correct(monkeypatch):
    from repro_torch.serving import engine as engine_mod
    real = engine_mod.decode_step

    def altered(params, cache, tokens, pos, cfg):
        logits, cache = real(params, cache, tokens, pos, cfg)
        logits = logits.clone()
        logits[0, 7] = logits.max() + 1.0     # each batch's first answer is 7s
        return logits, cache

    monkeypatch.setattr(engine_mod, "decode_step", altered)
    out = harness.execute(tiny_run("olmoe-serve-long"))
    chk = out["checks"]["logit_gap_p99"]
    assert not out["correct"] and chk["value"] > chk["limit"]


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.runtime import elastic
    real = elastic.make_train_step

    def unchanged(cfg, opt, **kw):
        step = real(cfg, opt, **kw)

        def train_step(state, batch):
            saved = [t.clone() for t in _tensors(state)]
            _, metrics = step(state, batch)
            for t, s in zip(_tensors(state), saved):
                t.copy_(s)
            return state, metrics
        return train_step

    monkeypatch.setattr(elastic, "make_train_step", unchanged)
    out = harness.execute(tiny_run("zamba2-train"))
    assert not out["correct"] and out["checks"]["change_gap"]["value"] >= 0.99


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from repro_torch.runtime import elastic
    real = elastic.synthetic_batch

    def half(cfg, batch, seq, **kw):
        b = real(cfg, batch, seq, **kw)
        return type(b)(b.tokens[:batch // 2], b.labels[:batch // 2], b.extra)

    monkeypatch.setattr(elastic, "synthetic_batch", half)
    out = harness.execute(tiny_run("zamba2-train"))
    assert not out["correct"], out["checks"]


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _tensors(v)
