"""The benchmark's files against BENCHMARK.json and the format it keeps, on the CPU:
every name resolves to its files, the cells and metrics fit together, the
names and units are well formed, the traffic is a function of the seed,
the work counters match hand counts, and the references stand alone."""
import ast
import importlib
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, readers, traffic, weights
from perfbench.kernels import _attention, _ssd
from perfbench.trace import kernel_name, union

BENCH = harness.benchmark()
DIR = harness.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ROOFLINE_OP = re.compile(r"^(.+)_roofline(\..+)?$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PENDING = harness.pending()
ALL_CELLS = CELLS + [w["name"] for w in PENDING["workloads"]]
ALL_CONFIGS = BENCH["configs"] + PENDING["configs"]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"] + PENDING["end_to_end"] + PENDING["per_layer"]
PER_LAYER = BENCH["per_layer"] + PENDING["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["perfbench"]
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys_are_well_formed(kind):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[kind]
    entries = BENCH[kind]
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if kind == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        if kind == "configs":
            assert len(e["reduced"]) <= 16 and all(NAME.match(k) for k in e["reduced"])


def test_every_cell_has_one_config_and_every_config_a_cell():
    configs = {c["name"] for c in BENCH["configs"]}
    used = [w["config"] for w in BENCH["workloads"]]
    assert set(used) == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_pending_cells_are_well_formed_and_not_in_the_benchmark():
    assert not set(ALL_CELLS[len(CELLS):]) & set(CELLS)
    assert not {m["name"] for m in PENDING["end_to_end"] + PENDING["per_layer"]} & {
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for m in PENDING["end_to_end"]:
        assert "bound" not in m and m["workloads"]
    for w in PENDING["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)


@pytest.mark.parametrize("name", ALL_CELLS)
def test_the_harness_finds_everything_a_cell_names(name):
    c = harness.cell(name)
    assert (DIR / "configs").resolve() in (harness.ROOT / [
        x["file"] for x in ALL_CONFIGS if x["name"] == c.entry["config"]][0]).parents
    importlib.import_module(f"perfbench.drivers.{c.mix['driver']}")
    c.reference()
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    assert c.config["name"] == c.entry["config"]
    entry = [x for x in ALL_CONFIGS if x["name"] == c.entry["config"]][0]
    assert sorted(entry["reduced"]) == sorted(c.config["reduced"])
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_every_metric_has_a_reader_that_declares_what_the_benchmark_says(metric):
    mod = harness.metric_reader(metric["name"])
    assert callable(mod.read) and mod.UNIT == metric["unit"]
    assert mod.SOURCE == metric["source"]
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
    op = ROOFLINE_OP.match(metric["name"])
    if op:
        assert metric["unit"] == "%"
        kmod = importlib.import_module(f"perfbench.kernels.{op.group(1)}")
        assert kmod.COUNTER and callable(kmod.calls) and readers.kernel_names(op.group(1))


@pytest.mark.parametrize("metric", PER_LAYER, ids=[m["name"] for m in PER_LAYER])
def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report(metric):
    pending = metric in PENDING["per_layer"]
    e2e = BENCH["end_to_end"] + (PENDING["end_to_end"] if pending else [])
    moved = {m["name"]: m for m in e2e}[metric["moves"]]
    cells = ALL_CELLS if pending else CELLS
    for cell in metric.get("workloads", cells):
        assert cell in cells
        assert "workloads" not in moved or cell in moved["workloads"]


def test_layers_are_named_in_perf_md():
    text = (harness.ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in PER_LAYER}:
        assert f"`{layer}`" in text


def test_program_config_files_state_the_programs_sizes():
    harness.prepare_environment()
    for c in (harness.cell(n) for n in ALL_CELLS):
        run = harness.Run(c, 0, 1, False, torch.device("cpu"), 0.0, model=c.model)
        cfg = harness.program_config(run)
        specs = c.reference().param_specs(c.model)
        made = {p: (shape, weights.DTYPES[d]) for p, shape, d, _ in specs}
        from repro_torch.models import init_params
        assert weights.layout(init_params(cfg, device="meta")) == made


@pytest.mark.parametrize("name", ALL_CELLS)
def test_traffic_is_a_function_of_the_seed(name):
    c = harness.cell(name)
    vocab = c.model["vocab"]
    if c.mix["driver"] == "serve":
        a = traffic.serve_schedule(c.mix, 2 ** 31 + 11, 20.0, vocab)
        b = traffic.serve_schedule(c.mix, 2 ** 31 + 11, 20.0, vocab)
        o = traffic.serve_schedule(c.mix, 7, 20.0, vocab)
        assert [(x.due_s, x.max_new, x.prompt.tolist()) for x in a] == \
            [(x.due_s, x.max_new, x.prompt.tolist()) for x in b]
        assert [x.due_s for x in a] != [x.due_s for x in o]
        # every seed asks for the same work, in another order
        assert sorted(len(x.prompt) for x in a) == sorted(len(x.prompt) for x in o)
        assert sorted(x.max_new for x in a) == sorted(x.max_new for x in o)
        assert [len(x.prompt) for x in a] != [len(x.prompt) for x in o]
        assert sorted(np.diff([x.due_s for x in a])) != sorted(np.diff([x.due_s for x in o]))
        assert a[-1].due_s < 20.0 and all(x.due_s >= 0 for x in a)
        lens = [len(x.prompt) for x in a]
        p = c.mix["prompt"]
        assert p["min"] <= min(lens) and max(lens) <= p["max"]
        assert max(lens) + c.mix["output"]["max"] <= c.mix["max_seq"]
    else:
        t1, l1 = traffic.train_batch(2 ** 31 + 11, 2, c.mix["batch"], 16, vocab)
        t2, _ = traffic.train_batch(2 ** 31 + 11, 2, c.mix["batch"], 16, vocab)
        t3, _ = traffic.train_batch(5, 2, c.mix["batch"], 16, vocab)
        assert (t1 == t2).all() and not (t1 == t3).all()
        assert (t1[:, 1:] == l1[:, :-1]).all() and t1.max() < vocab


def test_train_batches_are_the_programs_stream():
    harness.prepare_environment()
    from repro_torch.configs import get_config
    from repro_torch.training import synthetic_batch
    cfg = get_config("zamba2_1p2b")
    b = synthetic_batch(cfg, 3, 40, seed=2 ** 33 + 5, step=4, device="cpu")
    t, lab = traffic.train_batch(2 ** 33 + 5, 4, 3, 40, cfg.vocab)
    assert (b.tokens.numpy() == t).all() and (b.labels.numpy() == lab).all()


def test_attention_counts_match_hand_counts():
    # B 1, S 4, one head of 2: causal pairs 1 + 2 + 3 + 4 = 10
    f, b = _attention.forward(1, 4, 4, 1, 1, 2, 2, 2)
    assert f == 2 * 10 * 4 and b == 2 * (4 * 2 + 4 * 4 + 4 * 2)
    f, b = _attention.forward(2, 1, 9, 4, 2, 8, 8, 2, vlen=5)
    assert f == 2 * 2 * 4 * 5 * 16 and b == 2 * (2 * 4 * 8 + 2 * 5 * 2 * 16 + 2 * 4 * 8)
    fb, bb = _attention.backward(1, 4, 1, 1, 2, 2, 2)
    assert fb == 2 * 10 * 10 and bb == b_fwd_plus(1, 4, 1, 1, 2)
    assert _attention.forward(1, 4, 4, 1, 1, 2, 2, 2, lse=True)[1] == 2 * 32 + 16


def b_fwd_plus(B, S, H, K, D):
    fwd = 2 * (B * S * H * D + B * S * K * 2 * D + B * S * H * D)
    return fwd + 2 * (B * S * H * 2 * D + B * S * K * 2 * D) + 4 * B * H * S


def test_ssd_counts_match_hand_counts():
    # b 1, s 4, one chunk of 4, h 1, p 2, n 3: pairs 10
    f, nb = _ssd.cost(1, 4, 1, 2, 3, 4, 2)
    assert f == (2 * 10 * 2 + 4 * 4 * 3 * 2) + 2 * 10 * 3
    ins = 2 * (4 * 2 + 2 * 4 * 3) + 4 * (4 + 2)
    assert nb == ins + 2 * 4 * 2
    fb, nbb = _ssd.cost(1, 4, 1, 2, 3, 4, 2, backward=True)
    assert fb == (2 * 10 * 4 + 10 * 4 * 3 * 2) + 6 * 10 * 3 and nbb == 2 * ins + 16


def test_readers_on_a_record():
    rec = {"device_kind": "NVIDIA H100 80GB HBM3", "model": {"d_model": 128, "n_heads": 2,
           "n_kv": 2, "d_head": 64}, "reference": "moe_lm",
           "trace": {"kernel_s": {"fwd_sm90": 1e-3}, "busy_s": 0.5, "window_s": 2.0,
                     "units": [{"B": 2, "S": 256, "steps": 3,
                                "launches": {"flash_attention": 4, "flash_decode": 12}}]}}
    f, b = _attention.forward(2, 256, 256, 2, 2, 64, 64, 2)
    want = 100 * 4 * max(f / 989e12, b / 3.35e12) / 1e-3
    assert readers.roofline(rec, "attn_fwd") == pytest.approx(want)
    assert readers.roofline(rec, "decode_attn") is None      # no split_kernel time
    assert readers.idle_share(rec) == pytest.approx(75.0)
    assert readers.roofline(dict(rec, device_kind="cpu"), "attn_fwd") is None
    assert readers.p90([3.0, None, 1.0, 2.0] + [0.5] * 16) == 2.0
    assert math.isinf(readers.p90([None, 1.0]))


def test_trace_union_and_kernel_names():
    assert union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]
    assert kernel_name("void repro_torch::(anonymous namespace)::tc::fwd_sm90<128, true>"
                       "(Params)") == "fwd_sm90"
    assert kernel_name("void split_kernel<8>(float const*)") == "split_kernel"
    assert kernel_name("void at::native::vectorized_elementwise_kernel<4, at::native::"
                       "FillFunctor<float> >(int)") == "vectorized_elementwise_kernel"


def test_weights_are_a_function_of_the_seed():
    specs = [("a.w", (3, 5), "bfloat16", ("normal", 0.5)),
             ("a.s", (5,), "bfloat16", ("const", 1.0)),
             ("b", (4, 6), "float32", ("log_linspace", 1.0, 16.0)),
             ("c", (7,), "float32", ("normal", 2.0))]
    x, y = weights.make(specs, 2 ** 32 + 9, "cpu"), weights.make(specs, 2 ** 32 + 9, "cpu")
    z = weights.make(specs, 3, "cpu")
    assert torch.equal(x["a"]["w"], y["a"]["w"]) and not torch.equal(x["a"]["w"], z["a"]["w"])
    assert (x["a"]["s"] == 1).all() and x["a"]["w"].dtype == torch.bfloat16
    assert torch.allclose(x["b"][2], torch.log(torch.linspace(1, 16, 6)))
    # each leaf starts ALIGN elements into its buffer: 16-byte alignment
    # wherever the buffer's own start is
    assert (x["c"].data_ptr() - x["b"].data_ptr()) % 256 == 0
    assert (x["a"]["s"].data_ptr() - x["a"]["w"].data_ptr()) % 256 == 0


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_neither_jax_nor_either_package():
    for path in (DIR / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "repro", "repro_torch"), \
                (path.name, name)
    code = ("import sys; sys.path.insert(0, %r); import perfbench.reference.moe_lm, "
            "perfbench.reference.hybrid_lm; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in DIR.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "repro"), (path, name)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_probe", object())
    assert "repro_torch_fake_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_probe", object())
    assert "repro.fake_probe" in harness.forbidden_modules()


def test_the_command_fails_without_a_card():
    out = subprocess.run([sys.executable, str(DIR / "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_bursts_raise_the_rate_inside_them_and_keep_the_set_of_sizes():
    mix = {"rate_per_s": 2.0, "bursts": {"every_s": 10.0, "for_s": 2.0, "factor": 3.0},
           "prompt": {"dist": "lognormal", "median": 64, "sigma": 0.8, "min": 16, "max": 256},
           "output": {"dist": "uniform", "min": 4, "max": 8}}
    a = traffic.serve_schedule(mix, 2 ** 31 + 5, 40.0, 100)
    # 40 s at 2/s, and 4 bursts of 2 s at 3 times: 80 + 4 * 2 * 4 expected
    assert len(a) == 112
    inside = sum(x.due_s % 10.0 < 2.0 for x in a)
    assert 40 <= inside <= 56     # 48 expected: 4 x 2 s at 6/s
    plain = traffic.serve_schedule(dict(mix, bursts={"every_s": 10.0, "for_s": 2.0,
                                                     "factor": 1.0}), 2 ** 31 + 5, 40.0, 100)
    assert len(plain) == 80
    lens = sorted(len(x.prompt) for x in a)
    assert lens[0] >= 16 and lens[-1] <= 256 and lens[len(lens) // 2] in range(56, 73)


def test_lengths_of_the_serve_mix_stay_inside_the_engine():
    for c in (harness.cell(n) for n in ALL_CELLS):
        if c.mix["driver"] == "serve":
            # the padded prompt must stay the largest axis of a cache leaf
            m = c.model
            assert c.mix["prompt"]["min"] > max(m["n_layers"], c.mix["max_batch"], m["n_kv"],
                                                m.get("d_head", 0))
            assert np.isfinite(c.mix["rate_per_s"]) and c.mix["rate_per_s"] > 0
