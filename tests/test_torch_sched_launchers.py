"""The port's scheduler launchers against the examples they stand for.

`repro_torch.launch.{fault_sweep,swf_replay,mechanism_sweep}` are the
counterparts of `examples/{fault_sweep,swf_replay,mechanism_sweep}.py`
over the port's `Experiment`, `Simulator` and workload registry.  Each
example runs with `runpy` and a patched `argv`, then its counterpart the
same way, at small sizes, serial; their stdout must be equal once the
wall-clock fields are taken out of the example's (the stream progress
line's seconds, which the counterpart does not print).  The peak RSS that
`--max-rss` prints is a property of this test process, not of either
program, so its number is masked on both sides.  Paths given on the
command line are the same for both.

The fault sweep's counterpart also writes `results/faults/mtbf_sweep.json`
byte for byte at the defaults (to a temporary file, never over the
checked-in one).
"""
import json
import re
import runpy
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SAMPLE = str(ROOT / "tests" / "data" / "sample.swf")
WALL = re.compile(r" in \d+\.\ds \(\d+\.\ds total\)")   # the example's stream progress
RSS = re.compile(r"peak RSS: \d+ MB")


def _stdout(capsys, monkeypatch, argv, example=None, module=None):
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    if example:
        runpy.run_path(str(ROOT / "examples" / example), run_name="__main__")
    else:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    return RSS.sub("peak RSS: <n> MB", capsys.readouterr().out)


def _pair(capsys, monkeypatch, name, args):
    ex = _stdout(capsys, monkeypatch, [f"{name}.py", *args], example=f"{name}.py")
    ex = WALL.sub("", ex)
    port = _stdout(capsys, monkeypatch, [f"{name}.py", *args],
                   module=f"repro_torch.launch.{name}")
    assert port == ex
    assert port.count("\n") >= 3
    return port


@pytest.mark.parametrize("args", (
    ("--jobs", "60"),
    ("--jobs", "60", "--mtbf", "24,168", "--mechanism", "CUP&STEAL", "--seed", "5"),
), ids=("defaults", "mtbf"))
def test_fault_sweep_prints_the_examples(capsys, monkeypatch, tmp_path, args):
    out = str(tmp_path / "rows.json")
    ex = _stdout(capsys, monkeypatch, ["fault_sweep.py", *args, "--out", out],
                 example="fault_sweep.py")
    ex_json = Path(out).read_bytes()
    port = _stdout(capsys, monkeypatch, ["fault_sweep.py", *args, "--out", out],
                   module="repro_torch.launch.fault_sweep")
    assert port == ex and f"# wrote {out}" in port
    assert Path(out).read_bytes() == ex_json


def test_fault_sweep_reproduces_the_checked_in_sweep(tmp_path):
    from repro_torch.launch import fault_sweep
    out = tmp_path / "mtbf_sweep.json"
    result = fault_sweep.main(["--out", str(out)])
    checked_in = ROOT / "results" / "faults" / "mtbf_sweep.json"
    assert out.read_bytes() == checked_in.read_bytes()
    want = json.loads(checked_in.read_text())
    assert result == want
    assert [r["records_sha256"] for r in result["rows"]] == \
        [r["records_sha256"] for r in want["rows"]]


@pytest.mark.parametrize("args", (
    ("--serial",),
    ("--serial", "--load-scale", "1.3", "--mix", "W2", "--seeds", "2"),
    ("--serial", "--stream", "--max-rss"),
), ids=("plain", "transforms", "stream"))
def test_swf_replay_prints_the_examples(capsys, monkeypatch, args):
    out = _pair(capsys, monkeypatch, "swf_replay", ("--trace", SAMPLE, *args))
    assert f"trace: {SAMPLE}" in out
    if "--stream" in args:
        assert "[3/3] CUA&STEAL seed=0: 80/80 jobs\n" in out
        assert "peak RSS: <n> MB (self)" in out


@pytest.mark.parametrize("args", (
    ("--jobs", "60", "--serial"),
    ("--jobs", "40", "--serial", "--scenarios", "W1,bursty-od,trace-replay",
     "--mechanisms", "BASE,CUA&SPAA", "--trace", SAMPLE),
), ids=("mechanisms", "scenarios"))
def test_mechanism_sweep_prints_the_examples(capsys, monkeypatch, args):
    out = _pair(capsys, monkeypatch, "mechanism_sweep", args)
    assert out.startswith(f"trace: {args[1]} jobs")


def test_default_trace_is_the_repositorys_sample():
    from repro_torch.launch import mechanism_sweep, swf_replay
    assert swf_replay.SAMPLE == mechanism_sweep.SAMPLE == SAMPLE
