"""The port's copies of the workload registry, the metrics, `Experiment` and
the two scheduler CLIs against the JAX package's (`repro.core`).

Both packages are numpy code here, so every comparison is exact: the
traces by `trace_sha256` (every field of every job), the metrics by
`Metrics.as_dict()`, the CLIs by their JSON output without the keys that
read the wall clock.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core import MECHANISMS as JMECHANISMS  # noqa: E402
from repro.core import SimConfig as JSimConfig  # noqa: E402
from repro.core import Simulator as JSimulator  # noqa: E402
from repro.core import collect as jcollect  # noqa: E402
from repro.core import workloads as JW  # noqa: E402
from repro.core.workloads.swf import parse_swf as jparse_swf  # noqa: E402
from repro_torch.core import (MECHANISMS, Experiment, Scenario, SimConfig,  # noqa: E402
                              Simulator, ThetaGenerator, WorkloadConfig,
                              collect, generate, get_scenario, registered_scenarios,
                              registered_sources, registered_transforms, trace_sha256)
from repro_torch.core.workloads.swf import parse_swf  # noqa: E402
from test_torch_live_cluster import hide_reference_test_entries  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SAMPLE_SWF = str(ROOT / "tests" / "data" / "sample.swf")
GOLDEN = ROOT / "tests" / "golden_seed_metrics.json"
GOLDEN_CFG = dict(n_jobs=120, n_nodes=512, n_projects=12, horizon_days=4.0)
SWF_STACK = (("load_scale", {"factor": 1.3}), ("notice_mix", {"mix": "W2"}))
THETA_STACK = (("burst_inject", {"n_bursts": 3, "burst_size": (2, 5),
                                 "size": (32, 128), "mix": "W1"}),
               ("diurnal", {"amplitude": 0.5}))


def _rows(metrics):
    """Metrics dicts as JSON text: NaN (no job of a kind) compares equal."""
    return json.dumps(list(metrics))


def _preset(get, name):
    return get(name, trace=SAMPLE_SWF) if name == "trace-replay" \
        else get(name, n_jobs=200)


def hide_reference_test_workloads(mp):
    """The reference's workload registries (sources, transforms, scenarios)
    without their `_TEST_*` entries."""
    JW.registered_sources()  # the built-ins are registered on first use
    hide_reference_test_entries(mp, (JW.base, "_SOURCES"), (JW.base, "_TRANSFORMS"),
                                (JW.presets, "_PRESETS"))


def test_registries_are_the_references(monkeypatch):
    hide_reference_test_workloads(monkeypatch)
    assert registered_scenarios() == JW.registered_scenarios()
    assert registered_sources() == JW.registered_sources()
    assert registered_transforms() == JW.registered_transforms()


@pytest.mark.parametrize("name", JW.registered_scenarios())
@pytest.mark.parametrize("seed", (0, 1))
def test_preset_traces_equal_the_references(name, seed):
    jobs, n_nodes = _preset(get_scenario, name).realize(seed)
    jjobs, jn_nodes = _preset(JW.get_scenario, name).realize(seed)
    assert n_nodes == jn_nodes
    assert trace_sha256(jobs) == JW.trace_sha256(jjobs)


def test_sample_swf_parses_as_the_reference():
    rows, header = parse_swf(SAMPLE_SWF)
    jrows, jheader = jparse_swf(SAMPLE_SWF)
    assert header == jheader and rows == jrows and len(rows) > 0


@pytest.mark.parametrize("stack", ((), SWF_STACK), ids=("plain", "transforms"))
@pytest.mark.parametrize("mech", ("BASE", "CUA&SPAA"))
def test_swf_replay_equals_the_references(stack, mech):
    params = {"path": SAMPLE_SWF, "frac_od_projects": 0.3}
    jobs, n_nodes = Scenario("swf", params=params, transforms=stack).realize(3)
    jjobs, _ = JW.Scenario("swf", params=params, transforms=stack).realize(3)
    assert trace_sha256(jobs) == JW.trace_sha256(jjobs)
    sim = Simulator(SimConfig(n_nodes=n_nodes, mechanism=mech), jobs)
    sim.run()
    ref = JSimulator(JSimConfig(n_nodes=n_nodes, mechanism=mech), jjobs)
    ref.run()
    assert _rows([collect(sim).as_dict()]) == _rows([jcollect(ref).as_dict()])


@pytest.mark.parametrize("scn", (
    Scenario("theta", params=dict(GOLDEN_CFG), transforms=THETA_STACK),
    Scenario("swf", params={"path": SAMPLE_SWF}, transforms=SWF_STACK)),
    ids=("theta", "swf"))
@pytest.mark.parametrize("seed", (0, 1))
def test_streaming_is_sha256_identical_to_materialized(scn, seed):
    jobs, n_nodes = scn.realize(seed)
    stream, stream_nodes = scn.iter_realize(seed)
    assert stream_nodes == n_nodes
    assert trace_sha256(stream) == trace_sha256(jobs)


def test_theta_iter_jobs_identical_to_jobs():
    cfg = WorkloadConfig(seed=2, **GOLDEN_CFG)
    assert trace_sha256(ThetaGenerator(cfg).iter_jobs()) == \
        trace_sha256(ThetaGenerator(cfg).jobs())


@pytest.mark.parametrize("mech", ("BASE",) + JMECHANISMS)
def test_collect_equals_the_references_on_the_golden_workload(mech):
    jobs = generate(WorkloadConfig(seed=0, **GOLDEN_CFG))
    jjobs = JW.generate(JW.WorkloadConfig(seed=0, **GOLDEN_CFG))
    sim = Simulator(SimConfig(n_nodes=512, mechanism=mech), jobs)
    sim.run()
    ref = JSimulator(JSimConfig(n_nodes=512, mechanism=mech), jjobs)
    ref.run()
    assert _rows([collect(sim).as_dict()]) == _rows([jcollect(ref).as_dict()])


@pytest.mark.parametrize("stream", (False, True))
def test_golden_seed_metrics_through_the_ports_experiment(stream):
    golden = json.loads(GOLDEN.read_text())
    res = Experiment(mechanisms=("BASE",) + MECHANISMS,
                     workloads=[WorkloadConfig(**GOLDEN_CFG)], seeds=(0,),
                     processes=0, stream=stream).run()
    for run in res:
        got = run.metrics.as_dict()
        for key, want in golden[run.spec.mechanism].items():
            if stream and isinstance(want, float):
                # the record sink sums in another order (Experiment.stream)
                assert got[key] == pytest.approx(want, rel=1e-9), key
            else:
                assert got[key] == want, (run.spec.mechanism, key)


def test_experiment_process_fanout_equals_serial():
    kw = dict(mechanisms=("BASE", "CUA&SPAA"),
              workloads=[WorkloadConfig(n_jobs=60, n_nodes=256, n_projects=8,
                                        horizon_days=2.0)], seeds=(0, 1))
    serial = Experiment(processes=0, **kw).run()
    fanned = Experiment(processes=2, **kw).run()
    assert _rows(r.metrics.as_dict() for r in fanned) == \
        _rows(r.metrics.as_dict() for r in serial)


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", module, *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cluster_cli_prints_the_references():
    args = ("--json", "--mechanism", "all")
    rows = [json.loads(line) for line in _run("repro_torch.launch.cluster", *args).splitlines()]
    ref = [json.loads(line) for line in _run("repro.launch.cluster", *args).splitlines()]
    for row in rows + ref:
        row.pop("decision_p99_ms", None)            # wall clock
    assert len(rows) == 1 + len(JMECHANISMS) and rows == ref


def test_service_cli_prints_the_references():
    rep = json.loads(_run("repro_torch.service", "--n-jobs", "40"))
    ref = json.loads(_run("repro.service", "--n-jobs", "40"))
    for r in (rep, ref):                            # wall clock
        del r["wall_s"], r["latency"], r["slo"]["decision_p99_ms"]
    assert rep["ok"] and rep == ref
