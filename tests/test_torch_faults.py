"""The port's copy of the fault models (`repro_torch.faults`) and the copy's
`Simulator` running them, against the reference (`repro.faults`,
`repro.core.simulator`).

The registry, the spec parser and each model's event stream equal the
reference's; on the scenarios of `tests/test_faults.py` (its hand-made
traces and the `bursty-od` scenario under `exp-mtbf`) the copy's job
records, fault counters and `records_sha256` digests equal the reference's
field by field, and so do a shadow replay's decision digest and the
narrated fault events of the copy's service.  Jobs come from the
reference's workload registry, converted field by field to the port's
JobSpec.
"""
import dataclasses

import pytest

from repro.core import JobSpec as JJobSpec
from repro.core import JobType as JJobType
from repro.core import SimConfig as JSimConfig
from repro.core import Simulator as JSimulator
from repro.core.metrics import records_sha256
from repro.core.workloads import get_scenario
from repro import faults as jfaults
from repro.service import NullLauncher as JNullLauncher
from repro.service import SchedulerService as JSchedulerService
from repro.service import ServiceConfig as JServiceConfig
from repro.service import ServiceCore as JServiceCore
from repro.service import DryrunLauncher as JDryrunLauncher
from repro_torch import faults
from repro_torch.core import JobSpec, JobType, NoticeKind, SimConfig, Simulator
from repro_torch.core.policy import SchedulerView
from repro_torch.service import (DryrunLauncher, NullLauncher, SchedulerService,
                                 ServiceConfig, ServiceCore, shadow_fidelity)

MTBF = "exp-mtbf:mtbf_h=40,mttr_h=2,horizon_days=2"


def _port_spec(j) -> JobSpec:
    kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    kw["jtype"] = JobType(j.jtype.value)
    kw["notice_kind"] = NoticeKind(j.notice_kind.value)
    return JobSpec(**kw)


def _scenario_jobs(n_jobs, seed):
    jobs, n_nodes = get_scenario("bursty-od", n_jobs=n_jobs).realize(seed)
    return list(jobs), n_nodes


def _trace(events):
    return {"model": "trace", "events": events}


def _ev(events):
    """Fault events as plain (t, node, kind) tuples, comparable across the
    two packages' FaultEvent classes."""
    return [dataclasses.astuple(e) for e in events]


def _params(model):
    return {k: _ev(v) if isinstance(v, list) else v for k, v in vars(model).items()}


# ------------------------------------------------------------ registry/spec
def test_registry_equals_the_references():
    assert faults.registered_fault_models() == jfaults.registered_fault_models()


@pytest.mark.parametrize("spec", ["none", "exp-mtbf", "exp-mtbf:mtbf_h=168,mttr_h=2",
                                  "weibull:shape=0.5,scale_h=80", "trace:path=x.jsonl",
                                  "exp-mtbf:mtbf_h=1e3,note=abc"])
def test_parse_fault_spec_equals_the_references(spec):
    assert faults.parse_fault_spec(spec) == jfaults.parse_fault_spec(spec)


@pytest.mark.parametrize("bad,exc", [("exp-mtbf:mtbf_h168", ValueError),
                                     ("mtbf-exp", faults.UnknownFaultModelError),
                                     ("exp-mtbf:nonsense_param=3", ValueError),
                                     ({"no_model_key": 1}, ValueError),
                                     ("exp-mtbf:mtbf_h=-5", ValueError),
                                     (3.14, TypeError)])
def test_bad_specs_raise_as_the_reference(bad, exc):
    jexc = getattr(jfaults, exc.__name__, exc)
    with pytest.raises(jexc):
        jfaults.resolve_faults(bad)
    with pytest.raises(exc):
        faults.resolve_faults(bad)


@pytest.mark.parametrize("spec", [None, "none", "exp-mtbf:mtbf_h=100,mttr_h=1",
                                  {"model": "weibull", "shape": 0.5},
                                  _trace([(5.0, 0, "down"), (9.0, 0, "up")])])
def test_resolve_and_label_equal_the_references(spec):
    m, jm = faults.resolve_faults(spec), jfaults.resolve_faults(spec)
    assert type(m).__name__ == type(jm).__name__ and m.name == jm.name
    assert _params(m) == _params(jm) and m.describe() == jm.describe()
    assert faults.fault_spec_label(spec) == jfaults.fault_spec_label(spec)
    assert faults.resolve_faults(m) is m


def test_trace_file_roundtrip_equals_the_references(tmp_path):
    p = tmp_path / "faults.jsonl"
    p.write_text('{"t": 5.0, "node": 1, "kind": "down"}\n# comment line\n9.0,1,up\n')
    got = faults.TraceFaults(path=str(p)).events(4)
    ref = jfaults.TraceFaults(path=str(p)).events(4)
    assert _ev(got) == _ev(ref) == [(5.0, 1, "down"), (9.0, 1, "up")]


@pytest.mark.parametrize("model,kw", [
    ("ExpMtbfFaults", dict(mtbf_h=50, mttr_h=2, horizon_days=2, seed=7)),
    ("ExpMtbfFaults", dict(mtbf_h=20, mttr_h=4, horizon_days=5, seed=3)),
    ("WeibullFaults", dict(shape=0.7, scale_h=50, mttr_h=2, horizon_days=2, seed=7)),
])
@pytest.mark.parametrize("n_nodes", [4, 16])
def test_event_streams_equal_the_references(model, kw, n_nodes):
    got = getattr(faults, model)(**kw).events(n_nodes)
    ref = getattr(jfaults, model)(**kw).events(n_nodes)
    assert len(got) > 0
    assert _ev(got) == _ev(ref)


# -------------------------------------------------- the simulator under faults
def _job(**kw):
    return JJobSpec(project="t", submit_time=0.0, **kw)


# the hand-made traces of tests/test_faults.py: (n_nodes, jobs, fault trace)
HAND_CASES = {
    "rigid_restarts_from_checkpoint": (2, [_job(
        jid=0, jtype=JJobType.RIGID, size=2, t_estimate=4000.0, t_actual=2000.0,
        t_setup=0.0, ckpt_interval=300.0, ckpt_overhead=0.0)],
        [(500.0, 0, "down"), (600.0, 0, "up")]),
    "malleable_shrinks_then_expands": (4, [_job(
        jid=0, jtype=JJobType.MALLEABLE, size=4, t_estimate=3000.0, t_actual=1000.0,
        t_setup=0.0, n_min=2)], [(200.0, 1, "down"), (400.0, 1, "up")]),
    "malleable_at_n_min_restarts": (2, [_job(
        jid=0, jtype=JJobType.MALLEABLE, size=2, t_estimate=3000.0, t_actual=1000.0,
        t_setup=0.0, n_min=2)], [(200.0, 0, "down"), (300.0, 0, "up")]),
    "ondemand_redispatched": (2, [dataclasses.replace(_job(
        jid=0, jtype=JJobType.ONDEMAND, size=2, t_estimate=300.0, t_actual=300.0),
        project="od", submit_time=100.0)], [(200.0, 0, "down"), (250.0, 0, "up")]),
    "free_pool_failure_delays_start": (2, [dataclasses.replace(_job(
        jid=0, jtype=JJobType.RIGID, size=2, t_estimate=1000.0, t_actual=400.0),
        submit_time=100.0)], [(50.0, 0, "down"), (500.0, 0, "up")]),
}

COUNTERS = ("fault_model_name", "fault_downs", "fault_ups", "n_interruptions",
            "fault_lost_node_s", "avail_integral", "avail_at_completion", "now")


def _both(n_nodes, jjobs, mech, spec):
    ref = JSimulator(JSimConfig(n_nodes=n_nodes, mechanism=mech, faults=spec), list(jjobs))
    ref.run()
    sim = Simulator(SimConfig(n_nodes=n_nodes, mechanism=mech, faults=spec),
                    [_port_spec(j) for j in jjobs])
    sim.run()
    return sim, ref


def _assert_same_run(sim, ref):
    assert sorted(sim.records) == sorted(ref.records)
    fields = [f.name for f in dataclasses.fields(ref.records[0]) if f.name != "job"]
    for jid, r in ref.records.items():
        s = sim.records[jid]
        assert _port_spec(r.job) == s.job
        assert [getattr(s, f) for f in fields] == [getattr(r, f) for f in fields], jid
    assert [getattr(sim, c) for c in COUNTERS] == [getattr(ref, c) for c in COUNTERS]
    assert records_sha256(sim.records) == records_sha256(ref.records)


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_hand_traces_equal_the_references(case):
    n_nodes, jjobs, events = HAND_CASES[case]
    sim, ref = _both(n_nodes, jjobs, "CUA&SPAA", _trace(events))
    _assert_same_run(sim, ref)
    assert sim.fault_downs == 1
    sim.ledger.check()


@pytest.mark.parametrize("mech", ["BASE", "CUA&SPAA", "CUP&STEAL", "N&PAA"])
@pytest.mark.parametrize("seed", [2, 3])
def test_scenario_under_exp_mtbf_equals_the_references(mech, seed):
    jjobs, n_nodes = _scenario_jobs(40, seed)
    sim, ref = _both(n_nodes, jjobs, mech, MTBF)
    _assert_same_run(sim, ref)
    assert sim.fault_downs > 0 and sim.fault_ups == sim.fault_downs
    assert sim.ledger.down == 0
    sim.ledger.check()


def test_none_is_the_fault_free_run():
    jjobs, n_nodes = _scenario_jobs(40, 0)
    digests = {spec: _both(n_nodes, jjobs, "CUP&STEAL", spec)
               for spec in ("none", None, MTBF)}
    for sim, ref in digests.values():
        _assert_same_run(sim, ref)
    plain = Simulator(SimConfig(n_nodes=n_nodes, mechanism="CUP&STEAL"),
                      [_port_spec(j) for j in jjobs])
    plain.run()
    d = {spec: records_sha256(sim.records) for spec, (sim, _) in digests.items()}
    assert d["none"] == d[None] == records_sha256(plain.records) != d[MTBF]


def test_view_exposes_fault_state():
    j = _port_spec(_job(jid=0, jtype=JJobType.RIGID, size=1, t_estimate=5000.0,
                        t_actual=4000.0))
    sim = Simulator(SimConfig(n_nodes=4, mechanism="CUA&SPAA",
                              faults=_trace([(100.0, 2, "down"), (900.0, 2, "up")])), [j])
    view = SchedulerView(sim)
    assert view.fault_model == "trace"
    sim.step_until(500.0)
    assert view.down == 1
    sim.step_until(1000.0)
    assert view.down == 0 and view.draining == 0


# ------------------------------------------------------- the service under faults
@pytest.mark.parametrize("mech", ["CUA&SPAA", "CUP&STEAL"])
def test_shadow_replay_under_faults_equals_the_references(mech):
    jjobs, n_nodes = _scenario_jobs(40, 3)
    over = {"faults": MTBF}
    jrep = JSchedulerService(JServiceConfig(n_nodes=n_nodes, mechanism=mech,
                                            sim_overrides=over), list(jjobs),
                             launcher=JDryrunLauncher(n_nodes)).run_replay()
    cfg = ServiceConfig(n_nodes=n_nodes, mechanism=mech, sim_overrides=over)
    rep = SchedulerService(cfg, [_port_spec(j) for j in jjobs],
                           launcher=DryrunLauncher(n_nodes)).run_replay()
    assert rep.n_decisions == jrep.n_decisions > 0
    assert rep.digest == jrep.digest
    fr = shadow_fidelity([_port_spec(j) for j in jjobs], cfg)
    assert fr.ok, fr.mismatched_jids


def test_service_core_narrates_the_references_fault_events():
    jjobs, n_nodes = _scenario_jobs(40, 3)
    over = {"faults": MTBF}
    jcore = JServiceCore(JServiceConfig(n_nodes=n_nodes, sim_overrides=over).sim_config(),
                         list(jjobs), launcher=JNullLauncher())
    jcore.run()
    core = ServiceCore(ServiceConfig(n_nodes=n_nodes, sim_overrides=over).sim_config(),
                       [_port_spec(j) for j in jjobs], launcher=NullLauncher())
    core.run()
    rows, jrows = core.drain_decisions(), jcore.drain_decisions()
    assert rows == jrows
    assert {"node_down", "node_up"} <= {r["event"] for r in rows}
