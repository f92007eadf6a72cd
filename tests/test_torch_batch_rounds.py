"""The port's copy of batched scheduling rounds (`SimConfig.batch_rounds`)
against the reference's.

Every case of `tests/test_batch_rounds.py`, run once through `repro.core`
and once through `repro_torch.core` on the same jobs.  Each run makes the
reference test's own assertions, and the two must give equal outcomes:
each job's (jid, first start, completion, killed, preemptions, shrinks,
instant start), the event times the incremental API reports, and the
simulator kwargs a scenario threads through `Experiment`.
"""
import dataclasses
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.experiment as jexperiment  # noqa: E402
import repro.core.metrics as jmetrics  # noqa: E402
import repro.core.workloads as jworkloads  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.experiment as texperiment  # noqa: E402
import repro_torch.core.metrics as tmetrics  # noqa: E402
import repro_torch.core.workloads as tworkloads  # noqa: E402

N = 100  # cluster size for micro-scenarios
PKGS = (SimpleNamespace(name="repro", core=jcore, experiment=jexperiment,
                        metrics=jmetrics, workloads=jworkloads),
        SimpleNamespace(name="repro_torch", core=tcore, experiment=texperiment,
                        metrics=tmetrics, workloads=tworkloads))


def both(case, *args):
    """`case(P, *args)` for the reference, then for the port; their outputs
    must be equal.  Returns the port's."""
    ref, port = (case(P, *args) for P in PKGS)
    assert port == ref
    return port


def rigid(P, jid, t, size, rt, est=None, **kw):
    return P.core.JobSpec(jid, P.core.JobType.RIGID, "p", t, size, est or rt * 2, rt, **kw)


def od(P, jid, t, size, rt, kind="NONE", notice=None, est_arr=None):
    return P.core.JobSpec(jid, P.core.JobType.ONDEMAND, "p", t, size, rt * 2, rt,
                          notice_kind=P.core.NoticeKind[kind], notice_time=notice,
                          est_arrival=est_arr)


def run(P, jobs, mech="N&PAA", n=N, **kw):
    sim = P.core.Simulator(P.core.SimConfig(n_nodes=n, mechanism=mech, **kw), jobs)
    sim.run()
    return sim


def _outcomes(records):
    return sorted((r.job.jid, r.first_start, r.completion, r.killed,
                   r.n_preempted, r.n_shrunk, r.instant) for r in records.values())


# --------------------------------------------------------- per-event identity
def test_batch_zero_identical_to_default():
    def case(P):
        cfg = P.core.WorkloadConfig(n_jobs=150, n_nodes=512, n_projects=12,
                                    horizon_days=4.0, seed=3, frac_od_projects=0.3)
        jobs = P.core.generate(cfg)
        ref = run(P, list(jobs), mech="CUA&SPAA", n=512)
        b0 = run(P, list(jobs), mech="CUA&SPAA", n=512, batch_rounds=0.0)
        assert _outcomes(ref.records) == _outcomes(b0.records)
        return _outcomes(b0.records)
    both(case)


# ------------------------------------------------------------ round deferral
def test_batch_job_start_deferred_to_round_boundary():
    def case(P):
        jobs = [rigid(P, 0, 0.0, 10, 500.0), rigid(P, 1, 50.0, 10, 100.0)]
        per_event = run(P, [dataclasses.replace(j) for j in jobs])
        batched = run(P, jobs, batch_rounds=300.0)
        assert per_event.records[1].first_start == 50.0
        assert batched.records[0].first_start == 0.0
        assert batched.records[1].first_start == 300.0
        return _outcomes(per_event.records), _outcomes(batched.records)
    both(case)


def test_od_arrival_immediate_despite_huge_rounds():
    def case(P):
        jobs = [rigid(P, 0, 0.0, 10, 1000.0), od(P, 1, 50.0, 10, 100.0)]
        sim = run(P, jobs, mech="CUA&SPAA", batch_rounds=1e6)
        assert sim.records[1].first_start == 50.0 and sim.records[1].instant
        return _outcomes(sim.records)
    both(case)


def test_od_forced_pass_supersedes_pending_round():
    def case(P):
        jobs = [rigid(P, 0, 10.0, 10, 500.0), od(P, 1, 50.0, 10, 100.0)]
        sim = run(P, jobs, mech="CUA&SPAA", batch_rounds=300.0)
        assert sim.records[0].first_start == 50.0
        assert sim.records[1].first_start == 50.0
        return _outcomes(sim.records)
    both(case)


# ------------------------------------------------------- incremental driving
def test_next_event_time_reports_round_boundary():
    def case(P):
        jobs = [rigid(P, 0, 0.0, 10, 1000.0), rigid(P, 1, 50.0, 10, 100.0)]
        sim = P.core.Simulator(P.core.SimConfig(n_nodes=N, batch_rounds=300.0), jobs)
        seen = [sim.step_until(50.0), sim.next_event_time(), sim.next_event_time()]
        assert seen == [300.0] * 3
        seen.append(sim.step_until(300.0))
        assert seen[-1] == 400.0
        sim.run()
        assert sim.records[1].first_start == 300.0
        return seen, _outcomes(sim.records)
    both(case)


def test_step_until_partitioning_identity_in_batch_mode():
    def case(P):
        jobs, n_nodes = P.workloads.get_scenario("bursty-od", n_jobs=30).realize(seed=6)
        cfg = P.core.SimConfig(n_nodes=n_nodes, mechanism="CUA&SPAA", batch_rounds=240.0)
        ref = P.core.Simulator(cfg, list(jobs)).run()
        sim = P.core.Simulator(cfg, list(jobs))
        t, limits = 0.0, []
        while True:
            nxt = sim.step_until(t)
            if nxt is None:
                break
            limits.append(nxt)
            t = nxt + 1.0
        sim.finalize()
        assert _outcomes(sim.records) == _outcomes(ref)
        return limits, _outcomes(sim.records)
    both(case)


# -------------------------------------------------------------- config plumb
def test_scenario_batch_rounds_validation():
    def case(P):
        sc = P.workloads.get_scenario("bursty-od", n_jobs=10)
        msgs = []
        for bad in (-1.0, float("inf"), float("nan"), True):
            with pytest.raises(ValueError, match="batch_rounds") as e:
                dataclasses.replace(sc, batch_rounds=bad).validate()
            msgs.append(str(e.value))
        dataclasses.replace(sc, batch_rounds=900.0).validate()
        return msgs
    both(case)


def test_experiment_threads_scenario_batch_rounds():
    def case(P):
        E = P.experiment
        sc = dataclasses.replace(P.workloads.get_scenario("bursty-od", n_jobs=10),
                                 batch_rounds=600.0)
        kw = E._sim_kw(E.RunSpec(mechanism="CUA&SPAA", workload=sc, seed=0))
        assert kw["batch_rounds"] == 600.0
        kw0 = E._sim_kw(E.RunSpec(mechanism="CUA&SPAA", workload=sc, seed=0,
                                  sim_kw=(("batch_rounds", 0.0),)))
        assert kw0["batch_rounds"] == 0.0
        return sorted(kw.items()), sorted(kw0.items())
    both(case)


# --------------------------------------------------- decision-time tracking
def test_scheduling_passes_are_timed_without_od_traffic():
    """Decision times read the clock, so the two packages are held to the
    same sample count, not the same values."""
    def case(P):
        jobs = [rigid(P, 0, 0.0, 10, 500.0), rigid(P, 1, 50.0, 10, 100.0)]
        sim = run(P, jobs, track_decision_time=True)
        assert len(sim.decision_times) > 0
        assert P.metrics.decision_p99_ms(sim) is not None
        return len(sim.decision_times), _outcomes(sim.records)
    both(case)


def test_decision_sketch_replaces_list_on_streaming_runs():
    def case(P):
        jobs = [rigid(P, 0, 0.0, 10, 500.0), rigid(P, 1, 50.0, 10, 100.0),
                od(P, 2, 60.0, 10, 100.0)]
        cfg = P.core.SimConfig(n_nodes=N, mechanism="CUA&SPAA", track_decision_time=True)
        sink = P.core.StreamingMetrics(instant_eps=cfg.instant_eps)
        sim = P.core.Simulator(cfg, jobs, record_sink=sink)
        sim.run()
        assert sim.decision_times == []
        assert sim._decision_sketch is not None and sim._decision_sketch.count > 0
        assert P.metrics.decision_p99_ms(sim) is not None
        return sim._decision_sketch.count, sink.completed, sink.od_instant
    both(case)


# ------------------------------------------------------- od_timeout clamping
def test_late_notice_timeout_never_precedes_notice():
    def case(P):
        jobs = [od(P, 0, 100.0, 10, 100.0, kind="LATE", notice=5.0, est_arr=-2000.0)]
        sim = run(P, jobs, mech="CUA&SPAA")
        rec = sim.records[0]
        assert rec.completion is not None and rec.first_start == 100.0
        return _outcomes(sim.records)
    both(case)
