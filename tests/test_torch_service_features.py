"""The port's copy of the scheduler service against the reference's.

Every case of `tests/test_service.py` (the replay clock, the decision log
and its digest, `SloMonitor`, the dry-run launcher, the shadow replay, live
admission, the incremental simulator API), run once through `repro` and
once through `repro_torch` on the same inputs.  Each run makes the
reference test's own assertions, and the two must give equal outputs: the
decision rows (without `wall`, `mono` and `latency_ms`, which read the
clock), the digests, the job records, the reports' counts and the request
plans.  Values read off the wall clock (sleeps, latencies) are held to the
reference's bounds on each side, not to each other.
"""
import json
import math
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.workloads as jworkloads  # noqa: E402
import repro.service as jservice  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.workloads as tworkloads  # noqa: E402
import repro_torch.service as tservice  # noqa: E402
from repro_torch.service.decisionlog import MEASUREMENT_KEYS  # noqa: E402

PKGS = (SimpleNamespace(name="repro", core=jcore, workloads=jworkloads, service=jservice),
        SimpleNamespace(name="repro_torch", core=tcore, workloads=tworkloads,
                        service=tservice))


def both(case, *args):
    """`case(P, *args)` for the reference, then for the port; their outputs
    must be equal, compared as JSON text (so a NaN, which a report gives
    where it has no sample, equals a NaN).  Returns the port's."""
    ref, port = (case(P, *args) for P in PKGS)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    return port


def _decisions(rows):
    return [{k: v for k, v in r.items() if k not in MEASUREMENT_KEYS} for r in rows]


def _records(records):
    return sorted((r.job.jid, r.first_start, r.completion, r.killed, r.n_preempted,
                   r.n_shrunk, r.instant) for r in records.values())


def _jobs_small(P):
    """A hand-rolled hybrid mix exercising shrink, preempt, and notice."""
    C = P.core
    return [
        C.JobSpec(jid=0, jtype=C.JobType.MALLEABLE, project="t", submit_time=0.0,
                  size=6, t_estimate=9000.0, t_actual=6000.0, t_setup=30.0, n_min=2),
        C.JobSpec(jid=1, jtype=C.JobType.RIGID, project="t", submit_time=10.0,
                  size=2, t_estimate=4000.0, t_actual=3000.0, t_setup=30.0),
        C.JobSpec(jid=2, jtype=C.JobType.ONDEMAND, project="od", submit_time=600.0,
                  size=4, t_estimate=1200.0, t_actual=1200.0,
                  notice_kind=C.NoticeKind.ACCURATE, notice_time=300.0, est_arrival=600.0),
        C.JobSpec(jid=3, jtype=C.JobType.RIGID, project="t", submit_time=700.0,
                  size=3, t_estimate=2000.0, t_actual=1500.0, t_setup=30.0),
    ]


def _scenario_jobs(P, n_jobs=40, seed=0):
    return P.workloads.get_scenario("bursty-od", n_jobs=n_jobs).realize(seed)


def _report(rep):
    """A ShadowReport without what reads the clock."""
    d = rep.as_dict()
    for k in ("wall_s", "latency", "slo"):
        d.pop(k)
    return d


# ------------------------------------------------------------- replay clock
def test_replay_clock_inf_never_sleeps():
    def case(P):
        clock = P.service.ReplayClock()
        assert not clock.realtime
        t0 = time.monotonic()
        assert clock.sleep_until(1e12) == 0.0
        assert time.monotonic() - t0 < 0.05
        assert clock.now_sim() == math.inf
        return clock.realtime, clock.now_sim()
    both(case)


def test_replay_clock_scales_and_sleeps():
    def case(P):
        clock = P.service.ReplayClock(speed=1000.0, origin=500.0)
        assert clock.realtime
        assert clock.sleep_until(520.0) > 0.0
        assert clock.now_sim() >= 520.0
        return clock.realtime
    both(case)


def test_replay_clock_rejects_bad_speed():
    def case(P):
        msgs = []
        for bad in (0.0, -1.0, float("nan")):
            with pytest.raises(ValueError) as e:
                P.service.ReplayClock(speed=bad)
            msgs.append(str(e.value))
        return msgs
    both(case)


# ------------------------------------------------------------- decision log
def test_decision_log_jsonl_roundtrip_and_digest(tmp_path):
    def case(P):
        S = P.service
        path = str(tmp_path / f"{P.name}.jsonl")
        rows = [{"seq": 0, "event": "start", "jid": 1, "t_sim": 0.0},
                {"seq": 1, "event": "end", "jid": 1, "t_sim": 9.5}]
        with S.DecisionLog(path) as log:
            log.append(rows[0], latency_ms=0.5)
            log.append(rows[1], latency_ms=1.5)
            digest = log.digest
        back = S.read_decision_log(path)
        assert len(back) == 2
        assert back[0]["event"] == "start" and "wall" in back[0]
        assert back[1]["latency_ms"] == 1.5
        assert S.decision_digest(back) == digest == S.decision_digest(rows)
        return digest, _decisions(back), [r["latency_ms"] for r in back]
    both(case)


def test_decision_log_latency_summary():
    def case(P):
        log = P.service.DecisionLog()
        for ms in (1.0, 2.0, 3.0, 4.0):
            log.append({"seq": 0, "event": "x", "jid": 0}, latency_ms=ms)
        s = log.latency_summary()
        assert s["n"] == 4 and s["max_ms"] == 4.0
        assert 1.0 <= s["p50_ms"] <= 3.0 <= s["p99_ms"] <= 4.0
        assert P.service.DecisionLog().latency_summary()["n"] == 0
        return s, P.service.DecisionLog().latency_summary()
    both(case)


def test_digest_sensitive_to_order_and_content():
    def case(P):
        dd = P.service.decision_digest
        a = [{"seq": 0, "event": "start", "jid": 1}]
        b = [{"seq": 0, "event": "start", "jid": 2}]
        assert dd(a) != dd(b)
        two = [{"seq": 0, "event": "s", "jid": 1}, {"seq": 1, "event": "e", "jid": 1}]
        assert dd(two) != dd(list(reversed(two)))
        return dd(a), dd(b), dd(two), dd(list(reversed(two)))
    both(case)


# -------------------------------------------------------------- slo monitor
def test_slo_monitor_gates_decision_latency():
    def case(P):
        mon = P.service.SloMonitor(P.service.SloPolicy(decision_p99_ms=1.0))
        for _ in range(10):
            mon.add_decision_latency(0.2)
        first = mon.report()
        assert first.ok
        mon.add_decision_latency(500.0)
        rep = mon.report()
        assert not rep.ok and "decision p99" in rep.violations[0]
        return first.as_dict(), rep.as_dict()
    both(case)


def test_slo_monitor_od_wait_gate():
    def case(P):
        mon = P.service.SloMonitor(P.service.SloPolicy(od_wait_p99_s=10.0))
        sim = P.core.Simulator(P.core.SimConfig(n_nodes=8), _jobs_small(P),
                               record_sink=mon.add_record)
        sim.run()
        rep = mon.report()
        assert rep.n_od == 1 and rep.ok
        return rep.as_dict()
    both(case)


# ----------------------------------------------------------- dryrun launcher
def test_dryrun_launcher_validates_transitions():
    def case(P):
        S, C = P.service, P.core
        lau = S.DryrunLauncher(n_nodes=4)
        od = C.JobSpec(jid=9, jtype=C.JobType.ONDEMAND, project="od", submit_time=0.0,
                       size=2, t_estimate=10.0, t_actual=10.0)
        msgs = []
        with pytest.raises(S.ShadowLaunchError) as e:
            lau.resize(od, 1)
        msgs.append(str(e.value))
        lau.start_job(od, 2)
        with pytest.raises(S.ShadowLaunchError) as e:
            lau.start_job(od, 2)
        msgs.append(str(e.value))
        assert lau.counts["od_start"] == 1
        assert lau.request_plans[9] == S.plan_requests(od)
        big = C.JobSpec(jid=10, jtype=C.JobType.RIGID, project="t", submit_time=0.0,
                        size=3, t_estimate=10.0, t_actual=10.0)
        with pytest.raises(S.ShadowLaunchError) as e:
            lau.start_job(big, 3)
        msgs.append(str(e.value))
        with pytest.raises(S.ShadowLaunchError) as e:
            lau.close()
        msgs.append(str(e.value))
        return msgs, dict(lau.counts), lau.request_plans
    both(case)


def test_plan_requests_deterministic_and_bounded():
    def case(P):
        C = P.core
        od = C.JobSpec(jid=3, jtype=C.JobType.ONDEMAND, project="od", submit_time=0.0,
                       size=20, t_estimate=10.0, t_actual=10.0)
        plan = P.service.plan_requests(od, max_batch=8)
        assert plan == P.service.plan_requests(od, max_batch=8)
        assert len(plan) == 8
        assert all(8 <= r["prompt_len"] < 64 for r in plan)
        return plan
    both(case)


# ------------------------------------------------------- core + replay loop
def test_service_core_decision_stream_matches_offline_reference():
    def case(P):
        S = P.service
        jobs, n_nodes = _scenario_jobs(P)
        cfg = S.ServiceConfig(n_nodes=n_nodes)
        svc = S.SchedulerService(cfg, list(jobs), launcher=S.DryrunLauncher(n_nodes))
        rep = svc.run_replay()
        ref = S.ServiceCore(cfg.sim_config(), list(jobs), launcher=S.NullLauncher())
        ref.run()
        decisions = ref.drain_decisions()
        assert rep.digest == S.decision_digest(decisions)
        assert rep.n_decisions > 0
        return _report(rep), _decisions(decisions), _decisions(svc.log.rows)
    both(case)


def test_shadow_fidelity_job_for_job_all_mechanisms():
    def case(P):
        S = P.service
        jobs, n_nodes = _scenario_jobs(P, n_jobs=30, seed=1)
        out = []
        for mech in ("BASE", "N&PAA", "CUA&SPAA", "CUP&STEAL"):
            rep = S.shadow_fidelity(jobs, S.ServiceConfig(n_nodes=n_nodes, mechanism=mech))
            assert rep.ok, (mech, rep.mismatched_jids)
            assert rep.digests_match and rep.records_match
            out.append((mech, rep.digest_service, rep.digest_reference, rep.n_jobs))
        return out
    both(case)


def test_service_replay_writes_decision_log(tmp_path):
    def case(P):
        S = P.service
        jobs, n_nodes = _scenario_jobs(P, n_jobs=20, seed=8)
        path = str(tmp_path / f"{P.name}.jsonl")
        cfg = S.ServiceConfig(n_nodes=n_nodes, decision_log_path=path)
        rep = S.SchedulerService(cfg, jobs, launcher=S.DryrunLauncher(n_nodes)).run_replay()
        rows = S.read_decision_log(path)
        assert len(rows) == rep.n_decisions
        assert S.decision_digest(rows) == rep.digest
        assert all("latency_ms" in r and "wall" in r and "mono" in r for r in rows)
        starts = [r for r in rows if r["event"] == "start"]
        assert starts and all("size" in r and "jtype" in r for r in starts)
        return _report(rep), _decisions(rows)
    both(case)


def test_service_realtime_pacing_spreads_decisions():
    def case(P):
        S = P.service
        cfg = S.ServiceConfig(n_nodes=8, speed=5000.0)
        svc = S.SchedulerService(cfg, _jobs_small(P), launcher=S.DryrunLauncher(8))
        rep = svc.run_replay()
        assert rep.wall_s > 0.1
        assert rep.digest == S.shadow_fidelity(
            _jobs_small(P), S.ServiceConfig(n_nodes=8)).digest_reference
        return _report(rep), _decisions(svc.log.rows)
    both(case)


def test_service_streaming_record_sink():
    def case(P):
        S = P.service
        jobs, n_nodes = _scenario_jobs(P, n_jobs=25, seed=3)
        seen = []
        svc = S.SchedulerService(S.ServiceConfig(n_nodes=n_nodes), jobs,
                                 launcher=S.DryrunLauncher(n_nodes), record_sink=seen.append)
        rep = svc.run_replay()
        assert len(seen) == rep.n_jobs
        assert not svc.core.records
        return _report(rep), _records({i: r for i, r in enumerate(seen)})
    both(case)


def test_shadow_report_is_json_serializable():
    def case(P):
        jobs, n_nodes = _scenario_jobs(P, n_jobs=15, seed=4)
        rep = P.service.shadow_fidelity(jobs, P.service.ServiceConfig(n_nodes=n_nodes))
        d = json.loads(json.dumps(rep.as_dict(), default=str))
        d["service"] = {k: v for k, v in d["service"].items()
                        if k not in ("wall_s", "latency", "slo")}
        return d
    both(case)


# ---------------------------------------------------------------- live mode
def test_live_admission_end_to_end():
    def case(P):
        S = P.service
        adm = S.AdmissionQueue()
        svc = S.SchedulerService(S.ServiceConfig(n_nodes=8, speed=5000.0), [],
                                 launcher=S.DryrunLauncher(8))
        adm.submit_training(n_max=6, runtime_s=600.0, n_min=2)
        adm.submit_rigid(nodes=2, runtime_s=300.0)
        adm.submit_inference(nodes=4, hold_s=200.0, submit_time=100.0, notice_lead_s=60.0)
        adm.close()
        rep = svc.run_live(adm)
        events = [r["event"] for r in svc.log.rows]
        assert events.count("admit") == 3
        assert "shrink" in events and "expand" in events
        assert rep.launcher_counts["od_start"] == 1
        assert rep.launcher_counts["finish"] == 3
        return events, rep.launcher_counts, rep.admission_counts
    both(case)


def test_live_admission_clamps_past_times():
    def case(P):
        S, C = P.service, P.core
        core = S.ServiceCore(C.SimConfig(n_nodes=4), [], launcher=S.NullLauncher())
        core.step_until(0.0)
        core.now = 100.0
        spec = C.JobSpec(jid=7, jtype=C.JobType.RIGID, project="t", submit_time=5.0,
                         size=1, t_estimate=10.0, t_actual=10.0)
        admitted = core.admit(spec)
        assert admitted.submit_time == 100.0
        with pytest.raises(ValueError) as e:
            core.admit(admitted)
        return admitted.submit_time, str(e.value)
    both(case)


def test_admit_rejected_on_trace_replaying_core():
    def case(P):
        jobs, n_nodes = _scenario_jobs(P, n_jobs=10, seed=5)
        core = P.service.ServiceCore(P.core.SimConfig(n_nodes=n_nodes), iter(jobs))
        with pytest.raises(RuntimeError) as e:
            core.admit(jobs[0])
        return str(e.value)
    both(case)


def test_admission_queue_thread_safety_and_close():
    def case(P):
        adm = P.service.AdmissionQueue(base_jid=50)
        s1 = adm.submit_training(n_max=2, runtime_s=10.0)
        s2 = adm.submit_inference(nodes=1, hold_s=5.0)
        assert (s1.jid, s2.jid) == (50, 51) and len(adm) == 2
        got = adm.drain()
        assert [j.jid for j in got] == [50, 51] and len(adm) == 0
        adm.close()
        with pytest.raises(RuntimeError) as e:
            adm.submit_rigid(nodes=1, runtime_s=1.0)
        return [(j.jid, j.jtype.value, j.size, j.t_actual, j.n_min) for j in got], str(e.value)
    both(case)


# ------------------------------------------------------------ incremental API
def test_step_until_partitioning_matches_single_run():
    def case(P):
        jobs, n_nodes = _scenario_jobs(P, n_jobs=30, seed=6)
        cfg = P.core.SimConfig(n_nodes=n_nodes)
        ref = P.core.Simulator(cfg, list(jobs)).run()
        sim = P.core.Simulator(cfg, list(jobs))
        t = 0.0
        while True:
            nxt = sim.step_until(t)
            if nxt is None:
                break
            t = nxt + 1.0
        got = sim.records
        assert set(got) == set(ref)
        for jid in ref:
            assert got[jid].completion == ref[jid].completion
            assert got[jid].n_preempted == ref[jid].n_preempted
        return _records(got)
    both(case)


def test_next_event_time_monotone_nonperturbing():
    def case(P):
        jobs, n_nodes = _scenario_jobs(P, n_jobs=10, seed=7)
        sim = P.core.Simulator(P.core.SimConfig(n_nodes=n_nodes), iter(list(jobs)))
        t1 = sim.next_event_time()
        assert t1 == sim.next_event_time()
        sim.step_until(t1)
        t2 = sim.next_event_time()
        assert t2 is None or t2 > t1
        return t1, t2
    both(case)
