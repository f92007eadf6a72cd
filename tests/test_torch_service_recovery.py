"""The port's copy of the crash-recoverable service against the reference's.

Every case of `tests/test_service_recovery.py` (decision-log rotation, torn
tails, SIGKILL recovery, retrying launchers, quarantine, admission
backpressure), run once through `repro.service` and once through
`repro_torch.service` on the same inputs.  Each run makes the reference
test's own assertions, and the two runs must give equal outputs: the
decision rows (without the measurement fields `wall`, `mono` and
`latency_ms`, which read the clock), the decision-stream sha256, the
recovered digest and the counters.  The SIGKILL case kills a real child
process, as the reference's test does, once with `import repro.service`
and once with `import repro_torch.service`.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
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

SRC = str(Path(__file__).resolve().parents[1] / "src")
PKGS = (SimpleNamespace(name="repro", core=jcore, workloads=jworkloads, service=jservice),
        SimpleNamespace(name="repro_torch", core=tcore, workloads=tworkloads,
                        service=tservice))


def both(case, *args):
    """`case(P, *args)` for the reference, then for the port; their outputs
    must be equal.  Returns the port's."""
    ref, port = (case(P, *args) for P in PKGS)
    assert port == ref
    return port


def _jobs(P, n_jobs=40, seed=3):
    return P.workloads.get_scenario("bursty-od", n_jobs=n_jobs).realize(seed)


def _reference_digest(P, jobs, n_nodes, mechanism):
    svc = P.service.SchedulerService(
        P.service.ServiceConfig(n_nodes=n_nodes, mechanism=mechanism), list(jobs))
    return svc.run_replay().digest


def _decisions(rows):
    return [{k: v for k, v in r.items() if k not in MEASUREMENT_KEYS} for r in rows]


# --------------------------------------------------------------- rotation
def test_rotation_produces_segments_and_roundtrips(tmp_path):
    def case(P):
        S = P.service
        jobs, n_nodes = _jobs(P)
        path = str(tmp_path / P.name / "log.jsonl")
        os.makedirs(os.path.dirname(path))
        cfg = S.ServiceConfig(n_nodes=n_nodes, decision_log_path=path, log_rotate_bytes=2048)
        rep = S.SchedulerService(cfg, list(jobs)).run_replay()
        segs = S.log_segments(path)
        assert len(segs) > 2 and segs[-1] == path
        for seg in segs[:-1]:
            assert os.path.getsize(seg) >= 2048
        rows = S.read_decision_log(path)
        assert len(rows) == rep.n_decisions
        assert S.decision_digest(rows) == rep.digest
        return rep.digest, len(segs), _decisions(rows)
    both(case)


# -------------------------------------------------------------- torn tails
def test_torn_final_line_skipped_with_warning(tmp_path):
    def case(P):
        path = str(tmp_path / f"{P.name}.jsonl")
        with P.service.DecisionLog(path) as log:
            log.append({"seq": 0, "event": "start", "jid": 1, "t_sim": 0.0})
            log.append({"seq": 1, "event": "end", "jid": 1, "t_sim": 5.0})
        with open(path, "a") as fh:
            fh.write('{"seq": 2, "event": "sta')
        with pytest.warns(RuntimeWarning, match="torn final line"):
            rows = P.service.read_decision_log(path)
        assert [r["seq"] for r in rows] == [0, 1]
        return _decisions(rows)
    both(case)


def test_midfile_corruption_raises(tmp_path):
    def case(P):
        path = str(tmp_path / f"{P.name}.jsonl")
        good = json.dumps({"seq": 0, "event": "start", "jid": 1})
        with open(path, "w") as fh:
            fh.write(good + "\n" + "NOT JSON AT ALL\n" + good + "\n")
        with pytest.raises(P.service.TornLogError, match="corrupt row") as e:
            P.service.read_decision_log(path)
        return str(e.value).replace(P.name, "<pkg>")
    both(case)


def test_recover_truncates_torn_tail_and_appends(tmp_path):
    def case(P):
        S = P.service
        path = str(tmp_path / f"{P.name}.jsonl")
        with S.DecisionLog(path) as log:
            log.append({"seq": 0, "event": "start", "jid": 1, "t_sim": 0.0})
        size_clean = os.path.getsize(path)
        with open(path, "a") as fh:
            fh.write('{"torn')
        with pytest.warns(RuntimeWarning):
            log2, rows = S.DecisionLog.recover(path)
        assert os.path.getsize(path) == size_clean
        assert len(rows) == 1 and log2.n_rows == 1
        log2.append({"seq": 1, "event": "end", "jid": 1, "t_sim": 5.0})
        log2.close()
        rows = S.read_decision_log(path)
        assert [r["seq"] for r in rows] == [0, 1]
        ref = S.DecisionLog()
        ref.append({"seq": 0, "event": "start", "jid": 1, "t_sim": 0.0})
        ref.append({"seq": 1, "event": "end", "jid": 1, "t_sim": 5.0})
        assert log2.digest == ref.digest
        return log2.digest, _decisions(rows)
    both(case)


def test_recover_reads_rotated_segments_in_order(tmp_path):
    def case(P):
        path = str(tmp_path / P.name / "log.jsonl")
        os.makedirs(os.path.dirname(path))
        with P.service.DecisionLog(path, rotate_bytes=200) as log:
            for i in range(20):
                log.append({"seq": i, "event": "start", "jid": i, "t_sim": 0.0})
        n_segs = len(P.service.log_segments(path))
        assert n_segs > 1
        log2, rows = P.service.DecisionLog.recover(path)
        log2.close()
        assert [r["seq"] for r in rows] == list(range(20))
        return n_segs, log2.digest, _decisions(rows)
    both(case)


# ----------------------------------------------------- SIGKILL + recovery
_CHILD = """
import os, signal, sys
from {pkg}.core.workloads import get_scenario
from {pkg}.service import SchedulerService, ServiceConfig

path, mech, k = sys.argv[1], sys.argv[2], int(sys.argv[3])
jobs, n_nodes = get_scenario("bursty-od", n_jobs=40).realize(3)
cfg = ServiceConfig(n_nodes=n_nodes, mechanism=mech,
                    decision_log_path=path, log_rotate_bytes=2048)
svc = SchedulerService(cfg, list(jobs))
orig = svc.log.append
state = {{"n": 0}}
def killing_append(row, **kw):
    out = orig(row, **kw)
    state["n"] += 1
    if state["n"] >= k:
        os.kill(os.getpid(), signal.SIGKILL)
    return out
svc.log.append = killing_append
svc.run_replay()
raise SystemExit("unreachable: the child should have been SIGKILLed")
"""


@pytest.mark.parametrize("mechanism", ["CUA&SPAA", "CUP&STEAL"])
def test_sigkill_then_recover_digest_identical(tmp_path, mechanism):
    """Kill a real service process after 25 logged decisions; recover in
    this process; the finished stream equals an uninterrupted run's, and
    the port's recovery equals the reference's."""
    def case(P):
        S = P.service
        jobs, n_nodes = _jobs(P)
        path = str(tmp_path / P.name / "log.jsonl")
        os.makedirs(os.path.dirname(path))
        child = tmp_path / f"child_{P.name}.py"
        child.write_text(_CHILD.format(pkg=P.name))
        env = dict(os.environ, PYTHONPATH=SRC)
        proc = subprocess.run([sys.executable, str(child), path, mechanism, "25"],
                              env=env, capture_output=True, timeout=120)
        assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
        cfg = S.ServiceConfig(n_nodes=n_nodes, mechanism=mechanism,
                              decision_log_path=path, log_rotate_bytes=2048)
        svc, rr = S.SchedulerService.recover(cfg, list(jobs))
        assert rr.ok and rr.digests_match
        assert rr.n_decisions_recovered >= 25
        rep = svc.run_replay()
        ref = _reference_digest(P, jobs, n_nodes, mechanism)
        assert rep.digest == ref
        rows = S.read_decision_log(path)
        assert S.decision_digest(rows) == ref
        return rr.as_dict(), rep.digest, _decisions(rows)
    both(case)


def test_recover_in_process_after_abandoned_partial_run(tmp_path):
    def case(P):
        S = P.service
        jobs, n_nodes = _jobs(P)
        path = str(tmp_path / P.name / "log.jsonl")
        os.makedirs(os.path.dirname(path))
        cfg = S.ServiceConfig(n_nodes=n_nodes, decision_log_path=path, log_rotate_bytes=1024)
        crashed = S.SchedulerService(cfg, list(jobs))
        while crashed.core.n_decisions < 40:
            t = crashed.core.next_event_time()
            if t is None:
                break
            crashed._step_batch(t)
        svc, rr = S.SchedulerService.recover(cfg, list(jobs))
        assert rr.ok and rr.resumed_at > 0.0
        rep = svc.run_replay()
        assert rep.digest == _reference_digest(P, jobs, n_nodes, cfg.mechanism)
        return rr.as_dict(), rep.digest
    both(case)


def test_recover_requires_log_path():
    def case(P):
        with pytest.raises(ValueError, match="decision_log_path") as e:
            P.service.SchedulerService.recover(P.service.ServiceConfig(n_nodes=8), [])
        return str(e.value)
    both(case)


# -------------------------------------------------------- retrying launcher
def _flaky(P, n_nodes, fail_first):
    class Flaky(P.service.DryrunLauncher):
        """Fails the first `fail_first` start attempts transiently."""

        def __init__(self):
            super().__init__(n_nodes)
            self.fails = fail_first

        def start_job(self, job, size):
            if self.fails > 0:
                self.fails -= 1
                raise P.service.TransientLaunchError("network blip")
            super().start_job(job, size)
    return Flaky()


def _broken(P, quiet=False):
    class Broken(P.service.DryrunLauncher):
        def start_job(self, job, size):
            raise RuntimeError("bad node")

    class QuietBroken(Broken):
        def preempt(self, job):
            pass

        def resize(self, job, new_size):
            pass

        def finish(self, rec):
            pass

        def close(self):
            pass
    return QuietBroken if quiet else Broken


def test_retry_recovers_transient_failures_and_digest_unchanged():
    def case(P):
        S = P.service
        jobs, n_nodes = _jobs(P)
        naps = []
        rl = S.RetryingLauncher(_flaky(P, n_nodes, 3), S.RetryPolicy(retries=3, seed=1),
                                sleep=naps.append)
        rep = S.SchedulerService(S.ServiceConfig(n_nodes=n_nodes), list(jobs),
                                 launcher=rl).run_replay()
        assert rep.digest == _reference_digest(P, jobs, n_nodes, "CUA&SPAA")
        assert rl.counts["launch_retries"] == 3 and rl.counts["launch_failures"] == 0
        assert len(naps) == 3 and all(d >= 0.0 for d in naps)
        assert rep.launcher_counts["launch_retries"] == 3
        return rep.digest, naps, rep.launcher_counts
    both(case)


def test_retry_backoff_grows_and_is_seeded():
    def case(P):
        S = P.service

        def delays(seed):
            out = []
            rl = S.RetryingLauncher(S.DryrunLauncher(4),
                                    S.RetryPolicy(retries=5, base_delay_s=0.1,
                                                  max_delay_s=100.0, seed=seed),
                                    sleep=out.append)
            for attempt in range(5):
                out.append(rl._delay(attempt))
            return out
        assert delays(7) == delays(7) and delays(7) != delays(8)
        for d, cap in zip(delays(7), [0.1 * 2 ** i for i in range(5)]):
            assert 0.0 <= d <= cap
        return delays(7), delays(8)
    both(case)


def test_persistent_failure_goes_to_give_up_callback():
    def case(P):
        S = P.service
        seen = []
        rl = S.RetryingLauncher(_broken(P)(8), S.RetryPolicy(retries=2),
                                on_give_up=lambda a, s, e: seen.append((a, str(e))),
                                sleep=lambda s: None)
        jobs, _ = _jobs(P, n_jobs=10)
        rl.start_job(jobs[0], 2)
        assert seen == [("start", "bad node")]
        assert rl.launch_retries == 0 and rl.launch_failures == 1
        return seen, rl.counts
    both(case)


def test_shadow_launch_error_stays_fatal():
    def case(P):
        S = P.service
        rl = S.RetryingLauncher(S.DryrunLauncher(4), S.RetryPolicy(retries=5),
                                sleep=lambda s: None)
        jobs, _ = _jobs(P, n_jobs=10)
        rl.start_job(jobs[0], 2)
        with pytest.raises(S.ShadowLaunchError) as e:
            rl.start_job(jobs[0], 2)
        return str(e.value), rl.counts
    both(case)


def test_give_up_without_callback_warns_not_raises():
    def case(P):
        S = P.service
        rl = S.RetryingLauncher(_broken(P)(8), S.RetryPolicy(retries=0),
                                sleep=lambda s: None)
        jobs, _ = _jobs(P, n_jobs=10)
        with pytest.warns(RuntimeWarning, match="gave up") as rec:
            rl.start_job(jobs[0], 2)
        return [str(w.message) for w in rec], rl.counts
    both(case)


# ---------------------------------------------------- quarantine wiring
def test_launch_failures_quarantine_nodes_and_are_digest_exempt():
    def case(P):
        S = P.service
        jobs, n_nodes = _jobs(P)
        rl = S.RetryingLauncher(_broken(P, quiet=True)(n_nodes), S.RetryPolicy(retries=1),
                                sleep=lambda s: None)
        svc = S.SchedulerService(S.ServiceConfig(n_nodes=n_nodes), list(jobs), launcher=rl)
        rep = svc.run_replay()
        lf = [r for r in svc.log.rows if r["event"] == "launch_failed"]
        q = [r for r in svc.log.rows if r["event"] == "quarantine"]
        assert lf and q
        assert all(r["seq"] == -1 for r in lf + q)
        assert svc.core.ledger.draining > 0
        assert svc.core.n_quarantined == len(q)
        assert S.decision_digest(svc.log.rows) == rep.digest
        return rep.digest, _decisions(svc.log.rows), svc.core.ledger.draining
    both(case)


def test_quarantine_waits_for_free_nodes():
    def case(P):
        jobs, _ = _jobs(P, n_jobs=6)
        core = P.service.ServiceCore(P.core.SimConfig(n_nodes=4), jobs)
        core.quarantine(2)
        core.run()
        assert core.ledger.draining == 2 and core.n_quarantined == 2
        core.ledger.check()
        return _decisions(core.drain_decisions())
    both(case)


# ------------------------------------------------- admission backpressure
def test_admission_rejects_bad_config():
    def case(P):
        msgs = []
        with pytest.raises(ValueError, match="backpressure") as e:
            P.service.AdmissionQueue(backpressure="drop-everything")
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="maxsize") as e:
            P.service.AdmissionQueue(maxsize=0)
        msgs.append(str(e.value))
        return msgs
    both(case)


def _spec(j):
    return (j.jid, j.jtype.value, j.project, j.submit_time, j.size, j.t_estimate,
            j.t_actual, j.n_min, j.notice_kind.value, j.notice_time, j.est_arrival)


def test_shed_oldest_inference_spares_training():
    def case(P):
        aq = P.service.AdmissionQueue(maxsize=3, backpressure="shed-oldest-inference")
        first = aq.submit_inference(2, 60.0)
        aq.submit_training(4, 100.0)
        aq.submit_inference(2, 60.0, submit_time=1.0)
        aq.submit_inference(2, 60.0, submit_time=2.0)
        assert aq.counts == {"submitted": 4, "shed": 1, "rejected": 0, "blocked": 0}
        drained = aq.drain()
        assert first not in drained and len(drained) == 3
        return [_spec(j) for j in drained]
    both(case)


def test_shed_policy_rejects_when_nothing_sheddable():
    def case(P):
        aq = P.service.AdmissionQueue(maxsize=1, backpressure="shed-oldest-inference")
        aq.submit_training(4, 100.0)
        with pytest.raises(P.service.AdmissionRejected):
            aq.submit_training(4, 100.0)
        assert aq.counts["rejected"] == 1
        return aq.counts
    both(case)


def test_reject_policy_raises_at_capacity():
    def case(P):
        aq = P.service.AdmissionQueue(maxsize=2, backpressure="reject")
        aq.submit_rigid(2, 50.0)
        aq.submit_rigid(2, 50.0)
        with pytest.raises(P.service.AdmissionRejected):
            aq.submit_rigid(2, 50.0)
        assert aq.counts == {"submitted": 2, "shed": 0, "rejected": 1, "blocked": 0}
        return aq.counts
    both(case)


def test_block_policy_waits_for_drain():
    def case(P):
        aq = P.service.AdmissionQueue(maxsize=1, backpressure="block")
        aq.submit_rigid(2, 50.0)
        unblocked = threading.Event()

        def producer():
            aq.submit_rigid(2, 60.0)
            unblocked.set()

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        time.sleep(0.05)
        assert not unblocked.is_set()
        drained = aq.drain()
        assert len(drained) == 1
        assert unblocked.wait(2.0)
        th.join(2.0)
        assert not th.is_alive()
        assert aq.counts["blocked"] == 1 and aq.counts["submitted"] == 2
        assert len(aq) == 1
        return aq.counts, [_spec(j) for j in drained + aq.drain()]
    both(case)


def test_block_policy_timeout_rejects():
    def case(P):
        aq = P.service.AdmissionQueue(maxsize=1, backpressure="block")
        spec = aq.submit_rigid(2, 50.0)
        with pytest.raises(P.service.AdmissionRejected):
            aq.put(spec, timeout=0.05)
        assert aq.counts["rejected"] == 1
        return aq.counts
    both(case)


def test_live_report_carries_admission_counts():
    def case(P):
        aq = P.service.AdmissionQueue(maxsize=64)
        svc = P.service.SchedulerService(P.service.ServiceConfig(n_nodes=16, speed=1e6), [])
        aq.submit_rigid(2, 50.0)
        aq.submit_training(4, 100.0, submit_time=10.0)
        aq.close()
        rep = svc.run_live(aq)
        assert rep.admission_counts is not None
        assert rep.admission_counts["submitted"] == 2 and rep.n_jobs == 2
        return rep.admission_counts, rep.n_jobs, rep.digest
    both(case)
