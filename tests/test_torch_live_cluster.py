"""The port's copy of `LiveCluster`'s scheduling against the reference's.

Every case of `tests/test_live_cluster.py`, driven by the same duck-typed
fake jobs through `repro.runtime.LiveCluster` and through
`repro_torch.runtime.LiveCluster`.  Each run makes the reference test's own
assertions, and the two must leave equal state: the event log (without
`t`, which reads the monotonic clock), each job's status, nodes and
counters, the free pool, and the calls each fake job received.  The
reference's "import is jax-free" case becomes: importing
`repro_torch.runtime` loads neither jax nor torch, in a fresh interpreter.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core.policy as jpolicy  # noqa: E402
import repro.runtime as jruntime  # noqa: E402
import repro_torch.core.policy as tpolicy  # noqa: E402
import repro_torch.runtime as truntime  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
PKGS = (SimpleNamespace(name="repro", runtime=jruntime, policy=jpolicy),
        SimpleNamespace(name="repro_torch", runtime=truntime, policy=tpolicy))


def both(case, *args):
    """`case(P, *args)` for the reference, then for the port; their outputs
    must be equal.  Returns the port's."""
    ref, port = (case(P, *args) for P in PKGS)
    assert port == ref
    return port


class FakeElasticJob:
    """Duck-type of ElasticJob's scheduling surface."""

    def __init__(self, jid, kind="malleable", ckpt_every=50, ckpt_dir="/tmp/ckpt"):
        self.jid = jid
        self.kind = kind
        self.ckpt_every = ckpt_every
        self.ckpt_dir = ckpt_dir
        self.state = None
        self.step_idx = 0
        self.events = []

    def start(self, devices):
        self.state = object()
        self.events.append(("start", len(devices)))

    def resume(self, devices):
        self.events.append(("resume", len(devices)))

    def step(self):
        self.step_idx += 1
        return {}

    def preempt(self, warning=True):
        self.events.append(("preempt", warning))

    def resize(self, devices):
        self.events.append(("resize", len(devices)))
        return 0.01


def _cluster(P, n=8, **kw):
    return P.runtime.LiveCluster([f"dev{i}" for i in range(n)], **kw)


def _state(c):
    """What a cluster did: its log without `t`, every job's placement and
    counters, the free pool, and each job's calls."""
    return ([{k: v for k, v in row.items() if k != "t"} for row in c.log],
            {jid: (i.status, list(i.node_ids), i.steps_done, i.preempt_count,
                   i.shrink_count, list(i.job.events)) for jid, i in c.jobs.items()},
            list(c.free), c.arrival_policy, c.elasticity_policy)


def test_import_loads_neither_jax_nor_torch():
    """Importing the port's LiveCluster pulls in no jax and no torch (the
    scheduler layer is plain Python); checked in a fresh interpreter, as
    this one has both loaded."""
    code = ("import sys; from repro_torch.runtime import LiveCluster; "
            "bad = [m for m in ('jax', 'torch', 'repro') if m in sys.modules]; "
            "sys.exit(str(bad) if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env={**os.environ, "PYTHONPATH": SRC},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_unknown_policies_raise():
    def case(P):
        msgs = []
        for kw in ({"arrival_policy": "NOPE"}, {"elasticity_policy": "NADA"}):
            with pytest.raises(P.policy.UnknownPolicyError) as e:
                _cluster(P, **kw)
            msgs.append(str(e.value))
        return msgs
    both(case)


def test_default_policy_pairing():
    def case(P):
        assert _cluster(P).arrival_policy == "SPAA"
        assert _cluster(P).elasticity_policy == "NONE"
        c = _cluster(P, arrival_policy="STEAL")
        assert c.elasticity_policy == "BALANCE"
        c2 = _cluster(P, arrival_policy="PAA", elasticity_policy="BALANCE")
        assert (c2.arrival_policy, c2.elasticity_policy) == ("PAA", "BALANCE")
        return _state(_cluster(P)), _state(c), _state(c2)
    both(case)


def test_submit_starts_malleable_at_available_width():
    def case(P):
        c = _cluster(P, 8)
        info = c.submit(FakeElasticJob(1), min_nodes=2, max_nodes=6)
        assert info.status == "running" and len(info.node_ids) == 6
        info2 = c.submit(FakeElasticJob(2), min_nodes=3, max_nodes=4)
        assert info2.status == "waiting"
        assert c.utilization() == 6 / 8
        return _state(c)
    both(case)


def test_rigid_requires_full_width():
    def case(P):
        c = _cluster(P, 4)
        info = c.submit(FakeElasticJob(1, kind="rigid"), min_nodes=2, max_nodes=3)
        assert info.status == "running" and len(info.node_ids) == 3
        info2 = c.submit(FakeElasticJob(2, kind="rigid"), min_nodes=1, max_nodes=2)
        assert info2.status == "waiting"
        return _state(c)
    both(case)


def test_step_all_finishes_and_restarts_waiting():
    def case(P):
        c = _cluster(P, 4)
        a = c.submit(FakeElasticJob(1), min_nodes=2, max_nodes=4, target_steps=3)
        b = c.submit(FakeElasticJob(2), min_nodes=2, max_nodes=2, target_steps=3)
        assert (a.status, b.status) == ("running", "waiting")
        c.step_all(3)
        assert a.status == "done" and b.status == "running"
        assert len(c.free) == 2
        return _state(c)
    both(case)


def test_ondemand_from_free_pool_only():
    def case(P):
        c = _cluster(P, 8)
        c.submit(FakeElasticJob(1), min_nodes=2, max_nodes=4)
        got = c.acquire_for_ondemand(3)
        assert len(got) == 3 and len(c.free) == 1
        assert c.jobs[1].shrink_count == 0
        c.release_ondemand(got)
        assert len(c.free) == 4
        return list(got), _state(c)
    both(case)


def test_spaa_shrinks_then_lease_repays():
    def case(P):
        c = _cluster(P, 8)
        j = FakeElasticJob(1)
        c.submit(j, min_nodes=2, max_nodes=6)
        c.submit(FakeElasticJob(2, kind="rigid"), min_nodes=2, max_nodes=2)
        got = c.acquire_for_ondemand(4)
        assert len(got) == 4
        assert len(c.jobs[1].node_ids) == 2 and c.jobs[1].shrink_count == 1
        assert ("resize", 2) in j.events
        mid = _state(c)
        c.release_ondemand(got)
        assert len(c.jobs[1].node_ids) == 6 and ("resize", 6) in j.events
        assert c.jobs[1].preempt_count == 0
        return list(got), mid, _state(c)
    both(case)


def test_paa_fallback_preempts_ascending_overhead():
    def case(P):
        c = _cluster(P, 8)
        cheap = FakeElasticJob(1, kind="rigid", ckpt_every=5)
        dear = FakeElasticJob(2, kind="rigid", ckpt_every=5)
        c.submit(cheap, min_nodes=4, max_nodes=4, target_steps=100)
        c.submit(dear, min_nodes=4, max_nodes=4, target_steps=100)
        c.step_all(4)
        c.jobs[1].steps_done = 5
        got = c.acquire_for_ondemand(4)
        assert len(got) == 4
        assert c.jobs[1].status == "preempted" and c.jobs[2].status == "running"
        mid = _state(c)
        c.release_ondemand(got)
        assert c.jobs[1].status == "running"
        return list(got), mid, _state(c)
    both(case)


def test_acquire_failure_raises_without_side_effects():
    def case(P):
        c = _cluster(P, 4)
        with pytest.raises(ValueError) as e:
            c.acquire_for_ondemand(5)
        info = c.submit(FakeElasticJob(1), min_nodes=4, max_nodes=4)
        before = list(info.node_ids)
        got = c.acquire_for_ondemand(4)
        assert c.jobs[1].status == "preempted"
        c.release_ondemand(got)
        assert sorted(c.jobs[1].node_ids) == sorted(before)
        return str(e.value), list(got), _state(c)
    both(case)


def test_balance_elasticity_expands_on_idle():
    def case(P):
        c = _cluster(P, 8, arrival_policy="STEAL")
        c.submit(FakeElasticJob(1), min_nodes=2, max_nodes=8)
        got = c.acquire_for_ondemand(4)
        assert len(c.jobs[1].node_ids) == 4
        c.release_ondemand(got)
        assert len(c.jobs[1].node_ids) == 8
        c2 = _cluster(P, 8, arrival_policy="STEAL")
        c2.submit(FakeElasticJob(1), min_nodes=2, max_nodes=8, target_steps=50)
        got2 = c2.acquire_for_ondemand(2)
        c2.free.extend(got2)
        c2.submit(FakeElasticJob(2), min_nodes=2, max_nodes=2, target_steps=1)
        assert len(c2.jobs[1].node_ids) == 6
        c2.step_all(1)
        assert c2.jobs[2].status == "done"
        assert len(c2.jobs[1].node_ids) == 8 and len(c2.free) == 0
        return _state(c), _state(c2)
    both(case)


def test_event_log_uses_monotonic_relative_time():
    def case(P):
        c = _cluster(P, 4)
        c.submit(FakeElasticJob(1), min_nodes=2, max_nodes=4)
        assert c.started_wall > 1e9
        assert all(0.0 <= row["t"] < 60.0 for row in c.log)
        assert [r["event"] for r in c.log] == ["start"]
        return _state(c)
    both(case)


def test_utilization_tracks_running_nodes():
    def case(P):
        c = _cluster(P, 8)
        seen = [c.utilization()]
        c.submit(FakeElasticJob(1), min_nodes=2, max_nodes=4)
        seen.append(c.utilization())
        assert seen == [0.0, 0.5]
        return seen, _state(c)
    both(case)
