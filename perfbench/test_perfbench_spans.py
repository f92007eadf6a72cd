"""The six readers of the program's spans on a made-up span list: two traced
steps, with a span of an untraced step that no reader may count, and None
for an empty list or device times that were not recorded.  Two jobs at the
same step index are two steps."""
import pytest

from perfbench import harness, spans


def _span(name, step, device_ms=None, host_ms=0.0, in_backward=False, counts=None, jid=0):
    return {"name": name, "id": 0, "parent": None, "thread": 1, "jid": jid, "step": step,
            "in_backward": in_backward, "host_ms": host_ms, "device_ms": device_ms,
            "attrs": {}, "counts": counts or {}}


def _made_up():
    out = []
    for k, scale in ((5, 1.0), (6, 3.0)):
        out += [_span("runtime.step", k),
                _span("runtime.batch", k, 0.1, host_ms=0.5 * scale),
                _span("training.forward", k, 20.0 * scale),
                _span("training.backward", k, 60.0 * scale),
                _span("training.optimizer", k, 10.0 * scale),
                _span("models.mamba2", k, 2.0 * scale),
                _span("models.mamba2", k, 3.0 * scale, in_backward=True),
                _span("models.block", k, 4.0 * scale, in_backward=True),
                _span("models.block", k, 1.0 * scale),
                _span("runtime.sync", k, counts={"host_syncs": 6})]
    # a span outside the traced steps (no runtime.step of step 9)
    out.append(_span("training.forward", 9, 1000.0, counts={"host_syncs": 3}))
    return out


EXPECTED = {"forward_ms.train": 40.0, "backward_ms.train": 120.0,
            "optimizer_ms.train": 20.0, "recompute_ms.train": 14.0,
            "batch_ms.train": 1.0, "host_syncs.train": 6.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_means_over_the_traced_steps(name):
    mod = harness.metric_reader(name)
    assert mod.value(_made_up()) == pytest.approx(EXPECTED[name])
    assert mod.value([]) is None
    # without runtime.step spans there is no traced step
    assert mod.value([s for s in _made_up() if s["name"] != "runtime.step"]) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_two_jobs_at_one_step_index_are_two_steps(name):
    # a second job's spans at the same step indices, each value the first's
    xs = _made_up()
    both = xs + [dict(s, jid=1) for s in xs]
    assert harness.metric_reader(name).value(both) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", ["forward_ms.train", "backward_ms.train",
                                  "optimizer_ms.train", "recompute_ms.train"])
def test_device_readers_give_none_without_device_times(name):
    xs = [dict(s, device_ms=None) for s in _made_up()]
    assert harness.metric_reader(name).value(xs) is None


def test_program_spans_reads_the_program(monkeypatch):
    from repro_torch import tracing
    made = [_span("runtime.step", 1)]
    monkeypatch.setattr(tracing, "spans", lambda: made)
    assert spans.program_spans() is made
    assert harness.metric_reader("host_syncs.train").read({}) == 0.0


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    import sys

    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)   # the import fails
    assert spans.program_spans() == []
    for name in EXPECTED:
        assert harness.metric_reader(name).read({}) is None
