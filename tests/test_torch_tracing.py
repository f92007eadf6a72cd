"""The port's spans and counters (`repro_torch.tracing`) on the CPU.

Off (no profiler session), a training step records nothing, enters no
profiler record and creates no CUDA event.  Under `torch.profiler`, two
`ElasticJob` steps of a reduced hybrid config with nested activation
checkpointing give the span tree, each span's step, the recomputation the
nesting implies (each grouped Mamba-2 layer runs forward three times a step,
each tail layer and each shared-block application twice) and ten host syncs
a step; `ServeEngine.serve_batch` on a reduced MoE config gives the serving
and MoE spans.  Only the spans whose device time a metric reads record CUDA
events.  Every span is an ordinary CPU operation of the profiler's trace
(not a user annotation) whose interval holds its children's.
"""
from collections import Counter, defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.runtime import ElasticJob  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.training import AdamW  # noqa: E402

# 2 groups of 2 Mamba-2 layers, each followed by the shared block, then 1 tail layer
HYBRID = reduced("zamba2_1p2b").with_(n_layers=5, attn_every=2, remat="full")
GROUPS, GROUPED, TAIL = 2, 4, 1
STEPS = 2


def _job():
    job = ElasticJob(0, HYBRID, batch=2, seq=32, opt=AdamW(warmup=2, total_steps=20), seed=3)
    job.start(["cpu"])
    return job


def _profiled(fn):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = defaultdict(list)
    for e in prof.events():
        events[e.name].append(e)
    return tracing.spans(), events


@pytest.fixture(scope="module")
def train_trace():
    job = _job()
    job.step()                       # outside the profiler: recorded nowhere
    spans, events = _profiled(lambda: [job.step() for _ in range(STEPS)])
    return spans, events


@pytest.fixture(scope="module")
def serve_trace():
    cfg = reduced("olmoe_1b_7b")
    eng = ServeEngine(cfg, init_params(cfg, seed=0, device="cpu"), max_seq=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=7 + i, prompt=rng.integers(1, cfg.vocab, 16 + 4 * i).astype(np.int32),
                    max_new_tokens=3) for i in range(2)]
    spans, events = _profiled(lambda: eng.serve_batch(reqs))
    return spans, events


class _Spy:
    def __init__(self):
        self.calls = 0

    def __call__(self, *a, **k):
        self.calls += 1
        raise AssertionError("entered while tracing is off")


def test_off_records_nothing_and_enters_no_record_or_event(monkeypatch):
    job = _job()
    record, event, stream = _Spy(), _Spy(), _Spy()
    monkeypatch.setattr(tracing, "_Record", record)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    tracing.reset()
    assert tracing.span("x") is tracing.span("y", a=1)     # the shared no-op context
    job.step()
    tracing.count("host_syncs")
    assert record.calls == event.calls == stream.calls == 0 and tracing.spans() == []


class _Event:
    """A stand-in for a timing CUDA event on the CPU."""
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded = False
        _Event.made.append(self)

    def record(self, stream):
        assert stream == "the current stream"
        self.recorded = True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        assert self.recorded and end.recorded
        return 2.5


def _fake_cuda(monkeypatch):
    _Event.made = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "the current stream")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)


def test_on_a_span_times_its_device_edges_with_cuda_events(monkeypatch):
    _fake_cuda(monkeypatch)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", device_time=True, step=4):
            with tracing.span("inner"):
                tracing.count("n", 2)
                tracing.count("n")
    inner, outer = tracing.spans()
    # only the span that asked for its device time recorded events
    assert len(_Event.made) == 2 and outer["device_ms"] == 2.5 and inner["device_ms"] is None
    assert (inner["name"], inner["parent"], inner["step"]) == ("inner", outer["id"], 4)
    assert inner["counts"] == {"n": 3} and outer["counts"] == {} and outer["parent"] is None
    assert outer["attrs"] == {"step": 4} and not inner["in_backward"]
    assert outer["host_ms"] >= inner["host_ms"] >= 0
    tracing.reset()
    assert tracing.spans() == []


def test_the_span_tree_of_a_step(train_trace):
    spans, _ = train_trace
    by_id = {s["id"]: s for s in spans}
    steps = [s for s in spans if s["name"] == "runtime.step"]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(s["attrs"] == {"jid": 0, "step": s["step"]} for s in steps)
    assert all(s["jid"] == 0 for s in spans)
    children = defaultdict(list)
    for s in spans:
        if s["parent"] is not None:
            children[by_id[s["parent"]]["name"], s["step"]].append(s["name"])
    for k in (1, 2):
        assert children["runtime.step", k] == ["runtime.batch", "training.step", "runtime.sync"]
        assert children["training.step", k] == ["training.forward", "training.backward",
                                                "training.optimizer"]
    # every span belongs to one of the two steps (the unprofiled first step left none)
    assert {s["step"] for s in spans} == {1, 2}
    assert all(s["device_ms"] is None for s in spans)        # no CUDA on the CPU


def test_recomputation_counts_of_nested_checkpoints(train_trace):
    spans, _ = train_trace
    for k in (1, 2):
        n = Counter((s["name"], s["in_backward"]) for s in spans if s["step"] == k)
        assert n["models.mamba2", False] == GROUPED + TAIL
        assert n["models.mamba2", True] == GROUPED * 2 + TAIL
        assert n["models.block", False] == GROUPS
        assert n["models.block", True] == GROUPS
    backward = {s["id"] for s in spans if s["name"] == "training.backward"}
    forward = {s["id"] for s in spans if s["name"] == "training.forward"}
    for s in spans:
        if s["name"] in ("models.mamba2", "models.block"):
            # on the CPU autograd runs the backward pass on the calling thread
            assert s["parent"] in (backward if s["in_backward"] else forward)


def test_six_host_syncs_a_step(train_trace):
    # the six values read back and the batch's two copies to the device; the
    # optimizer makes its scalars on the device and waits for nothing
    spans, _ = train_trace
    for k in (1, 2):
        syncs = {s["name"]: s["counts"] for s in spans if s["step"] == k and s["counts"]}
        assert syncs == {"runtime.batch": {"host_syncs": 2},
                         "runtime.sync": {"host_syncs": 6}}


def test_serving_spans_share_the_batch_rids(serve_trace):
    spans, _ = serve_trace
    by_id = {s["id"]: s for s in spans}
    (batch,) = [s for s in spans if s["name"] == "serving.batch"]
    assert batch["attrs"] == {"rids": [7, 8]} and batch["parent"] is None
    top = [s for s in spans if s["parent"] == batch["id"]]
    assert [s["name"] for s in top] == ["serving.prefill", "serving.decode_step",
                                        "serving.decode_step"]
    S = 20
    assert [s["attrs"] for s in top[1:]] == [{"pos": S}, {"pos": S + 1}]
    # the prompt's copy and the first tokens read, then one read a decode step
    assert [s["counts"] for s in top] == [{"host_syncs": 2}] + [{"host_syncs": 1}] * 2
    cfg = reduced("olmoe_1b_7b")
    moe = Counter(s["name"] for s in spans if s["name"].startswith("models.moe."))
    n_moe = (cfg.n_layers - cfg.moe.first_dense) * len(top)
    assert moe == {f"models.moe.{p}": n_moe for p in ("route", "dispatch", "experts",
                                                      "combine")}

    def root(s):
        while s["parent"] is not None:
            s = by_id[s["parent"]]
        return s
    assert all(root(s) is batch for s in spans)


def test_device_events_only_where_a_metric_reads_them(monkeypatch):
    # a step's training spans and its recomputed layers record device edges;
    # its runtime spans and the layers' first forwards do not, nor does serving
    job = _job()
    job.step()
    _fake_cuda(monkeypatch)
    spans, _ = _profiled(job.step)
    timed = Counter(s["name"] for s in spans if s["device_ms"] is not None)
    assert timed == {"training.step": 1, "training.forward": 1, "training.backward": 1,
                     "training.optimizer": 1, "models.mamba2": GROUPED * 2 + TAIL,
                     "models.block": GROUPS}
    assert all(s["in_backward"] for s in spans
               if s["name"].startswith("models.") and s["device_ms"] is not None)
    assert len(_Event.made) == 2 * sum(timed.values())
    cfg = reduced("olmoe_1b_7b")
    eng = ServeEngine(cfg, init_params(cfg, seed=0, device="cpu"), max_seq=32, device="cpu")
    _Event.made = []
    spans, _ = _profiled(lambda: eng.serve_batch(
        [Request(rid=1, prompt=np.arange(1, 9, dtype=np.int32), max_new_tokens=3)]))
    assert len(spans) > 1 and _Event.made == []


def test_attrs_of_a_decorated_function_are_read_only_while_tracing(monkeypatch):
    seen = []

    @tracing.spanned("f", attrs=lambda a, b=0: seen.append(a) or {"a": a})
    def f(a, b=0):
        return a + b

    tracing.reset()
    assert f(1, b=2) == 3 and seen == [] and tracing.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert f(4, b=1) == 5
    (s,) = tracing.spans()
    assert seen == [4] and (s["name"], s["attrs"]) == ("f", {"a": 4})
    assert f.__name__ == "f"


@pytest.mark.parametrize("trace", ["train_trace", "serve_trace"])
def test_every_span_is_a_cpu_operation_holding_its_children(trace, request):
    spans, events = request.getfixturevalue(trace)
    by_name = defaultdict(list)
    for s in spans:
        by_name[s["name"]].append(s)
    event_of = {}
    for name, ss in by_name.items():
        evs = sorted(events[name], key=lambda e: e.time_range.start)
        assert len(evs) == len(ss), name
        for s, e in zip(sorted(ss, key=lambda s: s["id"]), evs):
            assert not e.is_user_annotation and e.device_type.name == "CPU"
            event_of[s["id"]] = e
    for s in spans:
        if s["parent"] is not None:
            c, p = event_of[s["id"]].time_range, event_of[s["parent"]].time_range
            assert p.start <= c.start and c.end <= p.end, s["name"]
