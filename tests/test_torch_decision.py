"""The port's decision sweep (`repro_torch.core.decision_torch`) against the
numpy kernels and the JAX package's `decision_jax`, on the CPU.

In float64 every port kernel must equal numpy's `repro.core.decision`
exactly (the same IEEE expressions, the same stable sort order), subnormal
inputs included; it must equal `decision_jax` exactly wherever the JAX
kernels do not flush a subnormal input to zero (ROADMAP queue 3), which
numpy draws from the ranges below never produce.  In float32 the
reference's contract holds: `t_shadow` within FLOAT32_RTOL, discrete
outputs by their invariants.  The batched program is held to the
reference's `_sweep_program_jit` output for output on the same numpy
batches, and the port's `Experiment(device="torch")` to the reference's
`Experiment(device="jax")` report and metrics.

The hypothesis tests draw without the example database and derandomized,
so each run draws the same examples and counts the same passes.
"""
import json
import math
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import decision as D  # noqa: E402
from repro.core import decision_jax as J  # noqa: E402
from repro.core.experiment import Experiment as JExperiment  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core.policy import registered_mechanisms as jregistered_mechanisms  # noqa: E402
from repro.core.workloads import WorkloadConfig as JWorkloadConfig  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro_torch.core import Experiment, WorkloadConfig, registered_mechanisms  # noqa: E402
from repro_torch.core import decision as PD  # noqa: E402
from repro_torch.core import decision_torch as T  # noqa: E402
from test_torch_live_cluster import hide_reference_test_policies  # noqa: E402

# test_decision_jax.py's pad lengths and seeds
SIZES = (0, 1, 2, 3, 7, 16)
SEEDS = range(4)
CPU = dict(device="cpu")
SUBNORMAL_NOW = 2.225073858507e-311


def _same_shadow(a, b):
    return (a == b) or (math.isinf(a[0]) and math.isinf(b[0]) and a[1] == b[1])


# ---------------------------------------------------- single calls, exact
@pytest.mark.parametrize("seed", SEEDS)
def test_easy_shadow_equals_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    for n in SIZES:
        for _ in range(8):
            avail = int(rng.integers(0, 50))
            need = int(rng.integers(1, 60))
            bases = rng.uniform(0.0, 100.0, n)
            sizes = rng.integers(1, 20, n)
            now = float(rng.uniform(0.0, 50.0))
            got = T.easy_shadow_torch(avail, need, bases, sizes, now, **CPU)
            assert _same_shadow(D.easy_shadow(avail, need, bases, sizes, now), got)
            assert _same_shadow(J.easy_shadow_jax(avail, need, bases, sizes, now), got)


@pytest.mark.parametrize("seed", SEEDS)
def test_victims_equal_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    for n in SIZES:
        for _ in range(8):
            sizes = rng.integers(1, 20, n)
            over = rng.uniform(0.0, 100.0, n)
            need = int(rng.integers(0, 80))
            got = T.select_preemption_victims_torch(sizes, over, need, **CPU)
            assert got == D.select_preemption_victims(sizes, over, need)
            assert got == J.select_preemption_victims_jax(sizes, over, need)


@pytest.mark.parametrize("seed", SEEDS)
def test_apportion_equals_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    for n in SIZES:
        for _ in range(8):
            mn = rng.integers(0, 10, n)
            cur = mn + rng.integers(0, 20, n)
            need = int(rng.integers(0, 60))
            got = T.apportion_shrink_torch(cur, mn, need, **CPU)
            assert got == D.apportion_shrink(cur, mn, need)
            assert got == J.apportion_shrink_jax(cur, mn, need)


@pytest.mark.parametrize("seed", SEEDS)
def test_backfill_filters_equal_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    for n in SIZES:
        for _ in range(6):
            needs = np.where(rng.random(n) < 0.2, np.inf,
                             rng.integers(1, 30, n).astype(float))
            bound = float(rng.integers(0, 40))
            got = T.backfill_prefilter_torch(needs, bound, **CPU)
            assert np.array_equal(got, D.backfill_prefilter(needs, bound))
            assert np.array_equal(got, J.backfill_prefilter_jax(needs, bound))
    for k in SIZES:
        N = max(k, 1) + 3
        needs = rng.integers(1, 30, N).astype(float)
        ests = rng.uniform(0.0, 100.0, N)
        cand = np.sort(rng.choice(N, size=k, replace=False))
        budget = int(rng.integers(0, 40))
        now = float(rng.uniform(0.0, 50.0))
        ts = float(rng.uniform(0.0, 150.0))
        got = T.backfill_shadow_filter_torch(needs, ests, cand, budget, now, ts, **CPU)
        assert np.array_equal(got, D.backfill_shadow_filter(needs, ests, cand, budget, now, ts))
        assert np.array_equal(
            got, J.backfill_shadow_filter_jax(needs, ests, cand, budget, now, ts))


# -------------------------------------------------------------- boundaries
def test_easy_shadow_boundaries():
    assert T.easy_shadow_torch(5, 3, [], [], 7.0, **CPU) == (7.0, 2)
    assert T.easy_shadow_torch(3, 3, [], [], 0.0, **CPU) == (0.0, 0)
    t, extra = T.easy_shadow_torch(0, 1, [], [], 0.0, **CPU)
    assert math.isinf(t) and extra == 0
    assert T.easy_shadow_torch(0, 30, [5.0, 9.0], [10, 20], 0.0, **CPU) == (9.0, 0)
    # tied est-ends accumulate in ascending-size order
    assert T.easy_shadow_torch(0, 5, [7.0, 7.0], [20, 10], 0.0, **CPU) == (7.0, 5)


def test_easy_shadow_subnormal_now_is_numpys():
    # numpy keeps the subnormal; easy_shadow_jax flushes it to (0.0, 0)
    want = D.easy_shadow(0, 1, [0.0], [1], SUBNORMAL_NOW)
    assert want == (SUBNORMAL_NOW, 0)
    assert T.easy_shadow_torch(0, 1, [0.0], [1], SUBNORMAL_NOW, **CPU) == want


def test_victims_and_apportion_boundaries():
    assert T.select_preemption_victims_torch([], [], 0, **CPU) == ([], 0)
    assert T.select_preemption_victims_torch([100, 100], [1.0, 2.0], 100, **CPU) == ([0], 0)
    assert T.select_preemption_victims_torch([10, 20], [1.0, 2.0], 31, **CPU) == ([], 0)
    assert T.apportion_shrink_torch([10, 8], [4, 6], 8, **CPU) == [6, 2]
    assert T.apportion_shrink_torch([10, 10], [10, 10], 1, **CPU) == []
    assert T.apportion_shrink_torch([10, 10], [2, 2], 0, **CPU) == [0, 0]


@pytest.mark.parametrize("cur, need", [
    ([65045927626, 68844673057], 52072923076),
    ([26978671376, 4097352393, 1652763552, 81327023920, 91275557727],
     124561354304),
])
def test_apportion_overflow_regression(cur, need):
    # need * max(slack) overflows int64: the guarded quota branch, and the
    # float64 division of an int64 product where it does not
    got = T.apportion_shrink_torch(cur, [0] * len(cur), need, **CPU)
    assert got == D.apportion_shrink(cur, [0] * len(cur), need)
    assert got == J.apportion_shrink_jax(cur, [0] * len(cur), need)
    assert sum(got) == need


def test_apportion_large_slack_divides_in_float64():
    # exact only if the int64 quotient is formed in float64, not in
    # torch's default float32
    cur, need = [2**40 + 3, 2**40 - 5, 7], 2**40 + 1
    assert T.apportion_shrink_torch(cur, [0, 0, 0], need, **CPU) == \
        D.apportion_shrink(cur, [0, 0, 0], need)


# ------------------------------------------------------- float32 fallback
def test_float32_shadow_within_documented_tolerance():
    rng = np.random.default_rng(7)
    for _ in range(20):
        n = int(rng.choice([c for c in SIZES if c]))
        avail = int(rng.integers(0, 30))
        need = int(rng.integers(1, 50))
        bases = rng.uniform(0.0, 100.0, n)
        sizes = rng.integers(1, 20, n)
        now = float(rng.uniform(0.0, 50.0))
        ref_t, _ = D.easy_shadow(avail, need, bases, sizes, now)
        got_t, _ = T.easy_shadow_torch(avail, need, bases, sizes, now,
                                       dtype="float32", **CPU)
        if math.isinf(ref_t):
            assert math.isinf(got_t)
        else:
            assert abs(got_t - ref_t) <= T.FLOAT32_RTOL * max(abs(ref_t), 1.0)


def test_float32_apportion_invariants_hold():
    rng = np.random.default_rng(11)
    for _ in range(20):
        n = int(rng.choice([c for c in SIZES if c]))
        mn = rng.integers(0, 10, n)
        cur = mn + rng.integers(0, 20, n)
        slack = np.maximum(cur - mn, 0)
        supply = int(slack.sum())
        if supply == 0:
            continue
        need = int(rng.integers(1, supply + 1))
        got = T.apportion_shrink_torch(cur, mn, need, dtype="float32", **CPU)
        assert sum(got) == need
        assert all(0 <= g <= s for g, s in zip(got, slack))


def test_bad_dtype_rejected():
    with pytest.raises(ValueError, match="dtype"):
        T.easy_shadow_torch(1, 1, [], [], 0.0, dtype="bfloat16", **CPU)


# ----------------------------------------------------- hypothesis parity
@given(st.integers(0, 64), st.integers(1, 128),
       st.lists(st.tuples(st.floats(0, 1e4), st.integers(1, 32)),
                min_size=0, max_size=16),
       st.floats(0, 1e4))
@example(0, 1, [(0.0, 1)], SUBNORMAL_NOW)
@settings(max_examples=60, deadline=None, database=None, derandomize=True)
def test_hyp_easy_shadow_equals_numpy(avail, need, jobs, now):
    jobs = jobs + [(math.inf, 0)] * (16 - len(jobs))
    bases = [j[0] for j in jobs]
    sizes = [j[1] for j in jobs]
    assert _same_shadow(D.easy_shadow(avail, need, bases, sizes, now),
                        T.easy_shadow_torch(avail, need, bases, sizes, now, **CPU))


@given(st.lists(st.integers(0, 10**11), min_size=8, max_size=8), st.data())
@settings(max_examples=60, deadline=None, database=None, derandomize=True)
def test_hyp_apportion_equals_numpy_any_scale(slacks, data):
    need = data.draw(st.integers(0, sum(slacks)))
    assert T.apportion_shrink_torch(slacks, [0] * 8, need, **CPU) == \
        D.apportion_shrink(slacks, [0] * 8, need)


# ------------------------------------------ the grid: all 13 mechanisms
GRID = dict(seeds=(0, 1), processes=0, device_capture=32)
MIXES = ("W1", "W4")


@pytest.fixture(scope="module")
def grids():
    """The same grid through the reference (device="jax") and the port
    (device="torch" on the CPU), over every built-in mechanism."""
    with pytest.MonkeyPatch.context() as mp:
        hide_reference_test_policies(mp)
        ref = JExperiment(mechanisms=jregistered_mechanisms(),
                          workloads=[JWorkloadConfig(n_jobs=40, notice_mix=m)
                                     for m in MIXES],
                          device="jax", **GRID).run()
    port = Experiment(mechanisms=registered_mechanisms(),
                      workloads=[WorkloadConfig(n_jobs=40, notice_mix=m) for m in MIXES],
                      device="torch", sweep_device="cpu", **GRID).run()
    return ref, port


def _cells(result):
    return [(f"{r.spec.mechanism}/{r.spec.workload.notice_mix}/s{r.spec.seed}",
             r.decision_trace) for r in result.runs]


def test_experiment_report_and_metrics_equal_the_references(grids, monkeypatch):
    ref, port = grids
    hide_reference_test_policies(monkeypatch)
    assert registered_mechanisms() == jregistered_mechanisms()
    a, b = port.device_report, ref.device_report
    assert a.n_cells == b.n_cells == len(registered_mechanisms()) * len(MIXES) * 2
    for name in ("n_cells", "n_calls", "calls_per_kernel", "pad_per_kernel",
                 "n_dropped", "parity_ok"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.parity_ok and a.n_mismatches == 0 and a.n_programs == 1
    assert set(a.calls_per_kernel) == set(PD.DecisionTrace.KERNELS)
    assert json.dumps([r.metrics.as_dict() for r in port]) == \
        json.dumps([r.metrics.as_dict() for r in ref])


def _same_call(a, b):
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same_call(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and (a == b or (a != a and b != b))


def test_captured_traces_equal_the_references_call_for_call(grids):
    ref, port = grids
    for (label, t), (jlabel, jt) in zip(_cells(port), _cells(ref)):
        assert label == jlabel
        assert t.n_dropped == jt.n_dropped
        for kernel in PD.DecisionTrace.KERNELS:
            assert len(t.calls[kernel]) == len(jt.calls[kernel]), (label, kernel)
            for ci, (call, jcall) in enumerate(zip(t.calls[kernel], jt.calls[kernel])):
                assert _same_call(call, jcall), (label, kernel, ci)


@pytest.mark.parametrize("dtype", ("float64", "float32"))
def test_sweep_program_equals_the_references_jit(grids, dtype):
    ref, _ = grids
    batches, _index, _pads = J._build_batches(_cells(ref), dtype)
    assert set(batches) == set(PD.DecisionTrace.KERNELS)
    with kops.enable_x64(dtype == "float64"):
        want = jax.device_get(J._sweep_program_jit(
            jax.tree_util.tree_map(jax.numpy.asarray, batches)))
    got = T.to_numpy(T._sweep_program(T.to_device(batches, "cpu")))
    assert set(got) == set(want)
    for kernel, outs in want.items():
        outs = outs if isinstance(outs, tuple) else (outs,)
        mine = got[kernel] if isinstance(got[kernel], tuple) else (got[kernel],)
        assert len(mine) == len(outs)
        for x, y in zip(mine, outs):
            assert np.array_equal(x, np.asarray(y)), kernel


def test_float32_sweep_meets_the_invariants(grids):
    _, port = grids
    rep = T.run_device_sweep(_cells(port), dtype="float32", device="cpu")
    assert rep.parity_ok, rep.mismatches[:5]
    assert rep.n_calls == port.device_report.n_calls


def test_sweep_device_default_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default replays on it")
    exp = Experiment(mechanisms=("BASE",), workloads=[WorkloadConfig(n_jobs=10)],
                     processes=0, device="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_device_sweep([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.easy_shadow_torch(1, 1, [], [], 0.0)


def test_device_jax_is_refused_by_the_port():
    exp = Experiment(mechanisms=("BASE",), workloads=[WorkloadConfig(n_jobs=10)],
                     processes=0, device="jax")
    with pytest.raises(ValueError, match="'torch'"):
        exp.run()


def test_padding_sorts_after_a_valid_infinite_end():
    # one batch, rows of 2 and 3 lanes: the shorter row's padded lane must
    # not sort between its valid lanes where a valid end is +inf
    with PD.capture() as tr:
        PD.easy_shadow(0, 15, [5.0, math.inf], [10, 10], 0.0)
        PD.easy_shadow(0, 2, [1.0, 2.0, 3.0], [1, 1, 1], 0.0)
    assert tr.calls["easy_shadow"][0][1] == (math.inf, 5)
    rep = T.run_device_sweep([("cell0", tr)], device="cpu")
    assert rep.parity_ok, rep.mismatches
    assert rep.pad_per_kernel == {"easy_shadow": 3}


def test_capture_trace_survives_pickle():
    with PD.capture(limit=4) as tr:
        PD.easy_shadow(5, 3, [], [], 7.0)
        PD.apportion_shrink([4, 4], [1, 1], 3)
    tr2 = pickle.loads(pickle.dumps(tr))
    assert tr2.n_calls() == tr.n_calls() == 2
    rep = T.run_device_sweep([("cell0", tr2)], device="cpu")
    assert rep.parity_ok and rep.n_calls == 2
