"""AdamW's work counts and its roofline reader, on the CPU: the compulsory
bytes by hand, the elements read from the program's counter, and nothing
read from a record whose program has no such counter or kernel (a program
without the kernels)."""
import pytest

from perfbench import harness, readers
from perfbench.kernels import adamw

OLMOE = harness.cell("olmoe-train").model
ZAMBA2 = harness.cell("zamba2-train").model


def test_adamw_counts_match_hand_counts():
    # bf16 g read twice, bf16 p read and written, f32 m and v read and written
    assert adamw.cost(10, 2) == (180, 10 * (2 * 2 + 2 * 2 + 4 * 4))
    # f32 gradients beside bf16 params (microbatch accumulation)
    assert adamw.cost(10, 2, 4) == (180, 10 * (2 * 4 + 2 * 2 + 16))


@pytest.mark.parametrize("model", [OLMOE, ZAMBA2], ids=["olmoe", "zamba2"])
def test_calls_read_the_element_counter(model):
    assert model["param_dtype"] == "bfloat16"
    unit = {"B": 8, "S": 2048, "launches": {"adamw": 15, "adamw_elems": 3_562_604_544}}
    assert adamw.calls(model, unit, 15) == [(1, *adamw.cost(3_562_604_544, 2))]
    assert adamw.calls(model, {"B": 8, "S": 2048, "launches": {"adamw": 0}}, 0) == []


def _record(kernel_s, launches):
    return {"device_kind": "NVIDIA H100 80GB HBM3", "model": OLMOE, "reference": "olmoe_lm",
            "trace": {"kernel_s": kernel_s, "busy_s": 1.0, "window_s": 1.0,
                      "units": [{"B": 8, "S": 2048, "launches": launches}] * 2}}


def test_roofline_on_a_record():
    n = 3_562_604_544
    rec = _record({"adamw_sumsq_kernel": 6e-3, "adamw_norm_finish_kernel": 1e-5,
                   "adamw_update_kernel": 2.5e-2}, {"adamw": 15, "adamw_elems": n})
    bound = 2 * 24 * n / 3.35e12
    assert readers.roofline(rec, "adamw") == pytest.approx(100 * bound / (6e-3 + 1e-5 + 2.5e-2))
    assert harness.metric_reader("adamw_roofline.train").read(rec) == pytest.approx(
        100 * bound / (6e-3 + 1e-5 + 2.5e-2))


def test_a_program_without_the_kernels_reads_nothing():
    rec = _record({"vectorized_elementwise_kernel": 0.6}, {"expert_mm": 48})
    assert harness.metric_reader("adamw_roofline.train").read(rec) is None
