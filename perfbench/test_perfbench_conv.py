"""The causal conv + SiLU's work counts and its two roofline readers, on the
CPU: the compulsory bytes and the multiply-adds by hand, the launches split
between a Mamba-2 layer's two convs, and nothing read from a record whose
program has no such counter or kernel (a program without the kernel)."""
import pytest

from perfbench import harness, readers
from perfbench.kernels import _conv

ZAMBA2 = harness.cell("zamba2-train").model


def test_conv_counts_match_hand_counts():
    # B 2, S 3, C 8, W 4, bf16: x and y are 48 elements each; taps 32, bias 8
    assert _conv.cost(2, 3, 8, 4, 2) == (2 * 4 * 48, 2 * (48 + 48 + 32 + 8))
    # backward: dy, x read and dx written; taps read, dw and dbias written
    assert _conv.cost(2, 3, 8, 4, 2, backward=True) == (2 * 4 * 48,
                                                        2 * (3 * 48 + 2 * 32 + 8))


@pytest.mark.parametrize("backward", [False, True])
def test_launches_split_between_the_layers_two_convs(backward):
    unit = {"B": 8, "S": 2048}
    got = _conv.calls(ZAMBA2, unit, 224, backward)
    widths = (ZAMBA2["ssm"]["expand"] * ZAMBA2["d_model"], 2 * ZAMBA2["ssm"]["d_state"])
    assert widths == (4096, 128)
    assert got == [(112, *_conv.cost(8, 2048, C, 4, 2, backward)) for C in widths]
    assert _conv.calls(ZAMBA2, unit, 0, backward) == []
    assert _conv.calls({"d_model": 64}, unit, 4, backward) == []


def _record(kernel_s, launches):
    return {"device_kind": "NVIDIA H100 80GB HBM3", "model": ZAMBA2, "reference": "hybrid_lm",
            "trace": {"kernel_s": kernel_s, "busy_s": 1.0, "window_s": 1.0,
                      "units": [{"B": 8, "S": 2048, "launches": launches}]}}


def test_rooflines_on_a_record():
    rec = _record({"causal_conv_fwd_kernel": 2e-2, "causal_conv_bwd_kernel": 1e-2,
                   "causal_conv_bwd_reduce": 1e-3},
                  {"causal_conv": 224, "causal_conv_bwd": 76})
    fwd = sum(n * b / 3.35e12 for n, _, b in _conv.calls(ZAMBA2, {"B": 8, "S": 2048}, 224))
    bwd = sum(n * b / 3.35e12 for n, _, b in _conv.calls(ZAMBA2, {"B": 8, "S": 2048}, 76,
                                                          backward=True))
    assert readers.roofline(rec, "conv_fwd") == pytest.approx(100 * fwd / 2e-2)
    assert readers.roofline(rec, "conv_bwd") == pytest.approx(100 * bwd / 1.1e-2)
    for name in ("conv_fwd_roofline.train", "conv_bwd_roofline.train"):
        assert harness.metric_reader(name).read(rec) > 0


def test_a_program_without_the_kernel_reads_nothing():
    rec = _record({"vectorized_elementwise_kernel": 0.7}, {"ssd_scan": 112})
    for name in ("conv_fwd_roofline.train", "conv_bwd_roofline.train"):
        assert harness.metric_reader(name).read(rec) is None
