"""Per-rank counts of one traced step: matrix FLOPs and collective traffic.

The port's counterpart of `repro.launch.hlo_analysis`, under its name and
with its output keys (`dot_flops`, `conv_flops`, `collective_bytes`,
`collective_ops`).  The port has no HLO: it runs the step once, eagerly, on
fake tensors (no memory, no arithmetic) and reads the trace itself.

  * dot / conv FLOPs: `torch.utils.flop_counter`'s formulas (2 x the
    multiply-adds of every matrix product, batched product and convolution,
    forward and backward), each at the shapes one rank computes: a DTensor
    op is counted at its local shards, not at the global shape
    (`PerRankFlops`).
  * collectives: each functional collective that a DTensor redistribution
    or an explicit `funcol` call issues, by kind, with the bytes of its
    result (an all-reduce counted 2x, for its reduce and its broadcast
    halves, as the reference counts it), recorded by `CommDebugMode`
    (`Collectives`).

The reference multiplies the counts inside a `while` body by its trip
count (XLA counts a scanned layer stack once).  The port runs its layers
as a Python loop, so every layer is counted where it runs and no trip
count is needed: `while_trip_counts` has no counterpart.
"""
from __future__ import annotations

from collections import defaultdict

from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import FlopCounterMode

CONV_OPS = ("convolution", "_convolution", "convolution_backward")
COLLECTIVES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


class PerRankFlops(FlopCounterMode):
    """FlopCounterMode that counts the FLOPs one rank does: a DTensor op at
    its local shapes, ops on plain tensors (one device, or the body of a
    `local_map`) as they are.  The ops DTensor's sharding propagation runs
    on global-shaped fake tensors, under a fake mode of its own, to infer
    output shapes are not counted (as torch's MemTracker skips them)."""

    def __init__(self):
        super().__init__(display=False)

    def __enter__(self):
        self._entry_fake_mode = active_fake_mode()
        return super().__enter__()

    def _count_flops(self, func_packet, out, args, kwargs):
        if active_fake_mode() is self._entry_fake_mode:
            super()._count_flops(func_packet, tree_map(_local, out), tree_map(_local, args),
                                 tree_map(_local, kwargs))
        return out

    def by_kind(self) -> dict:
        """{"dot_flops", "conv_flops"} counted so far."""
        dot = conv = 0
        for op, n in self.get_flop_counts().get("Global", {}).items():
            if str(op).split(".")[-1] in CONV_OPS:
                conv += n
            else:
                dot += n
        return {"dot_flops": float(dot), "conv_flops": float(conv)}


class Collectives(CommDebugMode):
    """CommDebugMode that also records each functional collective's result
    bytes (one rank's), by kind."""

    def __init__(self):
        super().__init__()
        self.ops = defaultdict(lambda: {"count": 0, "bytes": 0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = getattr(func, "__name__", "").split(".")[0]
        if out is not NotImplemented and name in COLLECTIVES and \
                getattr(func, "namespace", "") in ("_c10d_functional", "c10d_functional"):
            kind = COLLECTIVES[name]
            nbytes = out.numel() * out.element_size() * (2 if kind == "all-reduce" else 1)
            self.ops[kind]["count"] += 1
            self.ops[kind]["bytes"] += int(nbytes)
        return out

    def summary(self) -> dict:
        """The reference's collective_stats shape: per kind {count, bytes},
        and total_bytes."""
        out = {k: dict(v) for k, v in self.ops.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.ops.values())
        return out


def analyze(fn, *args, **kwargs):
    """Run fn(*args, **kwargs) once under both counters (a plain tensor
    mixed with DTensors counts as replicated).  Returns (fn's output,
    {"dot_flops", "conv_flops", "collective_bytes", "collective_ops"},
    `Collectives.summary()`), every count one rank's."""
    from torch.distributed.tensor.experimental import implicit_replication

    with PerRankFlops() as flops, Collectives() as coll, implicit_replication():
        out = fn(*args, **kwargs)
    summary = coll.summary()
    counts = {**flops.by_kind(), "collective_bytes": float(summary["total_bytes"]),
              "collective_ops": {k: v["count"] for k, v in summary.items()
                                 if k != "total_bytes"}}
    return out, counts, summary
