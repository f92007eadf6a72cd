"""A bounded stretch of a run under `torch.profiler`, reduced to what the
metrics read.

`Stretch` profiles whole units of work (a served batch, a training step),
from a synchronised device to the device done with them, with the CPU and
CUDA activity; nothing is written to disk.  `reduce` turns the trace into:

  kernel_s    device seconds by kernel name (the function's own name, its
              namespaces and template arguments dropped), summed;
  busy_s      seconds in which any device operation ran: the length of the
              union of their intervals, so that operations overlapping on
              two streams count once;
  window_s    the stretch's length on the host's clock;
  device_ops  the ten kernel names with the most device time;
  idle_gaps   device idle time between operations, summed by what the host
              was doing at the gap's middle (the innermost CPU operation
              running then, or "host outside any operation"), the ten
              largest.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List

import torch


def kernel_name(key: str) -> str:
    """'void repro_torch::(anonymous namespace)::split_kernel<8>(...)' ->
    'split_kernel'."""
    key = key.replace("(anonymous namespace)::", "")
    name = key.split("(")[0].split("<")[0].split("::")[-1].strip()
    return name[len("void "):] if name.startswith("void ") else name


def union(intervals) -> List[List[float]]:
    """The disjoint, sorted intervals covering the given (start, end) ones."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Stretch:
    def __init__(self, device):
        self.device = device
        self.units: List[dict] = []
        self.prof = None
        self.wall_s = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> Dict:
        from torch.autograd import DeviceType
        dev, cpu = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                dev.append((tr.start, tr.end, kernel_name(e.name)))
            elif e.device_type == DeviceType.CPU:
                cpu.append((tr.start, tr.end, e.name))
        self.prof = None
        kernel_s: Dict[str, float] = {}
        for s, e, n in dev:
            kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) / 1e6
        merged = union([(s, e) for s, e, _ in dev])
        busy_s = sum(e - s for s, e in merged) / 1e6
        cpu.sort()
        starts = [c[0] for c in cpu]
        idle: Dict[str, float] = {}
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) / 2
            label = "host outside any operation"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 400, -1), -1):   # innermost: latest start
                if cpu[j][1] >= mid:
                    label = cpu[j][2]
                    break
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
        top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"kernel_s": kernel_s, "busy_s": busy_s, "window_s": self.wall_s,
                "device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps], "units": self.units,
                "n_device_ops": len(dev)}
