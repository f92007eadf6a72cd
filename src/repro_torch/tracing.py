"""Spans and counters at the port's layer boundaries, on the profiler's clock.

Tracing is on exactly while a `torch.profiler` session records; there is no
other switch.  Off, `span` returns one shared no-op context after that check
and `count` returns at once: neither creates a CUDA event nor enters a
profiler record.  On, a span

  * enters `torch._C._profiler._RecordFunctionFast(name)`, so it is a CPU
    operation in the profiler's trace, on its clock (an ordinary operation,
    not a user annotation: the profiler copies no event of it onto the
    device's timeline);
  * takes its host edges from `time.perf_counter_ns()`;
  * with `device_time=True` (or "backward": when opened in a backward pass
    alone), once CUDA is initialised in the process, records its device
    edges as two timing `torch.cuda.Event`s on the stream current when it
    opens: its device time is the stream's time between them, idle gaps
    included.  Only the spans whose device time a metric reads ask for it:
    the two events cost about 40 us of host time a span on an H100, which a
    host-paced loop pays in full.

Each finished span is kept in memory with its name, id, parent (the
innermost span open on the same thread, or None), thread, `jid` and `step`
(the attributes of the innermost span opened with a `step` attribute and
still open, on any thread: `runtime.step`), `in_backward` (opened while
autograd runs a backward pass: recomputation under activation
checkpointing), its attributes and its counts (`count` adds to the
innermost open span of its thread).  `spans()` returns them as plain
dicts, `reset()` drops them.

The spans (* device time, ** device time in a backward pass):

  runtime.step (jid, step) > runtime.batch [host_syncs],
                             runtime.sync [host_syncs]
  training.step* > training.forward*, training.backward*,
                   training.optimizer*
  models.mamba2**, models.block**, models.moe.{route,dispatch,experts,combine}
  (* on the dropless path alone)
  serving.batch (rids) > serving.prefill [host_syncs],
                         serving.decode_step (pos) [host_syncs]

`host_syncs` counts the calls at which the host waits for a CUDA device: a
blocking copy between host and device memory, or a device value read on the
host.  The call sites count whatever the device, so a CPU run counts what a
card's would.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Union

import torch

_enabled = torch._C._autograd._profiler_enabled
_graph_task = torch._C._current_graph_task_id
_Record = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()   # what `span` returns while tracing is off
_ids = itertools.count()
_local = threading.local()
_done: List["_Span"] = []
_stepper: Optional["_Span"] = None   # the innermost open span given a step


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "attrs", "device_time", "id", "parent", "thread", "jid", "step",
                 "in_backward", "counts", "t0", "t1", "stream", "ev", "device_ms",
                 "_record", "_outer")

    def __init__(self, name: str, device_time: Union[bool, str], attrs: Dict[str, Any]):
        self.name, self.device_time, self.attrs = name, device_time, attrs
        self.counts: Dict[str, int] = {}
        self.ev = None
        self.device_ms: Optional[float] = None

    def __enter__(self):
        global _stepper
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        self.in_backward = _graph_task() != -1
        self._outer = _stepper
        if "step" in self.attrs:
            _stepper = self
        self.jid = _stepper.attrs.get("jid") if _stepper is not None else None
        self.step = _stepper.attrs["step"] if _stepper is not None else None
        stack.append(self)
        self._record = _Record(self.name)
        self._record.__enter__()
        self.t0 = time.perf_counter_ns()
        timed = self.device_time is True or (self.device_time == "backward"
                                             and self.in_backward)
        if timed and torch.cuda.is_initialized():
            # the stream looked up once: each lookup costs as much host time
            # as recording an event
            self.stream = torch.cuda.current_stream()
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        global _stepper
        if self.ev is not None:
            self.ev[1].record(self.stream)
            self.stream = None
        self.t1 = time.perf_counter_ns()
        self._record.__exit__(*exc)
        self._record = None
        _stack().pop()
        if "step" in self.attrs:
            _stepper = self._outer
        self._outer = None
        _done.append(self)
        return False

    def as_dict(self) -> dict:
        if self.ev is not None:
            self.ev[1].synchronize()
            self.device_ms = self.ev[0].elapsed_time(self.ev[1])
            self.ev = None
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "thread": self.thread, "jid": self.jid, "step": self.step,
                "in_backward": self.in_backward, "host_ms": (self.t1 - self.t0) / 1e6,
                "device_ms": self.device_ms, "attrs": dict(self.attrs),
                "counts": dict(self.counts)}


def span(name: str, *, device_time: Union[bool, str] = False, **attrs):
    """A context that records a span named `name` while tracing is on (with
    `device_time`, its device edges too: True, or "backward" for a span
    opened in a backward pass alone)."""
    if not _enabled():
        return _OFF
    return _Span(name, device_time, attrs)


def spanned(name: str, *, device_time: Union[bool, str] = False,
            attrs: Optional[Callable[..., Dict[str, Any]]] = None):
    """Decorates a function so that each call is a span named `name`;
    `attrs`, called with the function's arguments while tracing is on
    only, gives the span's attributes."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with _Span(name, device_time, attrs(*args, **kwargs) if attrs else {}):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the count `name` of the innermost span open on this thread
    while tracing is on (nothing when none is open)."""
    if not _enabled():
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def spans() -> List[dict]:
    """Every finished span, in the order they closed, as plain dicts
    (`host_ms`; `device_ms`, None where no CUDA events were recorded)."""
    return [s.as_dict() for s in list(_done)]


def reset() -> None:
    """Drop the finished spans."""
    _done.clear()
