"""Elastic job runtime: the execution half of the paper's job classes.

The port's counterpart of `repro.runtime.elastic`.  An ElasticJob owns a
training job's full state and implements the operations the scheduler
issues (paper §I: "start, preemption, shrink, expansion" + resume), with
the members `LiveCluster` reads and calls:

  start(devices)        init (or keep) the train state on the first slot
  step()                one train step on the job's own synthetic stream
  preempt(warning)      malleable: 2-min-warning checkpoint at the exact
                        step; rigid: fall back to the last periodic ckpt
  resize(devices)       shrink/expand onto another slot list, without a
                        checkpoint; returns the measured seconds
  resume(devices)       start() from the persisted checkpoint

A node is a `torch.device` slot: the slots of one cluster may all name one
card (`cuda:0`) or all the CPU.  One card holds no mesh, so the state lives
whole on the first slot's device and a resize moves it there (`_reshard`),
which copies nothing when it already lies there.  A preempted job's state
leaves the card for host memory, so that jobs waiting for nodes hold none
of the card's; the reference keeps it where it was.  The job runs where its
slots say: the caller picks the card or the CPU.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch

from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.training import (AdamW, checkpoint, make_train_state,
                                  make_train_step, synthetic_batch)
from .straggler import StragglerMonitor


def _state_map(fn, tree):
    """fn over the tensors of a TrainState (NamedTuples, dicts, None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [_state_map(fn, t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, dict):
        return {k: _state_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _indexed(dev: torch.device) -> torch.device:
    """`cuda` as the `cuda:<n>` its tensors report, so that a slot compares
    equal to the device of the state placed on it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _state_leaves(tree) -> list:
    out = []
    _state_map(out.append, tree)
    return out


class ElasticJob:
    def __init__(self, jid: int, cfg: ModelConfig, *, kind: str = "malleable",
                 batch: int = 8, seq: int = 128, opt: Optional[AdamW] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 seed: int = 0):
        assert kind in ("rigid", "malleable")
        self.jid = jid
        self.cfg = cfg
        self.kind = kind
        self.batch = batch
        self.seq = seq
        self.opt = opt or AdamW(warmup=10, total_steps=10_000)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.seed = seed
        self.step_idx = 0
        self.state = None
        self.devices: Sequence[torch.device] = ()
        self.monitor = StragglerMonitor()
        self.resize_costs: List[float] = []
        self.losses: List[float] = []         # loss of each step
        self.step_seconds: List[float] = []   # wall time of each step
        self.ckpt_seconds: List[float] = []   # wall time of each checkpoint
        self._step_fn = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def _place(self, devices: Sequence) -> None:
        self.devices = [_indexed(torch.device(d)) for d in devices]
        # the reference re-jits for the new mesh; a torch step has nothing
        # to compile, and one microbatch, as the reference's call has
        self._step_fn = make_train_step(self.cfg, self.opt)

    def _fresh_state(self):
        return make_train_state(init_params(self.cfg, seed=self.seed,
                                            device=self.device), self.opt)

    # ----------------------------------------------------------------- start
    def start(self, devices: Sequence) -> None:
        self._place(devices)
        if self.state is None:
            self.state = self._fresh_state()
        else:
            self._reshard()

    def resume(self, devices: Sequence) -> None:
        assert self.ckpt_dir is not None
        self._place(devices)
        template = self.state if self.state is not None else self._fresh_state()
        self.state = checkpoint.restore(self.ckpt_dir, template)
        self.step_idx = checkpoint.latest_step(self.ckpt_dir)
        self._reshard()

    # ------------------------------------------------------------------ step
    def step(self) -> dict:
        t0 = time.perf_counter()
        batch = synthetic_batch(self.cfg, self.batch, self.seq, seed=self.seed,
                                step=self.step_idx, device=self.device)
        self.state, metrics = self._step_fn(self.state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        self.step_idx += 1
        self.losses.append(metrics["loss"])
        self.step_seconds.append(time.perf_counter() - t0)
        self.monitor.observe(self.step_seconds[-1])
        if self.ckpt_dir and self.step_idx % self.ckpt_every == 0:
            self.checkpoint()
        return metrics

    def checkpoint(self) -> None:
        assert self.ckpt_dir is not None
        t0 = time.perf_counter()
        checkpoint.save(self.ckpt_dir, self.step_idx, self.state)
        self.ckpt_seconds.append(time.perf_counter() - t0)

    # -------------------------------------------------------------- preempt
    def preempt(self, warning: bool = True) -> None:
        """warning=True is the 2-minute-warning path (malleable): snapshot
        the exact current step.  Rigid jobs lose work since the last
        periodic checkpoint (paper §III-A).  The state moves to host
        memory either way."""
        if self.ckpt_dir is not None and (warning or self.kind == "malleable"):
            self.checkpoint()
        if self.state is not None:
            self.state = _state_map(lambda t: t.cpu(), self.state)
        self._step_fn = None
        self.devices = ()

    # -------------------------------------------------------- shrink/expand
    def resize(self, devices: Sequence) -> float:
        """Checkpoint-free elastic resize onto a new slot list.  Returns
        the measured cost of moving the state, in seconds."""
        self._place(devices)
        dt = self._reshard()
        self.resize_costs.append(dt)
        return dt

    def _reshard(self) -> float:
        """Move the train state to the first slot's device; returns the
        wall seconds the move took, the copy finished."""
        t0 = time.perf_counter()
        dev = self.device
        if any(t.device != dev for t in _state_leaves(self.state)):
            self.state = _state_map(lambda t: t.to(dev), self.state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter() - t0
