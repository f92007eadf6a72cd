"""Elastic job runtime: the execution half of the paper's job classes.

The port's counterpart of `repro.runtime.elastic`.  An ElasticJob owns a
training job's full state and implements the operations the scheduler
issues (paper §I: "start, preemption, shrink, expansion" + resume), with
the members `LiveCluster` reads and calls:

  start(devices)        init (or keep) the train state on the slots
  step()                one train step on the job's own synthetic stream
  preempt(warning)      malleable: 2-min-warning checkpoint at the exact
                        step; rigid: fall back to the last periodic ckpt
  resize(devices)       shrink/expand onto another slot list, without a
                        checkpoint; returns the measured seconds
  resume(devices)       start() from the persisted checkpoint

A node is a `torch.device` slot, and the slots decide where the job runs:

  * Slots that name n > 1 distinct devices (`cpu:0` ... `cpu:7`, or
    `cuda:0` ... `cuda:3`) run the job as the reference does, on an (n, 1)
    ("data", "model") mesh: one rank process a device (`runtime/ranks.py`,
    NCCL between cards, gloo between CPU ranks), each holding its shard of
    the state as placed by `sharding.tree_shardings` and its rows of every
    batch.  A shrink onto some of the job's devices gathers the state on
    the ranks, re-forms the world over the ranks kept and re-places it
    there, starting no process; any other resize gathers the state to this
    process and starts ranks on the new devices.  A preempt checkpoints
    from the ranks, gathers the state to host memory and stops them; a
    resume starts ranks on other devices, each reading its own shard of
    the checkpoint.  `state` read here is the whole state, gathered to host
    memory.
  * Slots that all name one device (`cpu` or `cuda:0` for every node, as
    the live cluster, the launchers and chip_smoke map one card) run the
    job in this process, its state whole on that device; a resize moves
    it there (`_reshard`), which copies nothing when it already lies there,
    and a preempted job's state leaves the card for host memory, so that
    jobs waiting for nodes hold none of the card's.

The caller picks the card or the CPU: no slot falls back to another device.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor

from repro_torch import tracing
from repro_torch.launch.mesh import make_mesh, mesh_device
from repro_torch.models import init_params, set_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import (batch_axes, distribute, gathered, map_with_path,
                                  tree_shardings)
from repro_torch.training import (AdamW, checkpoint, make_train_state,
                                  make_train_step, synthetic_batch)
from .ranks import RankGroup
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


class _JobRank:
    """One rank of a job over several devices, in its own process: its
    shard of the train state on the (n, 1) mesh over the world's ranks.
    Its methods are the commands `ElasticJob` sends through `RankGroup`;
    each rank runs each of them, and collectives join the ranks."""

    def __init__(self, cfg: ModelConfig, opt: AdamW, batch: int, seq: int, seed: int):
        self.cfg, self.opt, self.batch, self.seq, self.seed = cfg, opt, batch, seq, seed
        self.state = None
        self._whole = None
        self._mesh()

    def _mesh(self) -> None:
        backend = tdist.get_backend()
        self.mesh = make_mesh((tdist.get_world_size(), 1), ("data", "model"),
                              "cuda" if backend == "nccl" else "cpu")
        self.device = mesh_device(self.mesh)
        self.rank = tdist.get_rank()
        set_mesh(self.mesh, batch_axes(self.mesh))
        # the reference's call: one microbatch, no pinned gradients
        self._step_fn = make_train_step(self.cfg, self.opt)

    def _shardings(self, tree):
        return tree_shardings(tree, self.cfg, self.mesh)

    def _place(self, state) -> None:
        self.state = distribute(state, self._shardings(state), self.mesh)

    def fresh(self) -> None:
        """The job's initial state from its seed (each rank draws the same
        params and keeps its shard)."""
        self._place(make_train_state(init_params(self.cfg, seed=self.seed,
                                                 device=self.device), self.opt))

    def load(self, state) -> None:
        """Place a whole host state sent by the controller.  A copy of its
        own: the tensors arrive in memory every rank maps, and the step
        updates its state in place."""
        self._place(_state_map(lambda t: t.to(self.device, copy=True), state))

    def restore(self, path: str) -> None:
        """Each rank's own shard of the newest checkpoint under path."""
        template = make_train_state(init_params(self.cfg, device="meta"), self.opt)
        self.state = checkpoint.restore(path, template, placements=self._shardings(template),
                                        mesh=self.mesh)

    def placements(self):
        """The placements of the state's leaves, by path."""
        return map_with_path(lambda _, t: tuple(t.placements), self.state)

    def host_state(self):
        """The whole state in host memory on rank 0 (None on the others);
        every rank joins the gathers."""
        def one(_, t):  # a leaf at a time, so no rank holds the whole state
            t = t.full_tensor()
            return t.cpu() if self.rank == 0 else None
        out = map_with_path(one, self.state)
        return out if self.rank == 0 else None

    def step(self, step_idx: int) -> dict:
        batch = synthetic_batch(self.cfg, self.batch, self.seq, seed=self.seed,
                                step=step_idx, device=self.device, mesh=self.mesh)
        self.state, metrics = self._step_fn(self.state, batch)
        return {k: float(v.full_tensor() if isinstance(v, DTensor) else v)
                for k, v in metrics.items()}

    def save(self, path: str, step: int) -> None:
        checkpoint.save(path, step, self.state)

    def gather(self) -> None:
        """Hold the state whole on this rank's device, before the world is
        re-formed (the old mesh goes with it)."""
        self._whole, self.state = gathered(self.state), None

    def rebuild(self) -> None:
        """The mesh over the re-formed world, the state placed on it."""
        self._mesh()
        self._place(self._whole)
        self._whole = None


def _spread(devices: Sequence) -> bool:
    """Whether the slots name more than one device (a job on ranks)."""
    return len({str(torch.device(d)) for d in devices}) > 1


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
        self._state = None
        self._ranks: Optional[RankGroup] = None
        self.devices: Sequence[torch.device] = ()
        self.monitor = StragglerMonitor()
        self.resize_costs: List[float] = []
        self.resize_parts: List[dict] = []    # seconds of each part of each resize
        self.losses: List[float] = []         # loss of each step
        self.step_seconds: List[float] = []   # wall time of each step
        self.ckpt_seconds: List[float] = []   # wall time of each checkpoint
        self._step_fn = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def state(self):
        """The train state: whole, and on the ranks' jobs gathered to host
        memory (every read gathers); None before the first start."""
        if self._ranks is not None:
            return self._ranks.call("host_state")
        return self._state

    @state.setter
    def state(self, value) -> None:
        if self._ranks is not None:
            self._ranks.call("load", value)
        else:
            self._state = value

    def _place(self, devices: Sequence) -> None:
        self.devices = [_indexed(torch.device(d)) for d in devices]
        # the reference re-jits for the new mesh; a torch step has nothing
        # to compile, and one microbatch, as the reference's call has
        self._step_fn = make_train_step(self.cfg, self.opt)

    def _fresh_state(self):
        return make_train_state(init_params(self.cfg, seed=self.seed,
                                            device=self.device), self.opt)

    # ----------------------------------------------------------------- ranks
    def _spawn(self, devices: Sequence) -> float:
        """Start ranks on `devices`; returns the seconds it took."""
        t0 = time.perf_counter()
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self._ranks = RankGroup(self.devices, (_JobRank, (self.cfg, self.opt, self.batch,
                                                          self.seq, self.seed)))
        return time.perf_counter() - t0

    def _unspawn(self) -> None:
        """Gather the state to host memory and stop the ranks."""
        self._state = self._ranks.call("host_state")
        self._ranks.close()
        self._ranks = None

    def _load(self, devices: Sequence) -> dict:
        """Ranks on `devices` holding the host state (or a fresh one);
        returns the seconds of each part."""
        spawn_s = self._spawn(devices)
        t0 = time.perf_counter()
        if self._state is None:
            self._ranks.call("fresh")
        else:
            self._ranks.call("load", _state_map(lambda t: t.cpu(), self._state))
            self._state = None
        return {"spawn_s": spawn_s, "place_s": time.perf_counter() - t0}

    # ----------------------------------------------------------------- start
    def start(self, devices: Sequence) -> None:
        if self._ranks is not None:
            self.resize(devices)
        elif _spread(devices):
            self._load(devices)
        else:
            self._place(devices)
            if self._state is None:
                self._state = self._fresh_state()
            else:
                self._reshard()

    def resume(self, devices: Sequence) -> None:
        assert self.ckpt_dir is not None
        if self._ranks is not None:
            self._ranks.close()
            self._ranks = None
        if _spread(devices):
            self._spawn(devices)
            self._ranks.call("restore", self.ckpt_dir)
            self._state = None
        else:
            self._place(devices)
            template = self._state if self._state is not None else self._fresh_state()
            self._state = checkpoint.restore(self.ckpt_dir, template)
        self.step_idx = checkpoint.latest_step(self.ckpt_dir)
        if self._ranks is None:
            self._reshard()

    # ------------------------------------------------------------------ step
    def step(self) -> dict:
        t0 = time.perf_counter()
        if self._ranks is not None:
            metrics = self._ranks.call("step", self.step_idx)
        else:
            with tracing.span("runtime.step", jid=self.jid, step=self.step_idx):
                with tracing.span("runtime.batch"):
                    batch = synthetic_batch(self.cfg, self.batch, self.seq, seed=self.seed,
                                            step=self.step_idx, device=self.device)
                self._state, metrics = self._step_fn(self._state, batch)
                with tracing.span("runtime.sync"):   # the first value waits for the step
                    metrics = {k: float(v) for k, v in metrics.items()}
                    tracing.count("host_syncs", len(metrics))   # one a value read
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
        if self._ranks is not None:
            self._ranks.call("save", self.ckpt_dir, self.step_idx)
        else:
            checkpoint.save(self.ckpt_dir, self.step_idx, self._state)
        self.ckpt_seconds.append(time.perf_counter() - t0)

    # -------------------------------------------------------------- preempt
    def preempt(self, warning: bool = True) -> None:
        """warning=True is the 2-minute-warning path (malleable): snapshot
        the exact current step.  Rigid jobs lose work since the last
        periodic checkpoint (paper §III-A).  The state moves to host
        memory either way (from the ranks, which stop)."""
        if self.ckpt_dir is not None and (warning or self.kind == "malleable"):
            self.checkpoint()
        if self._ranks is not None:
            self._unspawn()
        elif self._state is not None:
            self._state = _state_map(lambda t: t.cpu(), self._state)
        self._step_fn = None
        self.devices = ()

    # -------------------------------------------------------- shrink/expand
    def resize(self, devices: Sequence) -> float:
        """Checkpoint-free elastic resize onto a new slot list.  Returns
        the measured cost, in seconds: of moving the state, and on ranks of
        any start of new ones (`resize_parts` has the parts)."""
        t0 = time.perf_counter()
        new = [_indexed(torch.device(d)) for d in devices]
        if self._ranks is None and not _spread(new):
            self._place(devices)
            dt = self._reshard()
            self.resize_costs.append(dt)
            self.resize_parts.append({"move_s": dt})
            return dt
        if self._ranks is not None and _spread(new) and set(new) <= set(self.devices):
            # a shrink: the ranks kept re-form the world and re-place
            self._ranks.call("gather")
            t1 = time.perf_counter()
            self._ranks.reform([self.devices.index(d) for d in new])
            t2 = time.perf_counter()
            self._ranks.call("rebuild")
            self.devices = new
            parts = {"gather_s": t1 - t0, "reform_s": t2 - t1,
                     "place_s": time.perf_counter() - t2}
        else:
            parts = {}
            if self._ranks is not None:
                self._unspawn()
                parts["gather_s"] = time.perf_counter() - t0
            if _spread(new):
                parts.update(self._load(new))
            else:
                t1 = time.perf_counter()
                self._place(devices)
                self._reshard()
                parts["place_s"] = time.perf_counter() - t1
        dt = time.perf_counter() - t0
        self.resize_costs.append(dt)
        self.resize_parts.append(parts)
        return dt

    def _reshard(self) -> float:
        """Move the train state to the first slot's device; returns the
        wall seconds the move took, the copy finished."""
        t0 = time.perf_counter()
        dev = self.device
        if any(t.device != dev for t in _state_leaves(self._state)):
            self._state = _state_map(lambda t: t.to(dev), self._state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def close(self) -> None:
        """Stop the job's ranks, if it has any (their state is dropped)."""
        if self._ranks is not None:
            self._ranks.close()
            self._ranks = None
