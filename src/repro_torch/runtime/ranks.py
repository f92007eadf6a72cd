"""The ranks of one job: one process a device, driven from the caller's.

`LiveCluster` is one process that calls `job.start / step / resize /
preempt / resume`.  A job over n devices runs on n rank processes, each
holding its shard of the state on a `DeviceMesh`, and a `RankGroup` is how
the caller's process drives them:

  * the ranks start from `torch.multiprocessing`'s spawn context, so CUDA
    initialises in each (a forked child cannot use the card), and join one
    default process group (`launch.mesh.init_world`: NCCL for CUDA devices,
    gloo for CPU ones) through a `TCPStore` that the caller hosts on a port
    the OS picks;
  * each rank may build one object (`target`), whose methods are commands:
    `call` sends one to every rank over its pipe and returns the first
    rank's result, `results` every rank's;
  * `reform` keeps some of the ranks and re-forms the world over them, in
    the order given, without starting a process: a shrink;
  * every wait has a timeout.  A rank that raises sends its traceback, a
    rank that dies leaves its exit code, and either way the caller stops
    every rank and raises `RankError` with it, so no rank is left waiting
    in a collective for one that is gone.

Commands and their results are pickled: a function by its import path, a
CPU tensor through shared memory.  Send no CUDA tensor.
"""
from __future__ import annotations

import time
import traceback
from datetime import timedelta
from multiprocessing.connection import wait
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as tdist

from repro_torch.launch.mesh import init_world

#: seconds a command (and the start of the ranks) may take before the
#: caller stops the ranks and raises
RANK_TIMEOUT = 600.0


class RankError(RuntimeError):
    """A rank raised, died or did not answer in time."""


def _join(rank: int, size: int, device, store, gen: int, timeout: float):
    return init_world(rank, size, device, tdist.PrefixStore(f"world{gen}", store),
                      timeout=timeout)


def _serve(rank: int, devices: Sequence[str], port: int, timeout: float,
           target, conn) -> None:
    """A rank's process: join the world, build the target, then run the
    commands that arrive on `conn` until told to stop (None)."""
    if torch.device(devices[rank]).type == "cpu":
        torch.set_num_threads(1)   # CPU ranks share the host's cores, as under torchrun
    try:
        store = tdist.TCPStore("127.0.0.1", port, is_master=False,
                               timeout=timedelta(seconds=timeout))
        _join(rank, len(devices), devices[rank], store, 0, timeout)
        obj = target[0](*target[1]) if target is not None else None
        conn.send(("ok", None))
        while True:
            msg = conn.recv()
            if msg is None:
                break
            if msg[0] == "reform":
                _, new_rank, size, gen = msg
                tdist.destroy_process_group()
                if new_rank is None:       # not kept: leave
                    conn.send(("ok", None))
                    break
                _join(new_rank, size, devices[rank], store, gen, timeout)
                conn.send(("ok", None))
                continue
            _, fn, args = msg
            fn = getattr(obj, fn) if isinstance(fn, str) else fn
            conn.send(("ok", fn(*args)))
    except Exception:  # noqa: BLE001 -- sent to the caller, who raises it
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        conn.close()


class RankGroup:
    """One rank process for each of `devices` (device strings, "cpu" or
    "cuda:<n>"), joined in one default process group; `target` is
    (callable, args) and builds each rank's object once the world is up.
    Use it as a context manager, or call `close`."""

    def __init__(self, devices: Sequence, target=None, *,
                 timeout: float = RANK_TIMEOUT):
        self.devices = [str(d) for d in devices]
        self.timeout = timeout
        self._gen = 0
        self._store = tdist.TCPStore("127.0.0.1", 0, is_master=True,
                                     wait_for_workers=False,
                                     timeout=timedelta(seconds=timeout))
        ctx = torch.multiprocessing.get_context("spawn")
        self._procs, self._conns = [], []
        try:
            for r in range(len(self.devices)):
                mine, theirs = ctx.Pipe()
                proc = ctx.Process(target=_serve, daemon=True,
                                   args=(r, self.devices, self._store.port, timeout,
                                         target, theirs))
                proc.start()
                theirs.close()
                self._procs.append(proc)
                self._conns.append(mine)
            self._wait()
        except BaseException:
            self.close()
            raise

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self._procs)

    # ----------------------------------------------------------- commands
    def results(self, fn, *args) -> List[Any]:
        """Every rank's `fn(*args)`, in rank order: `fn` names a method of
        the rank's target, or is a function importable by the ranks."""
        self._send(("call", fn, args))
        return self._wait()

    def call(self, fn, *args) -> Any:
        """The first rank's `fn(*args)`; every rank runs it."""
        return self.results(fn, *args)[0]

    def reform(self, keep: Sequence[int]) -> None:
        """Keep the ranks `keep` (indices into the current ranks, in their
        new order), stop the others, and re-form the world over the kept:
        rank keep[i] becomes rank i.  Starts no process; whatever the
        ranks hold must be gathered first (the old world is destroyed)."""
        keep = list(keep)
        self._gen += 1
        for i, conn in enumerate(self._conns):
            new = keep.index(i) if i in keep else None
            self._send_one(conn, ("reform", new, len(keep), self._gen))
        self._wait()
        gone = [i for i in range(len(self._procs)) if i not in keep]
        self._stop([self._procs[i] for i in gone], [self._conns[i] for i in gone])
        self._procs = [self._procs[i] for i in keep]
        self._conns = [self._conns[i] for i in keep]
        self.devices = [self.devices[i] for i in keep]

    def close(self, grace: float = 10.0) -> None:
        """Stop every rank: ask, wait up to `grace` seconds, then
        terminate the ones left."""
        procs, conns = self._procs, self._conns
        self._procs, self._conns, self._store = [], [], None
        self._stop(procs, conns, grace)

    # ------------------------------------------------------------ plumbing
    def _send_one(self, conn, msg) -> None:
        try:
            conn.send(msg)
        except OSError:
            pass              # the rank is gone; _wait says why

    def _send(self, msg) -> None:
        for conn in self._conns:
            self._send_one(conn, msg)

    def _stop(self, procs, conns, grace: float = 10.0) -> None:
        for conn in conns:
            self._send_one(conn, None)
        deadline = time.monotonic() + grace
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(10.0)
        for conn in conns:
            conn.close()

    def _gone(self, i: int) -> None:
        proc = self._procs[i]
        proc.join(1.0)                 # its exit code, once it is reaped
        self._fail(f"rank {i} on {self.devices[i]} exited with code {proc.exitcode}")

    def _fail(self, why: str) -> None:
        self.close(grace=0.0)
        raise RankError(why)

    def _wait(self) -> List[Any]:
        """One answer from every rank, within the timeout."""
        out: List[Optional[tuple]] = [None] * len(self._conns)
        deadline = time.monotonic() + self.timeout
        pending = dict(enumerate(self._conns))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"ranks {sorted(pending)} of {self.devices} did not "
                           f"answer within {self.timeout} s")
            sentinels = {self._procs[i].sentinel: i for i in pending}
            for ready in wait([*pending.values(), *sentinels], timeout=left):
                i = sentinels.get(ready)
                if i is not None:          # the process ended
                    if i not in pending or self._conns[i].poll():
                        continue           # its answer is read below
                    self._gone(i)
                i = next(j for j, c in pending.items() if c is ready)
                try:
                    kind, value = self._conns[i].recv()
                except EOFError:
                    self._gone(i)
                if kind == "error":
                    self._fail(f"rank {i} on {self.devices[i]} raised:\n{value}")
                out[i] = value
                del pending[i]
        return out
