"""Incremental scheduling containers (the O(log n) engine hot path).

The legacy simulator kept the wait queue as a plain list: every event
re-sorted it with a Python key function (O(n log n) with n key calls)
and removed members by linear scan.  At month-scale traces (50k jobs,
thousands waiting under offered load > 1) those two costs dominate the
whole simulation.  This module provides the replacements:

    WaitQueue    the wait queue, kept permanently sorted by a cached
                 order key: O(log n) search + a C-level memmove per
                 append/remove, O(1) membership, O(1) head peek.  Policies
                 whose keys are not stable between events opt out via
                 ``QueuePolicy.order_keys_stable = False`` and get the
                 legacy re-sort-every-pass behavior back (docs/performance.md).
    OrderedSet   insertion-ordered set with O(1) append/remove/contains;
                 replaces the list-based ``collecting`` roster whose
                 ``remove`` was a linear scan per on-demand completion.

Both expose the exact surface the legacy lists exposed (indexing,
slicing, iteration, ``in``, ``len``), so policies written against
``SchedulerView.queue`` / ``.collecting`` keep working unchanged.

Tie-breaking contract: equal order keys rank by append order (a stable
sort of the legacy list preserved exactly that order as long as keys did
not change between passes).  ``invalidate`` keeps a job's original
append rank so re-keying cannot reshuffle its ties.  Built-in policies
sidestep ties entirely by ending their keys with the jid.
"""
from __future__ import annotations

import itertools
from bisect import bisect_left, insort
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union


class WaitQueue:
    """Order-key-sorted wait queue with cached keys and O(1) membership.

    In *incremental* mode (the default) the queue is sorted at all times:
    ``append`` computes the order key once and bisects it in, ``remove``
    bisects the cached key out, and ``refresh`` is a no-op.  A job's key
    is recomputed only by ``invalidate`` — the simulator calls it at the
    few events that can change a key, and custom policies may call
    ``ops.invalidate_order_key`` for their own key-changing events.

    In *legacy* mode (``incremental=False``) the queue behaves exactly
    like the old list: appends go to the back unsorted and ``refresh``
    re-sorts stably with freshly computed keys — for policies whose keys
    read clock- or load-dependent state.

    ``meta_fn`` optionally attaches a pair of floats per member (the
    simulator uses the minimum nodes the job needs to start — ``inf``
    for on-demand jobs — and its remaining-runtime estimate);
    ``meta_window`` hands contiguous slices of those floats to the
    vectorized backfill prefilter without per-job dict lookups.
    """

    __slots__ = ("_entries", "_meta0", "_meta1", "_index", "_seq", "_key_fn",
                 "_meta_fn", "incremental")

    def __init__(self,
                 key_fn: Optional[Callable[[int], tuple]] = None,
                 incremental: bool = True,
                 meta_fn: Optional[Callable[[int], Tuple[float, float]]] = None):
        self._entries: List[Tuple] = []      # (key, seq, jid), sorted when incremental
        self._meta0: List[float] = []        # parallel to _entries
        self._meta1: List[float] = []
        self._index: Dict[int, Tuple] = {}   # jid -> (key, seq, meta0, meta1)
        self._seq = itertools.count()
        self._key_fn = key_fn
        self._meta_fn = meta_fn
        self.incremental = incremental

    def configure(self, key_fn: Callable[[int], tuple],
                  incremental: bool = True,
                  meta_fn: Optional[Callable[[int], Tuple[float, float]]] = None
                  ) -> None:
        """Install the order key (and mode) before any member is added."""
        assert not self._entries, "configure() before the first append"
        self._key_fn = key_fn
        self._meta_fn = meta_fn
        self.incremental = incremental

    # ------------------------------------------------------------ mutation
    def append(self, jid: int) -> None:
        if jid in self._index:
            raise ValueError(f"job {jid} is already queued")
        seq = next(self._seq)
        m0, m1 = self._meta_fn(jid) if self._meta_fn is not None else (0.0, 0.0)
        if self.incremental:
            key = self._key_fn(jid)
            entry = (key, seq, jid)
            i = bisect_left(self._entries, entry)
            self._entries.insert(i, entry)
            self._meta0.insert(i, m0)
            self._meta1.insert(i, m1)
        else:
            key = None                       # computed at refresh() time
            self._entries.append((key, seq, jid))
            self._meta0.append(m0)
            self._meta1.append(m1)
        self._index[jid] = (key, seq, m0, m1)

    def remove(self, jid: int) -> None:
        key, seq, _m0, _m1 = self._index.pop(jid)
        i = self._locate(jid, key, seq)
        del self._entries[i]
        del self._meta0[i]
        del self._meta1[i]

    def invalidate(self, jid: int) -> None:
        """Recompute a member's order key after an event changed it; a
        non-member jid is a no-op.  The original append rank is kept so
        ties stay deterministic."""
        if not self.incremental or jid not in self._index:
            return
        key, seq, m0, m1 = self._index[jid]
        i = self._locate(jid, key, seq)
        del self._entries[i]
        del self._meta0[i]
        del self._meta1[i]
        new_key = self._key_fn(jid)
        entry = (new_key, seq, jid)
        j = bisect_left(self._entries, entry)
        self._entries.insert(j, entry)
        self._meta0.insert(j, m0)
        self._meta1.insert(j, m1)
        self._index[jid] = (new_key, seq, m0, m1)

    def refresh(self) -> None:
        """Bring the queue into key order.  Incremental mode: already
        sorted, O(1).  Legacy mode: stable re-sort with fresh keys — the
        exact semantics of the old per-pass ``queue.sort(key=...)``."""
        if self.incremental:
            return
        key_fn = self._key_fn
        self._entries.sort(key=lambda e: key_fn(e[2]))
        index = self._index
        self._meta0 = [index[e[2]][2] for e in self._entries]
        self._meta1 = [index[e[2]][3] for e in self._entries]

    # ------------------------------------------------------------- queries
    def position(self, jid: int) -> int:
        """Current rank of a member (0 = head).  O(log n) incremental."""
        key, seq, _m0, _m1 = self._index[jid]
        return self._locate(jid, key, seq)

    def meta_window(self, lo: int, hi: int
                    ) -> Tuple[List[float], List[float]]:
        """The cached per-member float pairs for ranks [lo, hi) — two
        snapshot lists aligned with ``self[lo:hi]``."""
        return self._meta0[lo:hi], self._meta1[lo:hi]

    def _locate(self, jid: int, key, seq: int) -> int:
        if self.incremental:
            i = bisect_left(self._entries, (key, seq, jid))
            if i < len(self._entries) and self._entries[i][2] == jid:
                return i
        else:
            for i, e in enumerate(self._entries):
                if e[2] == jid:
                    return i
        raise KeyError(jid)  # pragma: no cover - index/entries desync guard

    def __contains__(self, jid: object) -> bool:
        return jid in self._index

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)

    def __iter__(self) -> Iterator[int]:
        return (e[2] for e in self._entries)

    def __getitem__(self, i: Union[int, slice]):
        if isinstance(i, slice):
            return [e[2] for e in self._entries[i]]
        return self._entries[i][2]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        mode = "incremental" if self.incremental else "legacy"
        return f"<WaitQueue {mode} {list(self)!r}>"


class OrderedSet:
    """Insertion-ordered set with O(1) append/remove/contains.

    Drop-in for the list-based ``collecting`` roster: ``append`` keeps
    the first insertion's position (every call site guards membership
    anyway), ``remove`` raises on a missing member like ``list.remove``.
    """

    __slots__ = ("_d",)

    def __init__(self, items=()):
        self._d: Dict = dict.fromkeys(items)

    def append(self, x) -> None:
        self._d.setdefault(x, None)

    add = append

    def remove(self, x) -> None:
        try:
            del self._d[x]
        except KeyError:
            raise ValueError(f"{x!r} not in OrderedSet") from None

    def discard(self, x) -> None:
        self._d.pop(x, None)

    def __contains__(self, x: object) -> bool:
        return x in self._d

    def __iter__(self) -> Iterator:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __bool__(self) -> bool:
        return bool(self._d)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"OrderedSet({list(self._d)!r})"
