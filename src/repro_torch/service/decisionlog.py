"""Structured JSONL decision log + the shadow-fidelity digest.

Every placement decision the service core makes is appended as one JSON
line.  Two kinds of field live in a row:

* **deterministic** fields — ``seq``, ``t_sim``, ``event``, ``jid`` and
  the per-event detail (size, victim, beneficiary, ...).  These are a
  pure function of (trace, mechanism) and feed the fidelity digest: a
  sha256 over the canonical rendering of every deterministic row, which
  must equal the digest of an offline :class:`repro_torch.core.Simulator` run
  on the same trace + mechanism (the shadow-mode contract).
* **measurement** fields — ``wall`` (human-readable wall-clock ISO
  stamp), ``mono`` (monotonic seconds), ``latency_ms`` (wall latency of
  the event batch that produced the decision).  These vary run to run
  and are excluded from the digest.

A third class of row exists only in the live service: **runtime rows**
(events in :data:`DIGEST_EXEMPT_EVENTS`, e.g. ``launch_failed`` /
``quarantine``).  They record backend failures, carry ``seq=-1``, and
are excluded from the digest entirely — launcher flakiness must never
perturb the fidelity fingerprint of the decision stream.

Crash tolerance (docs/faults.md):

* each row is written and flushed as it is appended, so a SIGKILL'd
  daemon leaves at worst one *torn* final line;
* ``rotate_bytes`` rotates the active file to ``<path>.<seq>`` on a
  line boundary, bounding any one file's size;
* :func:`read_decision_log` / :meth:`DecisionLog.recover` reassemble
  the rotated segments in order, tolerate a torn tail on the final
  segment (with a warning), and rebuild the incremental digest so a
  recovered log continues producing the exact suffix an uninterrupted
  run would have.

Schema (see docs/service.md for the full table)::

    {"seq": 12, "t_sim": 5400.0, "event": "start", "jid": 7,
     "size": 128, "jtype": "malleable",
     "wall": "2026-08-08T12:00:01Z", "mono": 123.456, "latency_ms": 0.41}
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

#: row keys that are measurements, not decisions (digest-excluded)
MEASUREMENT_KEYS = ("wall", "mono", "latency_ms")

#: events that are runtime observations, not scheduling decisions —
#: excluded from the fidelity digest so backend flakiness (launch
#: failures, quarantines) never perturbs the shadow-mode contract
DIGEST_EXEMPT_EVENTS = frozenset({"launch_failed", "quarantine"})


def _canonical(row: Dict) -> bytes:
    """Stable rendering of a row's deterministic fields."""
    det = {k: v for k, v in row.items() if k not in MEASUREMENT_KEYS}
    return json.dumps(det, sort_keys=True, separators=(",", ":"),
                      default=str).encode()


def decision_digest(rows: Iterable[Dict]) -> str:
    """Order-sensitive sha256 over the deterministic fields of every
    decision row — the fidelity fingerprint compared between the live
    service and the offline simulator.  Runtime rows
    (:data:`DIGEST_EXEMPT_EVENTS`) are skipped."""
    h = hashlib.sha256()
    for row in rows:
        if row.get("event") in DIGEST_EXEMPT_EVENTS:
            continue
        h.update(_canonical(row))
        h.update(b"\n")
    return h.hexdigest()


class TornLogError(ValueError):
    """A decision-log file is corrupt somewhere other than its final
    line — a torn tail is survivable, a torn middle is not."""


def log_segments(path: str) -> List[str]:
    """All on-disk files of a (possibly rotated) decision log, oldest
    first: ``<path>.1``, ``<path>.2``, ..., then the active ``<path>``."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    rotated = []
    for name in os.listdir(d):
        if name.startswith(base + "."):
            suffix = name[len(base) + 1:]
            if suffix.isdigit():
                rotated.append((int(suffix), os.path.join(d, name)))
    out = [p for _, p in sorted(rotated)]
    if os.path.exists(path):
        out.append(path)
    return out


def _read_rows(path: str, tolerate_torn: bool) -> Tuple[List[Dict], int]:
    """Parse one JSONL segment; returns ``(rows, good_bytes)`` where
    ``good_bytes`` is the byte offset just past the last complete row.

    A malformed *final* line is a torn tail (crash mid-write): skipped
    with a warning when ``tolerate_torn``.  Malformed content anywhere
    else is real corruption and raises :class:`TornLogError`.
    """
    rows: List[Dict] = []
    good = 0
    with open(path, "rb") as fh:
        data = fh.read()
    offset = 0
    for raw in data.splitlines(keepends=True):
        line = raw.strip()
        complete = raw.endswith(b"\n")
        if line:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                if offset + len(raw) < len(data) or not tolerate_torn:
                    raise TornLogError(
                        f"{path}: corrupt row at byte {offset}") from None
                warnings.warn(f"{path}: torn final line "
                              f"({len(raw)} bytes) skipped", RuntimeWarning)
                return rows, good
            if not complete:      # valid JSON but crash before the newline
                if tolerate_torn:
                    warnings.warn(f"{path}: unterminated final line kept",
                                  RuntimeWarning)
                else:
                    raise TornLogError(f"{path}: unterminated final line")
        offset += len(raw)
        good = offset
    return rows, good


def read_decision_log(path: str) -> List[Dict]:
    """Load a JSONL decision log back into row dicts, reassembling
    rotated segments in order and tolerating a torn final line on the
    last segment (crash-consistency: every complete row survives)."""
    segments = log_segments(path)
    if not segments:
        raise FileNotFoundError(path)
    rows: List[Dict] = []
    for i, seg in enumerate(segments):
        seg_rows, _ = _read_rows(seg, tolerate_torn=(i == len(segments) - 1))
        rows.extend(seg_rows)
    return rows


class DecisionLog:
    """Append-only JSONL writer with an incremental fidelity digest and
    an in-memory latency series for the SLO monitor.

    ``path=None`` keeps everything in memory (tests, fidelity reference
    runs); with a path each row is written and flushed as it is appended
    so a crashed daemon leaves a complete prefix on disk.  With
    ``rotate_bytes`` the active file is rotated to ``<path>.<n>`` once
    it exceeds that size (always on a line boundary).
    """

    def __init__(self, path: Optional[str] = None, keep_rows: bool = True,
                 rotate_bytes: Optional[int] = None):
        self.path = path
        self.keep_rows = keep_rows
        self.rotate_bytes = rotate_bytes
        self.rows: List[Dict] = []
        self.n_rows = 0
        self.latencies_ms: List[float] = []
        self._sha = hashlib.sha256()
        self._active_bytes = 0
        self._rotations = 0
        self._fh = open(path, "w") if path else None

    # ------------------------------------------------------------- rotation
    def _rotate(self) -> None:
        """Rotate the active file to ``<path>.<n>`` and start a fresh
        one.  Called only between complete rows, so every segment is a
        well-formed JSONL file (modulo the final one after a crash)."""
        assert self._fh is not None and self.path is not None
        self._fh.close()
        self._rotations += 1
        os.replace(self.path, f"{self.path}.{self._rotations}")
        self._fh = open(self.path, "w")
        self._active_bytes = 0

    def append(self, decision: Dict, *, latency_ms: Optional[float] = None,
               mono: Optional[float] = None) -> Dict:
        """Append one decision; measurement fields are added here so the
        deterministic part stays exactly what the core emitted."""
        row = dict(decision)
        row["wall"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        row["mono"] = time.monotonic() if mono is None else mono
        if latency_ms is not None:
            row["latency_ms"] = round(latency_ms, 4)
            self.latencies_ms.append(latency_ms)
        if row.get("event") not in DIGEST_EXEMPT_EVENTS:
            self._sha.update(_canonical(row))
            self._sha.update(b"\n")
        self.n_rows += 1
        if self.keep_rows:
            self.rows.append(row)
        if self._fh is not None:
            line = json.dumps(row, sort_keys=True, default=str) + "\n"
            self._fh.write(line)
            self._fh.flush()
            self._active_bytes += len(line)
            if self.rotate_bytes is not None and \
                    self._active_bytes >= self.rotate_bytes:
                self._rotate()
        return row

    # ------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, path: str, keep_rows: bool = True,
                rotate_bytes: Optional[int] = None
                ) -> Tuple["DecisionLog", List[Dict]]:
        """Reopen a crashed daemon's log for appending.

        Reads every complete row across the rotated segments (a torn
        final line is truncated away with a warning), rebuilds the
        incremental digest over the surviving rows, and returns
        ``(log, rows)`` with the log positioned to append — the digest
        of recovered-prefix + appended-suffix equals that of one
        uninterrupted run.
        """
        segments = log_segments(path)
        if not segments:
            raise FileNotFoundError(path)
        rows: List[Dict] = []
        for i, seg in enumerate(segments):
            last = i == len(segments) - 1
            seg_rows, good = _read_rows(seg, tolerate_torn=last)
            rows.extend(seg_rows)
            if last and seg == path and good < os.path.getsize(seg):
                with open(seg, "r+b") as fh:     # drop the torn tail
                    fh.truncate(good)
        log = cls.__new__(cls)
        log.path = path
        log.keep_rows = keep_rows
        log.rotate_bytes = rotate_bytes
        log.rows = list(rows) if keep_rows else []
        log.n_rows = len(rows)
        log.latencies_ms = [r["latency_ms"] for r in rows
                            if "latency_ms" in r]
        log._sha = hashlib.sha256()
        for row in rows:
            if row.get("event") not in DIGEST_EXEMPT_EVENTS:
                log._sha.update(_canonical(row))
                log._sha.update(b"\n")
        rotated = [s for s in segments if s != path]
        log._rotations = max(
            (int(s.rsplit(".", 1)[1]) for s in rotated), default=0)
        log._active_bytes = os.path.getsize(path) \
            if os.path.exists(path) else 0
        log._fh = open(path, "a")
        return log, rows

    @property
    def digest(self) -> str:
        """Digest over every row appended so far (incremental — safe on
        logs too large to retain in memory)."""
        return self._sha.hexdigest()

    def latency_summary(self) -> Dict[str, float]:
        """Decision-latency distribution in milliseconds."""
        if not self.latencies_ms:
            return {"n": 0, "p50_ms": float("nan"), "p90_ms": float("nan"),
                    "p99_ms": float("nan"), "max_ms": float("nan")}
        lat = np.asarray(self.latencies_ms, dtype=np.float64)
        p50, p90, p99 = np.percentile(lat, (50, 90, 99))
        return {"n": int(lat.size), "p50_ms": float(p50), "p90_ms": float(p90),
                "p99_ms": float(p99), "max_ms": float(lat.max())}

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "DecisionLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
