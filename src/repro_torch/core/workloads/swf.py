"""Standard Workload Format trace replay with hybrid-workload annotation.

SWF (Feitelson's Parallel Workloads Archive format, the one accasim and
most HPC simulators ingest) is one job per line, 18 whitespace-separated
integer/float fields, with ``;`` comment lines; header comments carry
directives like ``; MaxNodes: 4392``.  Missing fields are ``-1``.
Archive traces ship gzip-compressed (``.swf.gz``); the reader
decompresses transparently by magic bytes, so the trace-zoo cache
(the reference's repro.campaign.zoo) never has to unpack them on disk.

Real traces carry no job-type, malleability, or advance-notice labels —
the paper's evaluation axes — so :class:`SwfTrace` annotates them with
the same rules the synthetic generator uses (paper §IV-A):

  * "projects" are the trace's user_id (or group_id) values; a seeded
    shuffle assigns ``frac_od_projects`` of them ONDEMAND,
    ``frac_rigid_projects`` RIGID, the rest MALLEABLE;
  * on-demand jobs larger than half the system are reassigned to
    rigid/malleable with a fair coin;
  * malleable jobs get ``n_min = ceil(malleable_min_frac * size)``;
  * rigid jobs get the generator's Daly checkpoint model (§IV-B) — an
    infinite interval would forfeit all work on preemption, skewing
    mechanism comparisons vs synthetic traces;
  * on-demand jobs draw a Table III notice mix via the shared
    :class:`~repro_torch.core.workloads.synthetic.NoticeModel`.

Registered as workload source ``"swf"``::

    Scenario("swf", params={"path": "tests/data/sample.swf",
                            "notice_mix": "W2"})
"""
from __future__ import annotations

import gzip
import io
import itertools
import math
import os
import re
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..job import JobSpec, JobType
from .base import WorkloadDataError, WorkloadSource, canonicalize, \
    register_source
from .synthetic import NoticeModel, assign_project_types, notice_mix, \
    rigid_ckpt_params

#: the 18 SWF fields, in file order (Parallel Workloads Archive v2.2)
SWF_FIELDS: Tuple[str, ...] = (
    "job_number", "submit_time", "wait_time", "run_time",
    "allocated_procs", "avg_cpu_time", "used_memory", "req_procs",
    "req_time", "req_memory", "status", "user_id", "group_id",
    "executable", "queue", "partition", "preceding_job", "think_time",
)

_HEADER_RE = re.compile(r";\s*([A-Za-z][A-Za-z0-9_ ]*?)\s*:\s*(.+?)\s*$")


#: (abspath, max_jobs, mtime_ns, size) -> (records, header).  A sweep
#: realizes one Scenario per (mechanism, seed) cell, each constructing a
#: fresh SwfTrace; the cache makes a large archive trace parse once per
#: process instead of once per cell.  Consumers treat records read-only.
_PARSE_CACHE: Dict[tuple, tuple] = {}
_PARSE_CACHE_MAX = 8


#: lines parsed per chunk by the streaming reader (amortizes the file
#: iteration without holding more than one chunk of raw text)
DEFAULT_CHUNK_LINES = 4096


def open_swf(path: str) -> io.TextIOBase:
    """Open an SWF file for text reading, decompressing transparently.

    gzip is detected by magic bytes (``\\x1f\\x8b``), not by extension,
    so both ``trace.swf.gz`` archives straight from the Parallel
    Workloads Archive and renamed copies work.  Decode errors are
    mapped to :class:`WorkloadDataError` lazily (the returned reader
    raises them as the corrupt bytes are reached)."""
    raw = open(path, "rb")
    try:
        magic = raw.read(2)
        raw.seek(0)
    except OSError:
        raw.close()
        raise
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=raw),
                                encoding="utf-8", errors="strict")
    return io.TextIOWrapper(raw, encoding="utf-8", errors="strict")


def iter_swf(path: str, max_jobs: Optional[int] = None,
             chunk_lines: int = DEFAULT_CHUNK_LINES,
             header: Optional[Dict[str, str]] = None
             ) -> Iterator[Dict[str, float]]:
    """Stream an SWF file's records without materializing the file.

    The chunked twin of :func:`parse_swf` (which delegates here):
    reads ``chunk_lines`` raw lines at a time and yields one record
    dict per job line — identical records for every chunk size
    (hypothesis-tested in tests/test_properties.py).  Header
    directives are accumulated into the caller-supplied ``header``
    dict as they are encountered; since directives may technically
    appear anywhere, the dict is only complete once the iterator is
    exhausted (the streaming SwfTrace scan always runs it dry).

    gzip-compressed traces (``.swf.gz``) are read transparently
    (:func:`open_swf`); truncated/corrupt compressed streams and
    binary junk raise :class:`WorkloadDataError` with the path, never
    a bare codec/zlib traceback.  Short job lines are padded with the
    SWF ``-1`` "unknown" marker; lines with extra trailing fields are
    truncated to the 18 standard fields (both occur in public archive
    traces).
    """
    if chunk_lines <= 0:
        raise ValueError(f"chunk_lines must be >= 1, got {chunk_lines}")
    n_records = 0
    lineno = 0
    with open_swf(path) as f:
        while True:
            try:
                chunk = list(itertools.islice(f, chunk_lines))
            except (EOFError, zlib.error, gzip.BadGzipFile) as e:
                raise WorkloadDataError(
                    f"{path}: corrupt gzip stream near line {lineno}: {e}"
                ) from None
            except UnicodeDecodeError as e:
                raise WorkloadDataError(
                    f"{path}: not a text SWF trace (undecodable bytes "
                    f"near line {lineno}: {e})") from None
            if not chunk:
                return
            for line in chunk:
                lineno += 1
                line = line.strip()
                if not line:
                    continue
                if line.startswith(";"):
                    m = _HEADER_RE.match(line)
                    if m and header is not None:
                        header[m.group(1)] = m.group(2)
                    continue
                parts = line.split()
                try:
                    vals = [float(x) for x in parts[:len(SWF_FIELDS)]]
                except ValueError as e:
                    raise WorkloadDataError(
                        f"{path}:{lineno}: unparseable SWF line: {e}"
                    ) from None
                vals += [-1.0] * (len(SWF_FIELDS) - len(vals))
                yield dict(zip(SWF_FIELDS, vals))
                n_records += 1
                if max_jobs is not None and n_records >= max_jobs:
                    return


def parse_swf(path: str, max_jobs: Optional[int] = None
              ) -> Tuple[List[Dict[str, float]], Dict[str, str]]:
    """Parse an SWF file into (records, header directives).

    Each record maps every :data:`SWF_FIELDS` name to a float (ints
    included — SWF semantics are numeric); short lines are padded with
    ``-1`` (the SWF "unknown" marker).  Header directives are the
    ``; Key: value`` comment lines.  Results are cached per
    (path, max_jobs, mtime): callers must not mutate them.
    """
    try:
        st = os.stat(path)
        cache_key = (os.path.abspath(path), max_jobs, st.st_mtime_ns,
                     st.st_size)
    except OSError:
        cache_key = None
    if cache_key is not None and cache_key in _PARSE_CACHE:
        return _PARSE_CACHE[cache_key]
    header: Dict[str, str] = {}
    records = list(iter_swf(path, max_jobs, header=header))
    if cache_key is not None:
        if len(_PARSE_CACHE) >= _PARSE_CACHE_MAX:
            _PARSE_CACHE.pop(next(iter(_PARSE_CACHE)))
        _PARSE_CACHE[cache_key] = (records, header)
    return records, header


@register_source("swf")
class SwfTrace(WorkloadSource):
    """Replay an SWF trace as an annotated hybrid workload.

    Two ingestion modes:

    * ``stream=False`` (default): the whole file is parsed into record
      dicts once (cached per path+mtime) and ``jobs()`` materializes the
      annotated trace — the legacy path, bit-for-bit stable.
    * ``stream=True``: the constructor makes ONE bounded-memory pass
      (:func:`iter_swf`) that keeps only compact numeric columns
      (~50 B/job vs ~1 KB/job of record dicts), and ``iter_jobs()``
      yields annotated JobSpecs lazily in canonical order —
      job-for-job identical to the materialized path (pinned by
      tests/test_streaming.py).  ``jobs()`` still works (it drains the
      iterator), and construction still fails fast on corrupt lines.
    """

    def __init__(self, path: str, n_nodes: Optional[int] = None,
                 max_jobs: Optional[int] = None, seed: int = 0,
                 stream: bool = False,
                 frac_od_projects: float = 0.10,
                 frac_rigid_projects: float = 0.60,
                 notice_mix: str = "W5",
                 notice_lead: tuple = (900.0, 1800.0),
                 late_window: float = 1800.0,
                 malleable_min_frac: float = 0.20,
                 project_field: str = "user_id",
                 drop_cancelled: bool = True,
                 ckpt_overhead_small: float = 600.0,
                 ckpt_overhead_large: float = 1200.0,
                 ckpt_freq_factor: float = 1.0,
                 node_mtbf_hours: float = 20000.0):
        if project_field not in SWF_FIELDS:
            raise WorkloadDataError(
                f"unknown SWF project_field {project_field!r}; "
                f"one of: {', '.join(SWF_FIELDS)}")
        self.path = path
        self.max_jobs = max_jobs
        self.seed = seed
        self.frac_od_projects = frac_od_projects
        self.frac_rigid_projects = frac_rigid_projects
        self.notice_mix = notice_mix
        self.notice_lead = notice_lead
        self.late_window = late_window
        self.malleable_min_frac = malleable_min_frac
        self.project_field = project_field
        self.drop_cancelled = drop_cancelled
        self.ckpt_overhead_small = ckpt_overhead_small
        self.ckpt_overhead_large = ckpt_overhead_large
        self.ckpt_freq_factor = ckpt_freq_factor
        self.node_mtbf_hours = node_mtbf_hours
        self.stream = stream
        self._annot_cache = None
        if stream:
            self._records = None
            self._cols, self._header, largest = self._scan()
        else:
            self._records, self._header = parse_swf(path, max_jobs)
            self._cols = None
            largest = None  # computed only if the header cannot answer
        self.n_nodes = n_nodes if n_nodes is not None \
            else self._system_size(largest)

    @property
    def header(self) -> Dict[str, str]:
        return dict(self._header)

    def _system_size(self, largest_job: Optional[int]) -> int:
        for key in ("MaxNodes", "MaxProcs"):
            raw = self._header.get(key)
            if raw:
                m = re.match(r"\d+", raw.replace(",", ""))
                if m:
                    return int(m.group())
        if largest_job is None:  # header had no answer: scan the records
            largest_job = max((s for s in map(self._size, self._records)
                               if s > 0), default=0)
        if largest_job <= 0:
            raise WorkloadDataError(
                f"{self.path}: cannot infer system size (no MaxNodes/"
                "MaxProcs header and no sized jobs); pass n_nodes=")
        return largest_job

    def _usable(self, rec: Dict[str, float]) -> Optional[int]:
        """The job size when `rec` should be simulated, else None —
        the one copy of the cancelled/unsized filter both ingestion
        modes apply."""
        if self.drop_cancelled and rec["status"] == 5:
            return None
        size = self._size(rec)
        if size <= 0 or rec["run_time"] <= 0:
            return None
        return size

    def _scan(self) -> Tuple[dict, Dict[str, str], int]:
        """One streaming pass over the file: compact numeric columns of
        the usable records (submit/size/run/req/project), the header
        directives, and the largest raw job size (system-size
        fallback).  Never holds record dicts."""
        header: Dict[str, str] = {}
        submit: List[float] = []
        size_c: List[int] = []
        run_c: List[float] = []
        req_c: List[float] = []
        proj_c: List[int] = []
        largest = 0
        for rec in iter_swf(self.path, self.max_jobs, header=header):
            largest = max(largest, self._size(rec))
            size = self._usable(rec)
            if size is None:
                continue
            submit.append(rec["submit_time"])
            size_c.append(size)
            run_c.append(rec["run_time"])
            req_c.append(rec["req_time"])
            proj_c.append(int(rec[self.project_field]))
        cols = {"submit": np.asarray(submit, np.float64),
                "size": np.asarray(size_c, np.int64),
                "run": np.asarray(run_c, np.float64),
                "req": np.asarray(req_c, np.float64),
                "proj": np.asarray(proj_c, np.int64)}
        return cols, header, largest

    @staticmethod
    def _size(rec: Dict[str, float]) -> int:
        n = int(rec["allocated_procs"])
        return n if n > 0 else int(rec["req_procs"])

    def jobs(self) -> List[JobSpec]:
        if self.stream:
            return list(self.iter_jobs())
        mix = notice_mix(self.notice_mix)  # fail fast on bad mixes
        rng = np.random.default_rng(self.seed)

        usable = []
        for rec in self._records:
            if self.drop_cancelled and rec["status"] == 5:
                continue
            size = self._size(rec)
            if size <= 0 or rec["run_time"] <= 0:
                continue  # SWF "unknown" markers: nothing to simulate
            usable.append((rec, size))
        if not usable:
            raise WorkloadDataError(
                f"{self.path}: no usable jobs (need positive size and "
                "run_time)")

        # per-project type assignment, same proportions as the generator
        projects = sorted({int(rec[self.project_field]) for rec, _ in usable})
        ptypes = assign_project_types(rng, len(projects),
                                      self.frac_od_projects,
                                      self.frac_rigid_projects)
        type_of = dict(zip(projects, ptypes))

        t0 = min(rec["submit_time"] for rec, _ in usable)
        proj_tag = self.project_field.replace("_id", "")
        jobs: List[JobSpec] = []
        for rec, size in usable:
            size = min(size, self.n_nodes)
            p = int(rec[self.project_field])
            jt: JobType = type_of[p]
            if jt is JobType.ONDEMAND and size > self.n_nodes // 2:
                jt = JobType.RIGID if rng.random() < 0.5 else JobType.MALLEABLE
            t_act = float(rec["run_time"])
            t_est = float(rec["req_time"]) if rec["req_time"] > 0 else t_act
            t_est = max(t_est, t_act)  # a kill limit below the trace runtime
            #                            would truncate the replayed job
            kw = {}
            if jt is JobType.MALLEABLE:
                kw["n_min"] = max(1, math.ceil(self.malleable_min_frac * size))
            elif jt is JobType.RIGID:
                # same Daly model as the generator (paper §IV-B): trace
                # runtimes already include regular checkpoints
                delta, tau = rigid_ckpt_params(
                    size, self.ckpt_overhead_small, self.ckpt_overhead_large,
                    self.node_mtbf_hours, self.ckpt_freq_factor)
                kw["ckpt_overhead"] = delta
                kw["ckpt_interval"] = tau
            jobs.append(JobSpec(len(jobs), jt, f"{proj_tag}{p}",
                                float(rec["submit_time"] - t0), size,
                                t_est, t_act, **kw))

        od_jobs = [j for j in jobs if j.jtype is JobType.ONDEMAND]
        NoticeModel().assign(rng, od_jobs, mix, lead=self.notice_lead,
                             late_window=self.late_window)
        return canonicalize(jobs)

    # ------------------------------------------------------------- streaming
    # _annotate() MUST stay draw-for-draw in sync with jobs() above — same
    # algorithm over the compact columns (tests/test_streaming.py pins the
    # two paths sha256-identical).
    def _annotate(self) -> dict:
        """Run the §IV-A annotation draws over the columns: final job
        types, pre-drawn notice tuples for the on-demand set, and the
        canonical (stable submit-sort) order.  Memoized so iter_jobs()
        and trace_stats() share one pass."""
        if self._annot_cache is not None:
            return self._annot_cache
        mix = notice_mix(self.notice_mix)  # fail fast on bad mixes
        rng = np.random.default_rng(self.seed)
        cols = self._cols
        if cols is None:
            cols, _header, _largest = self._scan()
            self._cols = cols
        n = len(cols["submit"])
        if n == 0:
            raise WorkloadDataError(
                f"{self.path}: no usable jobs (need positive size and "
                "run_time)")
        # per-project type assignment, same proportions as the generator
        projects = sorted({int(p) for p in cols["proj"]})
        ptypes = assign_project_types(rng, len(projects),
                                      self.frac_od_projects,
                                      self.frac_rigid_projects)
        type_of = dict(zip(projects, ptypes))
        t0 = float(cols["submit"].min())
        half = self.n_nodes // 2
        jtype = np.empty(n, dtype=object)
        od_idx: List[int] = []
        for i in range(n):
            jt: JobType = type_of[int(cols["proj"][i])]
            if jt is JobType.ONDEMAND \
                    and min(int(cols["size"][i]), self.n_nodes) > half:
                jt = JobType.RIGID if rng.random() < 0.5 else JobType.MALLEABLE
            jtype[i] = jt
            if jt is JobType.ONDEMAND:
                od_idx.append(i)
        notice = dict(zip(od_idx,
                          NoticeModel().draw(rng, len(od_idx), mix,
                                             lead=self.notice_lead,
                                             late_window=self.late_window)))
        submit_rel = cols["submit"] - t0
        order = np.argsort(submit_rel, kind="stable")  # == canonicalize sort
        self._annot_cache = {"jtype": jtype, "notice": notice,
                             "submit_rel": submit_rel, "order": order}
        return self._annot_cache

    def iter_jobs(self):
        """Yield the annotated canonical trace lazily — job-for-job
        identical to the materialized ``jobs()`` path, holding only the
        numeric columns plus one JobSpec at a time."""
        ann = self._annotate()
        cols = self._cols
        proj_tag = self.project_field.replace("_id", "")
        for new_id, i in enumerate(ann["order"]):
            i = int(i)
            jt: JobType = ann["jtype"][i]
            size = min(int(cols["size"][i]), self.n_nodes)
            t_act = float(cols["run"][i])
            req = float(cols["req"][i])
            t_est = req if req > 0 else t_act
            t_est = max(t_est, t_act)  # a kill limit below the trace
            #                            runtime would truncate the job
            kw = {}
            if jt is JobType.MALLEABLE:
                kw["n_min"] = max(1, math.ceil(self.malleable_min_frac * size))
            elif jt is JobType.RIGID:
                delta, tau = rigid_ckpt_params(
                    size, self.ckpt_overhead_small, self.ckpt_overhead_large,
                    self.node_mtbf_hours, self.ckpt_freq_factor)
                kw["ckpt_overhead"] = delta
                kw["ckpt_interval"] = tau
            j = JobSpec(new_id, jt, f"{proj_tag}{int(cols['proj'][i])}",
                        float(ann["submit_rel"][i]), size, t_est, t_act,
                        **kw)
            if jt is JobType.ONDEMAND:
                NoticeModel.apply_one(j, ann["notice"][i])
            yield j

    def trace_stats(self):
        from .base import TraceStats
        ann = self._annotate()
        order = ann["order"]
        return TraceStats(len(order), len(ann["notice"]),
                          float(ann["submit_rel"][order[0]]),
                          float(ann["submit_rel"][order[-1]]))
