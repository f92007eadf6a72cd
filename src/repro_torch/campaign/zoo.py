"""Trace zoo: a registry of named workload traces with provenance.

Every trace a campaign references is a :class:`TraceSpec` — where the
SWF file comes from (a checked-in fixture or a Parallel Workloads
Archive URL), its sha256, its license note, and the SWF quirks the
reader must honor (``project_field``, cancelled-job handling, ...).
Resolution is **offline-first**:

  * fixture specs resolve to the gzipped files checked in under
    ``repro_torch/campaign/fixtures/`` — CI and the test suite never touch
    the network;
  * remote specs resolve through a local cache directory
    (``$REPRO_TRACE_CACHE``, default ``.cache/trace_zoo``); a cache
    miss downloads only when the environment allows it
    (``$REPRO_OFFLINE`` unset and ``offline=False``), verifies sha256
    when the spec pins one, and installs atomically.

Integrity: :func:`fetch` always re-hashes the resolved file and
refuses a digest mismatch (a truncated download or a locally edited
fixture produces a :class:`~repro_torch.core.workloads.base.WorkloadDataError`,
never a silently different campaign).
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.workloads.base import WorkloadDataError

#: default cache directory for remote traces (overridable by env)
CACHE_ENV = "REPRO_TRACE_CACHE"
OFFLINE_ENV = "REPRO_OFFLINE"
DEFAULT_CACHE = os.path.join(".cache", "trace_zoo")

_FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")


@dataclass(frozen=True)
class TraceSpec:
    """One named trace: provenance, integrity, and reader quirks."""

    name: str
    description: str
    #: license / redistribution note shown by ``repro_torch.campaign list``
    license: str
    #: sha256 of the (possibly gzipped) SWF file; None = record on fetch
    sha256: Optional[str] = None
    #: download URL for archive traces; None = checked-in fixture
    url: Optional[str] = None
    #: repo-relative fixture filename under repro_torch/campaign/fixtures/
    fixture: Optional[str] = None
    #: extra SwfTrace params this trace needs (SWF quirks: e.g. traces
    #: whose user_id is useless use project_field="group_id"; traces
    #: with unreliable status fields set drop_cancelled=False)
    swf_params: Mapping[str, object] = field(default_factory=dict)

    @property
    def remote(self) -> bool:
        return self.url is not None


_ZOO: Dict[str, TraceSpec] = {}


def register_trace(spec: TraceSpec) -> TraceSpec:
    """Add a trace to the zoo (idempotent for identical re-registration)."""
    old = _ZOO.get(spec.name)
    if old is not None and old != spec:
        raise ValueError(f"trace {spec.name!r} already registered "
                         "with a different spec")
    _ZOO[spec.name] = spec
    return spec


def get_trace(name: str) -> TraceSpec:
    try:
        return _ZOO[name]
    except KeyError:
        raise WorkloadDataError(
            f"unknown trace {name!r}; zoo has: "
            f"{', '.join(sorted(_ZOO))}") from None


def registered_traces() -> Tuple[str, ...]:
    return tuple(sorted(_ZOO))


def cache_dir() -> str:
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE


def is_offline(offline: Optional[bool] = None) -> bool:
    if offline is not None:
        return offline
    return bool(os.environ.get(OFFLINE_ENV))


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def trace_path(name: str, offline: Optional[bool] = None) -> str:
    """Resolve a zoo trace to a local file, fetching if needed+allowed."""
    return fetch(name, offline=offline)


def fetch(name: str, offline: Optional[bool] = None,
          cache: Optional[str] = None) -> str:
    """Resolve ``name`` to a verified local SWF path.

    Fixtures verify in place; remote traces resolve via the cache and
    download on a miss unless offline.  Always re-hashes: a spec with
    a pinned sha256 refuses a mismatching file (WorkloadDataError)."""
    spec = get_trace(name)
    if spec.fixture is not None:
        path = os.path.join(_FIXTURE_DIR, spec.fixture)
        if not os.path.exists(path):
            raise WorkloadDataError(
                f"trace {name!r}: missing checked-in fixture {path}")
        return _verified(spec, path)
    assert spec.url is not None
    cdir = cache or cache_dir()
    path = os.path.join(cdir, os.path.basename(spec.url))
    if os.path.exists(path):
        return _verified(spec, path)
    if is_offline(offline):
        raise WorkloadDataError(
            f"trace {name!r} is not cached at {path} and the environment "
            f"is offline ({OFFLINE_ENV} set or offline=True); run "
            f"'python -m repro_torch.campaign fetch {name}' where the network "
            "is available, or point "
            f"{CACHE_ENV} at a pre-populated cache")
    os.makedirs(cdir, exist_ok=True)
    tmp_fd, tmp = tempfile.mkstemp(dir=cdir, suffix=".part")
    os.close(tmp_fd)
    try:
        try:
            with urllib.request.urlopen(spec.url, timeout=60) as resp, \
                    open(tmp, "wb") as out:
                while True:
                    b = resp.read(1 << 20)
                    if not b:
                        break
                    out.write(b)
        except (urllib.error.URLError, OSError) as e:
            raise WorkloadDataError(
                f"trace {name!r}: download failed from {spec.url}: {e}"
            ) from None
        _verified(spec, tmp)
        os.replace(tmp, path)  # atomic install after verification
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _verified(spec: TraceSpec, path: str) -> str:
    digest = file_sha256(path)
    if spec.sha256 is not None and digest != spec.sha256:
        raise WorkloadDataError(
            f"trace {spec.name!r}: sha256 mismatch for {path}: expected "
            f"{spec.sha256}, got {digest} (corrupt download or locally "
            "modified file; delete it and re-fetch)")
    return path


def is_cached(name: str) -> bool:
    """True when the trace resolves without any network access."""
    spec = get_trace(name)
    if spec.fixture is not None:
        return os.path.exists(os.path.join(_FIXTURE_DIR, spec.fixture))
    assert spec.url is not None
    return os.path.exists(os.path.join(cache_dir(),
                                       os.path.basename(spec.url)))


# --------------------------------------------------------------- built-ins
# Checked-in fixtures: tiny synthetic SWF traces with deliberately
# different regimes (steady / bursty / near-saturation), gzipped with
# mtime=0 so their bytes — and these digests — are reproducible.
register_trace(TraceSpec(
    name="mini-steady",
    description="340 jobs, 64 nodes, steady Poisson arrivals, ~0.77 load",
    license="CC0 (synthetic, generated for this repo)",
    sha256="12fce044776eebab3ea13312a93023f30f97fd31551f24fa2ba779c118d3b8d6",
    fixture="mini-steady.swf.gz"))
register_trace(TraceSpec(
    name="mini-bursty",
    description="329 jobs, 64 nodes, clustered bursts with idle valleys",
    license="CC0 (synthetic, generated for this repo)",
    sha256="15ab1f5b274892a83d5a01dd9ca52f7cf96a90049a4c9c9b3b45ec7718949d61",
    fixture="mini-bursty.swf.gz"))
register_trace(TraceSpec(
    name="mini-heavy",
    description="380 jobs, 64 nodes, near-saturation (~1.16 offered load)",
    license="CC0 (synthetic, generated for this repo)",
    sha256="d99b1af0fbc39fde891acc981307a5ad182c6358e0a781e35c747bbcc12543bc",
    fixture="mini-heavy.swf.gz"))

# Parallel Workloads Archive traces (Feitelson's archive).  The PWA
# permits research use with attribution of the contributing site; each
# note names the contributor per the archive's citation policy.  No
# sha256 pinned — the archive occasionally re-packs files — so fetch
# verifies transport integrity (gzip CRC at read time) and campaigns
# record the observed digest in their provenance block instead.
register_trace(TraceSpec(
    name="kth-sp2",
    description="KTH IBM SP2, 28k jobs / 11 months, 100 nodes",
    license="PWA research use; credit Lars Malinowsky (KTH)",
    url="https://www.cs.huji.ac.il/labs/parallel/workload/l_kth_sp2/"
        "KTH-SP2-1996-2.1-cln.swf.gz"))
register_trace(TraceSpec(
    name="sdsc-sp2",
    description="SDSC IBM SP2, 59k jobs / 24 months, 128 nodes",
    license="PWA research use; credit Victor Hazlewood (SDSC)",
    url="https://www.cs.huji.ac.il/labs/parallel/workload/l_sdsc_sp2/"
        "SDSC-SP2-1998-4.2-cln.swf.gz"))
register_trace(TraceSpec(
    name="ctc-sp2",
    description="CTC IBM SP2, 77k jobs / 11 months, 338 nodes",
    license="PWA research use; credit the Cornell Theory Center",
    url="https://www.cs.huji.ac.il/labs/parallel/workload/l_ctc_sp2/"
        "CTC-SP2-1996-3.1-cln.swf.gz",
    # the CTC trace's queue/partition fields are the meaningful grouping;
    # user_id works but group_id matches published analyses
    swf_params={"project_field": "group_id"}))
