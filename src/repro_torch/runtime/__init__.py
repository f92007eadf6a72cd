"""repro_torch.runtime — elastic execution on real devices.

A copy of `repro.runtime` whose `ElasticJob` trains with the port's
`training` package.  `LiveCluster`/`LiveJobInfo` are plain Python over the
policy registry and import no torch; `ElasticJob` and `StragglerMonitor`
are loaded on first access (PEP 562), as in the reference.
"""
from .cluster import LiveCluster, LiveJobInfo

__all__ = ["ElasticJob", "StragglerMonitor", "LiveCluster", "LiveJobInfo"]

_LAZY = {"ElasticJob": "elastic", "StragglerMonitor": "straggler"}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
