"""Builtin + bundled third-party scheduling policies.

Importing this package registers every policy and mechanism shipped with
the repo; `repro_torch.core.policy.resolve_mechanism` imports it lazily so any
`Simulator(...)` construction sees the full registry.
"""
from . import builtin  # noqa: F401  (registration side effects)
from . import wagomu   # noqa: F401

__all__ = ["builtin", "wagomu"]
