"""Deterministic node failure/repair models (the ``faults=`` axis).

A :class:`FaultModel` turns ``(n_nodes,)`` into a finite, sorted stream of
:class:`FaultEvent`\\ s — ``down``/``up`` pairs per node — that the
simulator injects into its event heap as first-class ``node_down`` /
``node_up`` events.  Models are string-keyed in a registry exactly like
policies and workloads, so ``faults="exp-mtbf:mtbf_h=168"`` works wherever
the port's :class:`~repro_torch.core.simulator.SimConfig` accepts the knob.

The PyTorch port's copy of the reference's jax-free ``repro.faults``,
unchanged but for this paragraph: the port imports nothing of ``repro``.
Its registry is the port's own.

Determinism contract (docs/faults.md):

* ``events(n_nodes)`` is a pure function of the model's parameters — each
  node draws from its own ``default_rng([seed, node, salt])`` stream, so
  the event list is independent of call order, platform, and n_jobs.
* The simulator consumes victim-selection draws from a single
  ``default_rng([seed, salt])`` stream in event order, so a (mechanism,
  scenario, seed, fault-spec) cell is job-for-job identical across runs.
* ``"none"`` produces no events and the simulator takes the legacy code
  path untouched — every golden digest stays bit-for-bit.

Specs are accepted in three forms, normalized by :func:`resolve_faults`:

* ``"none"`` / ``None`` — no faults.
* a compact string ``"<model>"`` or ``"<model>:k=v,k=v"`` (floats/ints
  parsed, everything else kept as a string) — the form campaign TOML and
  CLI flags use.
* a dict ``{"model": "<model>", ...params}`` — the programmatic form
  (the only way to pass ``events=`` inline to the ``trace`` model).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Union

__all__ = [
    "FaultEvent", "FaultModel", "NoFaults", "ExpMtbfFaults", "WeibullFaults",
    "TraceFaults", "UnknownFaultModelError", "register_fault_model",
    "get_fault_model", "registered_fault_models", "parse_fault_spec",
    "resolve_faults", "fault_spec_label",
]

FaultSpec = Union[None, str, Mapping[str, object]]


class UnknownFaultModelError(ValueError):
    """Raised for a fault spec naming no registered model."""


@dataclass(frozen=True, order=True)
class FaultEvent:
    """One node transition; ``kind`` is ``"down"`` or ``"up"``.

    The dataclass order (t, node, kind) is the canonical sort: at equal
    times lower node ids fire first and ``down`` precedes ``up``.
    """

    t: float
    node: int
    kind: str


class FaultModel:
    """Base class: a named, parameterized failure/repair process.

    Subclasses implement :meth:`events` and set :attr:`name`.  ``seed``
    is the determinism anchor every stochastic model must honor; models
    without randomness (``trace``) ignore it.
    """

    name = "?"

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def events(self, n_nodes: int) -> List[FaultEvent]:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class NoFaults(FaultModel):
    """The default: a perfect machine, zero events, legacy code path."""

    name = "none"

    def events(self, n_nodes: int) -> List[FaultEvent]:
        return []


def _renewal_events(n_nodes: int, horizon_s: float, mttr_s: float,
                    seed: int, draw_ttf: Callable) -> List[FaultEvent]:
    """Per-node renewal process: alternate draw_ttf(rng) up-time with an
    exponential(mttr) repair, truncated at the horizon.  Each node owns an
    independent rng keyed (seed, node), so streams never interact."""
    import numpy as np

    out: List[FaultEvent] = []
    for node in range(n_nodes):
        rng = np.random.default_rng([seed, node, 0xFA17])
        t = 0.0
        while True:
            t += float(draw_ttf(rng))
            if t >= horizon_s:
                break
            out.append(FaultEvent(t, node, "down"))
            repair = float(rng.exponential(mttr_s))
            repair = max(repair, 1.0)  # zero-length outages are unobservable
            out.append(FaultEvent(t + repair, node, "up"))
            t += repair
    out.sort()
    return out


class ExpMtbfFaults(FaultModel):
    """Memoryless failures: per-node exponential time-to-failure with mean
    ``mtbf_h`` hours and exponential repair with mean ``mttr_h`` hours."""

    name = "exp-mtbf"

    def __init__(self, mtbf_h: float = 720.0, mttr_h: float = 4.0,
                 horizon_days: float = 30.0, seed: int = 0):
        super().__init__(seed)
        if mtbf_h <= 0 or mttr_h <= 0 or horizon_days <= 0:
            raise ValueError("exp-mtbf: mtbf_h, mttr_h, horizon_days must be > 0")
        self.mtbf_h = float(mtbf_h)
        self.mttr_h = float(mttr_h)
        self.horizon_days = float(horizon_days)

    def events(self, n_nodes: int) -> List[FaultEvent]:
        mtbf_s = self.mtbf_h * 3600.0
        return _renewal_events(n_nodes, self.horizon_days * 86400.0,
                               self.mttr_h * 3600.0, self.seed,
                               lambda rng: rng.exponential(mtbf_s))

    def describe(self) -> str:
        return f"exp-mtbf(mtbf={self.mtbf_h}h, mttr={self.mttr_h}h)"


class WeibullFaults(FaultModel):
    """Weibull time-to-failure (shape < 1 reproduces the infant-mortality
    burstiness HPC failure logs show) with exponential repair."""

    name = "weibull"

    def __init__(self, shape: float = 0.7, scale_h: float = 720.0,
                 mttr_h: float = 4.0, horizon_days: float = 30.0,
                 seed: int = 0):
        super().__init__(seed)
        if shape <= 0 or scale_h <= 0 or mttr_h <= 0 or horizon_days <= 0:
            raise ValueError("weibull: shape, scale_h, mttr_h, horizon_days must be > 0")
        self.shape = float(shape)
        self.scale_h = float(scale_h)
        self.mttr_h = float(mttr_h)
        self.horizon_days = float(horizon_days)

    def events(self, n_nodes: int) -> List[FaultEvent]:
        scale_s = self.scale_h * 3600.0
        return _renewal_events(n_nodes, self.horizon_days * 86400.0,
                               self.mttr_h * 3600.0, self.seed,
                               lambda rng: scale_s * rng.weibull(self.shape))

    def describe(self) -> str:
        return f"weibull(k={self.shape}, scale={self.scale_h}h, mttr={self.mttr_h}h)"


class TraceFaults(FaultModel):
    """Replay a recorded failure log: either ``path`` to a JSONL file of
    ``{"t":..., "node":..., "kind":"down"|"up"}`` rows (or ``t,node,kind``
    CSV lines), or an inline ``events`` list of (t, node, kind) triples."""

    name = "trace"

    def __init__(self, path: Optional[str] = None,
                 events: Optional[Iterable] = None, seed: int = 0):
        super().__init__(seed)
        if (path is None) == (events is None):
            raise ValueError("trace: exactly one of path= / events= required")
        self.path = path
        self._events = None if events is None else [
            self._coerce(e) for e in events]

    @staticmethod
    def _coerce(e) -> FaultEvent:
        if isinstance(e, FaultEvent):
            ev = e
        elif isinstance(e, Mapping):
            ev = FaultEvent(float(e["t"]), int(e["node"]), str(e["kind"]))
        else:
            t, node, kind = e
            ev = FaultEvent(float(t), int(node), str(kind))
        if ev.kind not in ("down", "up"):
            raise ValueError(f"fault trace: bad kind {ev.kind!r} (want down|up)")
        if ev.t < 0:
            raise ValueError(f"fault trace: negative time {ev.t}")
        return ev

    def _load(self) -> List[FaultEvent]:
        out: List[FaultEvent] = []
        with open(self.path, "r", encoding="utf-8") as fh:
            for ln, line in enumerate(fh, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    if line.startswith("{"):
                        out.append(self._coerce(json.loads(line)))
                    else:
                        out.append(self._coerce(line.split(",")))
                except (ValueError, KeyError, json.JSONDecodeError) as exc:
                    raise ValueError(
                        f"fault trace {self.path}:{ln}: {exc}") from exc
        return out

    def events(self, n_nodes: int) -> List[FaultEvent]:
        evs = list(self._events) if self._events is not None else self._load()
        evs.sort()
        return evs

    def describe(self) -> str:
        return f"trace({self.path or 'inline'})"


# ----------------------------------------------------------------- registry
_FAULT_MODELS: Dict[str, Callable[..., FaultModel]] = {}


def register_fault_model(name: str, factory: Callable[..., FaultModel]) -> None:
    """Register a fault-model factory under a string key (last wins,
    matching the policy/workload registries)."""
    _FAULT_MODELS[name] = factory


def get_fault_model(name: str) -> Callable[..., FaultModel]:
    try:
        return _FAULT_MODELS[name]
    except KeyError:
        raise UnknownFaultModelError(
            f"unknown fault model {name!r}; registered: "
            f"{sorted(_FAULT_MODELS)}") from None


def registered_fault_models() -> List[str]:
    return sorted(_FAULT_MODELS)


register_fault_model("none", NoFaults)
register_fault_model("exp-mtbf", ExpMtbfFaults)
register_fault_model("weibull", WeibullFaults)
register_fault_model("trace", TraceFaults)


def _parse_value(v: str) -> object:
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def parse_fault_spec(spec: str) -> Dict[str, object]:
    """``"exp-mtbf:mtbf_h=168,mttr_h=2"`` -> ``{"model": "exp-mtbf",
    "mtbf_h": 168, "mttr_h": 2}``."""
    name, _, rest = spec.partition(":")
    params: Dict[str, object] = {"model": name.strip()}
    if rest.strip():
        for pair in rest.split(","):
            k, eq, v = pair.partition("=")
            if not eq:
                raise ValueError(
                    f"fault spec {spec!r}: expected k=v, got {pair!r}")
            params[k.strip()] = _parse_value(v.strip())
    return params


def resolve_faults(spec: FaultSpec) -> FaultModel:
    """Normalize any accepted spec form into a constructed FaultModel.

    Raises :class:`UnknownFaultModelError` for unregistered names and
    ``ValueError``/``TypeError`` for bad parameters — both before any
    simulation starts, which is what lets campaign spec validation fail
    fast on a typo'd axis value.
    """
    if spec is None:
        return NoFaults()
    if isinstance(spec, FaultModel):
        return spec
    if isinstance(spec, str):
        params = parse_fault_spec(spec)
    elif isinstance(spec, Mapping):
        params = dict(spec)
        if "model" not in params:
            raise ValueError(f"fault spec dict needs a 'model' key: {spec!r}")
    else:
        raise TypeError(f"unsupported fault spec type: {type(spec).__name__}")
    name = str(params.pop("model"))
    factory = get_fault_model(name)
    try:
        return factory(**params)
    except TypeError as exc:
        raise ValueError(f"fault model {name!r}: {exc}") from exc


def fault_spec_label(spec: FaultSpec) -> str:
    """A short deterministic label for cell names and regime keys."""
    if spec is None:
        return "none"
    if isinstance(spec, str):
        return spec
    if isinstance(spec, Mapping):
        name = spec.get("model", "?")
        rest = ",".join(f"{k}={spec[k]}" for k in sorted(spec) if k != "model")
        return f"{name}:{rest}" if rest else str(name)
    return getattr(spec, "name", str(spec))
