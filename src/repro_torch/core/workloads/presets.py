"""Named scenario presets: registry-keyed Scenario factories.

A preset name is accepted anywhere Experiment accepts a workload
(``Experiment(workloads=("W1", "bursty-od", ...))``); ``get_scenario``
builds the Scenario, with keyword overrides merged into the source
params::

    get_scenario("W2", n_jobs=600, target_load=1.15)
    get_scenario("trace-replay", trace="tests/data/sample.swf")

Shipped presets:

    W1..W5        paper Table III notice mixes on the synthetic Theta
                  source (the Figure 6 evaluation grid)
    bursty-od     on-demand stress: 2.5x od projects plus injected
                  no-notice od bursts (§III-B arrival-path stress)
    diurnal       day/night arrival modulation on the Theta source
    trace-replay  SWF trace replay (requires ``trace=`` or ``path=``)

Custom presets register a factory taking keyword overrides and returning
a Scenario::

    @register_scenario("my-stress")
    def _my_stress(**over):
        return Scenario("theta", params={"target_load": 1.4, **over},
                        name="my-stress")
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from .base import Scenario, UnknownWorkloadError
from .synthetic import NOTICE_MIXES

_PRESETS: Dict[str, Callable[..., Scenario]] = {}


def register_scenario(name: str):
    """Decorator: register a ``(**overrides) -> Scenario`` factory."""
    def deco(factory: Callable[..., Scenario]):
        _PRESETS[name] = factory
        return factory
    return deco


def get_scenario(name: str, **overrides) -> Scenario:
    """Build a preset Scenario by name, merging keyword overrides."""
    try:
        factory = _PRESETS[name]
    except KeyError:
        raise UnknownWorkloadError(
            f"unknown scenario {name!r}; registered: "
            f"{', '.join(sorted(_PRESETS))}") from None
    return factory(**overrides)


def registered_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))


# ------------------------------------------------------------ paper W1-W5
def _paper_mix(mix: str) -> Callable[..., Scenario]:
    def factory(**over) -> Scenario:
        return Scenario("theta", params={"notice_mix": mix, **over}, name=mix)
    return factory


for _mix in NOTICE_MIXES:
    register_scenario(_mix)(_paper_mix(_mix))


# ------------------------------------------------------------- stress/replay
@register_scenario("bursty-od")
def _bursty_od(**over) -> Scenario:
    """On-demand arrival-path stress: more od projects, injected bursts."""
    params = {"frac_od_projects": 0.25, "notice_mix": "W1"}
    params.update(over)
    return Scenario(
        "theta", params=params,
        transforms=(("burst_inject",
                     {"n_bursts": 4, "burst_size": (4, 8),
                      "size": (64, 256), "mix": "W1"}),),
        name="bursty-od")


@register_scenario("diurnal")
def _diurnal(**over) -> Scenario:
    amplitude = over.pop("amplitude", 0.6)
    return Scenario("theta", params=over,
                    transforms=(("diurnal", {"amplitude": amplitude}),),
                    name="diurnal")


@register_scenario("trace-replay")
def _trace_replay(**over) -> Scenario:
    params = dict(over)
    if "trace" in params:
        params["path"] = params.pop("trace")
    if "path" not in params:
        raise UnknownWorkloadError(
            "scenario 'trace-replay' needs an SWF file: "
            "get_scenario('trace-replay', trace='path/to/trace.swf')")
    return Scenario("swf", params=params, name="trace-replay")
