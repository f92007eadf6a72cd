"""Assigned architecture configs (one module per arch) + registry.

A data-only copy of `repro.configs` for the PyTorch port.
"""
from importlib import import_module

ARCH_IDS = (
    "xlstm_350m", "yi_9b", "llama3_8b", "chatglm3_6b", "granite_34b",
    "deepseek_v2_236b", "olmoe_1b_7b", "zamba2_1p2b", "internvl2_1b",
    "seamless_m4t_medium",
)

# public --arch names (dashes) -> module names
ALIASES = {i.replace("_", "-").replace("-1p2b", "-1.2b"): i for i in ARCH_IDS}


def get_config(name: str):
    mod = name.replace("-", "_").replace("_1.2b", "_1p2b")
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return import_module(f"repro_torch.configs.{mod}").CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
