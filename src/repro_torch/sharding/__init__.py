"""Placement rules over a `DeviceMesh` (the port's `repro.sharding`)."""
from .rules import (at_path, batch_axes, batch_sharding, cache_shardings, distribute,
                    dp_axes, gathered, leaves_with_paths, map_with_path, param_spec,
                    placements, spec_of, tree_shardings)

__all__ = ["at_path", "batch_axes", "batch_sharding", "cache_shardings", "distribute",
           "dp_axes", "gathered", "leaves_with_paths", "map_with_path", "param_spec",
           "placements", "spec_of", "tree_shardings"]
