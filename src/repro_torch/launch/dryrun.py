"""Multi-pod dry run: trace every (arch x shape x mesh) cell without hardware.

The port's counterpart of `repro.launch.dryrun`.  Proves the distribution
config is coherent with no card and in one process: builds the production
mesh on the `fake` process-group backend (256 or 512 ranks, whose
collectives move nothing), builds the train state, params, inputs and caches
as DTensors with the placements of `repro_torch.sharding` over fake CPU
tensors (shapes and dtypes, no memory), runs the real train / prefill /
decode step once on them, and records per device:

  * memory: the argument and output bytes, exactly, from the placements;
    the peak bytes live during the step from `torch.distributed._tools`'
    MemTracker over the fake tensors, where the installed torch has it
    (absent otherwise);
  * cost.flops: the FLOPs of the step's matrix products at one rank's
    shapes (`hlo_analysis.PerRankFlops`);
  * collectives: count and bytes per kind, all-reduce counted 2x
    (`hlo_analysis.Collectives`).

These are counts from a trace, not device measurements.  A cell that
fails records its error string instead.

Usage:
    python -m repro_torch.launch.dryrun                    # all cells, both meshes
    python -m repro_torch.launch.dryrun --arch deepseek-v2-236b --shape train_4k
    python -m repro_torch.launch.dryrun --multi-pod        # 2x16x16 cells only
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import (SHAPES_BY_NAME, applicable_shapes, decode_step, init_cache,
                                init_params, prefill, set_mesh)
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.sharding import (at_path, batch_sharding, cache_shardings, dp_axes,
                                  leaves_with_paths, map_with_path, tree_shardings)
from repro_torch.training import AdamW, input_specs, make_train_state, make_train_step


def as_dtensors(tree, tree_pl, mesh):
    """Each meta leaf of `tree` as a DTensor of the same global shape and
    dtype with the placements at its path in `tree_pl`, its local shard an
    uninitialised CPU tensor (a fake one under FakeTensorMode)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def one(path, t):
        pl = at_path(tree_pl, path)
        local = list(t.shape)
        for axis, p in zip(mesh.mesh_dim_names, pl):
            if isinstance(p, Shard):
                local[p.dim] //= sizes[axis]
        return DTensor.from_local(torch.empty(local, dtype=t.dtype), mesh, pl,
                                  run_check=False, shape=t.shape, stride=t.stride())
    return map_with_path(one, tree)


def device_bytes(tree) -> int:
    """Bytes one rank holds of the DTensor (or plain tensor) leaves."""
    return sum((t._local_tensor if isinstance(t, DTensor) else t).numel() * t.element_size()
               for _, t in leaves_with_paths(tree) if isinstance(t, torch.Tensor))


def build_traceable(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Returns (fn, args): the step of `shape.kind` and its DTensor
    arguments with the placements of `repro_torch.sharding`.  Call under
    FakeTensorMode, with the mesh set (`models.set_mesh`)."""
    params = init_params(cfg, device="meta")
    if shape.kind == "train":
        opt = AdamW()
        state = make_train_state(params, opt)
        state_pl = tree_shardings(state, cfg, mesh)
        batch = input_specs(cfg, shape)
        batch_pl = batch_sharding(batch, mesh, axes=dp_axes(cfg, mesh))
        fn = make_train_step(cfg, opt, microbatches=cfg.train_microbatches,
                             grad_shardings=state_pl.params)
        return fn, (as_dtensors(state, state_pl, mesh), as_dtensors(batch, batch_pl, mesh))
    pdt = as_dtensors(params, tree_shardings(params, cfg, mesh), mesh)
    spec = input_specs(cfg, shape)
    ins = as_dtensors(spec, batch_sharding(spec, mesh), mesh)
    if shape.kind == "prefill":
        return (lambda p, t, e: prefill(p, t, cfg, extra=e)), (pdt, ins["tokens"], ins["extra"])
    # decode: one new token a sequence at the cache's last row
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    cdt = as_dtensors(cache, cache_shardings(cache, cfg, mesh, shape), mesh)
    pos = shape.seq_len - 1
    return (lambda p, c, t: decode_step(p, c, t, pos, cfg)), (pdt, cdt, ins["tokens"])


def _peak_tracker():
    """torch's fake-tensor memory tracker, or None where torch has none."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError:
        return None
    return MemTracker()


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Trace one step of `shape` on `mesh` (set as the model's mesh for the
    trace) and return its memory, cost and collectives, one rank's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    set_mesh(mesh, dp_axes(cfg, mesh))
    try:
        # the arguments are built under the fake mode; the step runs with no
        # fake mode active (its fake tensors carry theirs), so the ops
        # DTensor's sharding propagation runs on global shapes, under a
        # mode of its own, are told apart from the ranks' work
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args = build_traceable(cfg, shape, mesh)
        tracker = _peak_tracker()
        if tracker is not None:
            tracker.track_external(*[t for _, t in leaves_with_paths(args)
                                     if isinstance(t, torch.Tensor)])
            with tracker:
                out, counts, collectives = hlo_analysis.analyze(fn, *args)
            peak = tracker.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
        else:
            out, counts, collectives = hlo_analysis.analyze(fn, *args)
    finally:
        set_mesh(None)
    memory = {"argument_bytes": device_bytes(args), "output_bytes": device_bytes(out)}
    if tracker is not None:
        memory["peak_bytes"] = int(peak)
    return {"memory": memory, "cost": {"flops": counts["dot_flops"] + counts["conv_flops"]},
            "collectives": collectives, "scan_aware": counts}


def _apply_overrides(cfg: ModelConfig, overrides: dict) -> ModelConfig:
    """Flat (remat=full) and nested (xlstm.chunk=64) config overrides."""
    flat = {k: v for k, v in overrides.items() if "." not in k}
    if flat:
        cfg = cfg.with_(**flat)
    for k, v in overrides.items():
        if "." in k:
            sub, field_ = k.split(".", 1)
            cfg = cfg.with_(**{sub: dataclasses.replace(getattr(cfg, sub), **{field_: v})})
    return cfg


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides: dict = None) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    shape = SHAPES_BY_NAME[shape_name]
    if shape.name == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped",
                "reason": "full-attention arch; 500k decode is out of family "
                          "contract (DESIGN.md #4)"}
    t0 = time.time()
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    res = trace_cell(cfg, shape, mesh)
    return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "status": "ok",
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "trace_s": round(time.time() - t0, 1), **res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--force", action="store_true", help="re-run cached cells")
    ap.add_argument("--set", nargs="*", default=[], metavar="K=V",
                    help="config overrides, e.g. layout=fsdp remat=full")
    ap.add_argument("--tag", default="", help="suffix for result files")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                v = {"true": True, "false": False}.get(v.lower(), v)
        overrides[k] = v

    archs = [ALIASES.get(args.arch, args.arch)] if args.arch else list(ARCH_IDS)
    pods = []
    if args.multi_pod or not args.single_pod:
        pods.append(True)
    if args.single_pod or not args.multi_pod:
        pods.insert(0, False)
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else \
            [s.name for s in applicable_shapes(cfg)] + \
            (["long_500k"] if not cfg.subquadratic else [])
        for shape in shapes:
            for mp in pods:
                tag = f"{arch}.{shape}.{'2pod' if mp else '1pod'}"
                if args.tag:
                    tag += f".{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {tag}")
                    continue
                print(f"[trace] {tag} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mp, overrides=overrides)
                except Exception as e:
                    res = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "error", "error": repr(e)[:500],
                           "trace": traceback.format_exc()[-2000:]}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                extra = ""
                if res["status"] == "ok":
                    extra = (f" trace={res['trace_s']}s flops/dev={res['cost']['flops']:.3e} "
                             f"coll={res['scan_aware']['collective_bytes']:.2e}B")
                print(f"  -> {res['status']}{extra}", flush=True)
    print("dry-run complete; failures:", failures)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
