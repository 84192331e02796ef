"""Multi-pod dry-run: build every (arch x shape x mesh) cell on a fake mesh and
count it. The port of ``repro/launch/dryrun.py``:

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --out results/dryrun   # every cell

What stands in for XLA's compile:

1. **The mesh.** One process joins a fake process group of 256 ranks
   (``single``, (16, 16) ``data x model``) or 512 (``multi``, (2, 16, 16)
   ``pod x data x model``): ``torch.testing._internal.distributed.fake_pg``'s
   ``FakeStore`` and backend ``"fake"``, then ``launch.mesh``'s production
   layout. Its collectives move nothing. The mesh is a ``cuda`` mesh where
   this PyTorch has CUDA and a ``cpu`` mesh elsewhere; nothing runs on it.
2. **The tensors.** Parameters, optimizer state, error state, inputs and
   caches are DTensors by the step builders' shardings, whose local blocks are
   ``meta`` tensors: shapes and types, no storage. (PyTorch's
   ``FakeTensorMode`` would serve as well for the values, but it also fakes
   the small index tensors DTensor computes for its own layouts, and then
   DTensor cannot read them.) The pod hop's K4 and K6 run through their
   custom ops' fake implementations (``kernels/ops.py``).
3. **The gate.** The step runs to its end (every operation found a DTensor
   sharding rule) and the per-device peak fits the card's 80 GB
   (``hlo_analysis.HBM_BYTES``): arguments plus the live-bytes tally of the
   dispatch trace (``hlo_cost.CostTrace``). Nothing is donated: eager
   PyTorch holds the old state until the step returns (``alias_bytes`` 0).
4. **The counts.** ``hlo_cost.analyze`` over the trace: per-device FLOPs,
   dot-adjacent bytes, ring-model collective bytes with pod attribution.
   Eager PyTorch runs every loop, so nothing recovers a trip count, and a
   full-depth step would run every layer and every attention chunk pair.
   Instead each cell is counted at depth 1 and at depth 2 (zamba2 in
   superblocks, the reference's depth unit) and extrapolated linearly to the
   full depth; ``extrapolated_from`` says so in the cell's JSON. Within a
   layer, a forward on meta tensors runs one chunk pair of the chunked
   attention and counts it for all (``nn.repeated``): dbrx-132b prefill_32k
   has 4,096 pairs a layer, and running each costs the host far more than
   the count does. ``cost_model.flops_by_site`` splits the FLOPs by the
   source line that issued each product.
5. writes one JSON per cell under ``--out`` with the reference's keys
   (resumable: existing files skip). ``full.flops_raw_xla``,
   ``bytes_raw_xla`` and ``hlo_text_bytes`` are None: there is no XLA.

The compressed cell (``--compressed-grads``) runs the bucketed (overlap)
form, so its cross-pod bytes come per bucket; they are checked against
``dist.bucketed_reduce.expected_cross_pod_bytes`` at each counted depth
(``bucket_check``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (any other
    group is ended first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def end_fake_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A DeviceMesh of ``shape`` over a fake group of as many ranks."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    start_fake_group(n)
    return init_device_mesh("cuda" if torch.cuda.is_available() else "cpu", tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_mesh(multi_pod: bool):
    """The reference's production layouts: (16, 16) or (2, 16, 16)."""
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return fake_mesh((16, 16), ("data", "model"))


def _set_opt(opt: str) -> None:
    from repro_torch.dist import sharding as shd
    from repro_torch.models import attention, nn
    nn.set_bf16_matmul_output("bf16" in opt)
    shd.set_profile("zero3" if "zero3" in opt else "tp")
    attention.set_causal_skip("cskip" in opt)


def _depth_unit(cfg) -> int:
    """Layers a unit of depth: zamba2's superblock, else one layer."""
    return cfg.shared_attn_every or 1


def _locals(tree) -> list:
    import torch
    from repro_torch import pytree
    from repro_torch.dist import sharding as shd
    return [t.to_local() if shd.is_dtensor(t) else t for t in pytree.leaves(tree)
            if isinstance(t, torch.Tensor)]


def _storages(tree) -> set[int]:
    return {id(t.untyped_storage()) for t in _locals(tree)}


def _local_bytes(tree, skip: set[int] = frozenset()) -> int:
    """Bytes of this rank's blocks of a tree's tensors, less those in ``skip``'s storages."""
    return sum(t.numel() * t.element_size() for t in _locals(tree)
               if id(t.untyped_storage()) not in skip)


def _laid_out_bytes(structs: dict, shardings: dict) -> int:
    """Bytes of one rank's blocks of full-shaped ``structs`` under ``shardings``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    total = 0
    for k, t in structs.items():
        sh = shardings[k]
        shape, _ = compute_local_shape_and_global_offset(tuple(t.shape), sh.mesh,
                                                         list(sh.placements))
        n = 1
        for d in shape:
            n *= d
        total += n * t.element_size()
    return total


def count_step(cfg, shape, mesh, *, compressed_grads: bool = False,
               microbatches: int = 1) -> dict:
    """Build the step of ``shape``'s kind for ``cfg`` on ``mesh``, run it once on
    meta DTensors under a dispatch trace, and return the counts (``cost``, the
    memory tally, the bucket check)."""
    import torch
    from repro_torch.dist import bucketed_reduce as bkt
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.compressed_allreduce import GradCompressionConfig
    from repro_torch.launch import hlo_cost
    from repro_torch.models import zoo
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import (TrainConfig, build_decode_step, build_prefill_step,
                                        build_train_step)
    model = zoo.build(cfg)
    names = tuple(mesh.mesh_dim_names)
    dpp = None
    if "pod" in names:
        dpp = mesh.size() // mesh.size(names.index("pod"))
    plan = gc = None
    if shape.kind == "train":
        gc = GradCompressionConfig(enabled=compressed_grads, overlap=compressed_grads,
                                   kernel_mode="fused")
        tcfg = TrainConfig(microbatches=microbatches, grad_compress=gc)
        step, info = build_train_step(model, shape, mesh, tcfg, device="meta")
        plan = info["plan"]
        params = shd.distribute_like(model.abstract_params(), info["params"])
        opt = adamw_init(params)
        err = info["make_err_state"](model.abstract_params())
        args = (params, opt, err, 0, info["input_structs"])
    elif shape.kind == "prefill":
        step, info = build_prefill_step(model, shape, mesh)
        params = shd.distribute_like(model.abstract_params(), info["params"])
        args = (params, info["input_structs"])
    else:
        step, info = build_decode_step(model, shape, mesh)
        params = shd.distribute_like(model.abstract_params(), info["params"])
        cache = shd.distribute_like(info["cache_structs"], info["cache"])
        args = (params, cache, info["input_structs"])
    arg_bytes = (_local_bytes(args[:-1])
                 + _laid_out_bytes(info["input_structs"], info["batch"]))
    with torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
        out, trace = hlo_cost.record(step, *args)
    cost = hlo_cost.analyze(trace, devices_per_pod=dpp, tag_pattern=bkt.BUCKET_TAG_PATTERN)
    # eager keeps the old state until the step returns: nothing aliases, and the
    # decode step's in-place cache is an argument, not an output
    out_bytes = _local_bytes(out, skip=_storages(args))
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": max(trace.peak - out_bytes, 0), "alias_bytes": 0}
    check = None
    if plan is not None and dpp:
        want = bkt.expected_cross_pod_bytes(plan, gc, n_pods=mesh.size(names.index("pod")))
        got = {t: d.get("all-gather", 0.0) for t, d in cost["cross_pod_by_tag"].items()}
        check = {"ok": got == {t: float(v) for t, v in want.items()},
                 "buckets": len(want), "expected": want, "counted": got}
    return {"cost": cost, "memory": mem, "bucket_check": check,
            "param_count": model.param_count(),
            "active_param_count": model.active_param_count()}


def _extrapolate(a, b, k: float):
    """``a + k (b - a)`` over numbers and nested dicts of numbers."""
    if isinstance(a, dict):
        return {key: _extrapolate(a.get(key, 0.0), b.get(key, 0.0), k)
                for key in sorted(set(a) | set(b))}
    return a + k * (b - a)


def run_cell(arch: str, shape_name: str, mesh_name: str, *, compressed_grads: bool = False,
             microbatches: int = 1, opt: str = "none", smoke: bool = False,
             mesh_shape: tuple[int, ...] | None = None, depths=(1, 2),
             full_depth: int | None = None) -> dict:
    """One cell's JSON (the reference's keys plus ``extrapolated_from``,
    ``bucket_check`` and ``fits``). ``smoke``, ``mesh_shape`` (instead of the
    production layout), ``full_depth`` (in depth units, instead of the
    config's) and a ``ShapeConfig`` for ``shape_name`` size a cell down for
    tests."""
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.models import zoo

    t0 = time.time()
    multi_pod = mesh_name == "multi"
    _set_opt(opt)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "compressed_grads": compressed_grads, "microbatches": microbatches,
              "opt": opt}
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    result["shape"] = shape.name
    cfg = configs.get(arch, smoke=smoke)
    unit = _depth_unit(cfg)
    full = full_depth if full_depth is not None else cfg.n_layers // unit
    if mesh_shape is not None:
        mesh = fake_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):])
    else:
        mesh = production_mesh(multi_pod)
    counts = [count_step(dataclasses.replace(cfg, n_layers=d * unit), shape, mesh,
                         compressed_grads=compressed_grads, microbatches=microbatches)
              for d in depths]
    d0, d1 = depths
    k = (full - d0) / (d1 - d0)
    cost = _extrapolate(counts[0]["cost"], counts[1]["cost"], k)
    mem = _extrapolate(counts[0]["memory"], counts[1]["memory"], k)
    full_model = zoo.build(dataclasses.replace(cfg, n_layers=full * unit))
    n_dev = mesh.size()
    result["full"] = {"memory": ha.memory_summary(mem), "flops_raw_xla": None,
                      "bytes_raw_xla": None, "hlo_text_bytes": None}
    result["devices"] = n_dev
    result["param_count"] = full_model.param_count()
    result["active_param_count"] = full_model.active_param_count()
    result["cost_model"] = cost
    result["extrapolated_from"] = {"depths": list(depths), "full_depth": full,
                                   "unit": "superblocks" if unit > 1 else "layers",
                                   "counted": [c["cost"] for c in counts]}
    result["bucket_check"] = [c["bucket_check"] for c in counts]
    terms = ha.roofline_terms(cost["flops"], cost["bytes"], cost["collective_bytes"],
                              cost.get("cross_pod_bytes", 0.0))
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    mf = ha.model_flops(result["active_param_count"], tokens, shape.kind)
    terms["model_flops"] = mf
    terms["useful_flops_ratio"] = mf / max(cost["flops"] * n_dev, 1.0)
    result["roofline"] = terms
    result["fits"] = result["full"]["memory"]["peak_device_bytes"] <= ha.HBM_BYTES
    result["elapsed_s"] = time.time() - t0
    _set_opt("none")
    return result


def main(argv=None) -> None:
    from repro_torch import configs
    from repro_torch.configs.base import cells_for

    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=list(configs.ARCH_IDS))
    p.add_argument("--shape")
    p.add_argument("--mesh", choices=["single", "multi"], default="single")
    p.add_argument("--out", default=None, help="JSON output path (or dir with --all)")
    p.add_argument("--compressed-grads", action="store_true")
    p.add_argument("--opt", default="none",  # comma list: bf16,zero3,cskip
                   help="perf variant: a comma list of bf16, zero3, cskip")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--all", action="store_true", help="run every assigned cell")
    args = p.parse_args(argv)

    try:
        if args.all:
            out_dir = args.out or "results/dryrun"
            os.makedirs(out_dir, exist_ok=True)
            failures = []
            for arch in configs.ARCH_IDS:
                for shape_name in cells_for(configs.get(arch)):
                    for mesh_name in ("single", "multi"):
                        tag = f"{arch}_{shape_name}_{mesh_name}"
                        path = os.path.join(out_dir, tag + ".json")
                        if os.path.exists(path):
                            print(f"[skip] {tag}", flush=True)
                            continue
                        try:
                            r = run_cell(arch, shape_name, mesh_name)
                            with open(path, "w") as f:
                                json.dump(r, f, indent=1)
                            print(f"[ok]   {tag} ({r['elapsed_s']:.0f}s) "
                                  f"bottleneck={r['roofline']['bottleneck']}", flush=True)
                        except Exception as e:
                            failures.append((tag, repr(e)))
                            print(f"[FAIL] {tag}: {e}", flush=True)
                            traceback.print_exc()
            if failures:
                sys.exit(1)
            return

        if args.arch is None or args.shape is None:
            p.error("--arch and --shape (or --all)")
        r = run_cell(args.arch, args.shape, args.mesh,
                     compressed_grads=args.compressed_grads,
                     microbatches=args.microbatches, opt=args.opt)
    finally:
        end_fake_group()
    print("memory:", json.dumps(r["full"]["memory"], indent=1))
    print("cost_model:", json.dumps({k: v for k, v in r["cost_model"].items()
                                     if k not in ("collective_detail", "flops_by_site")},
                                    indent=1))
    print("roofline:", json.dumps(r["roofline"], indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)


if __name__ == "__main__":
    main()
