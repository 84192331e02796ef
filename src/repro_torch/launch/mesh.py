"""Mesh construction over ``torch.distributed``: the port of ``repro/launch/mesh.py``.

Axis roles, as in the reference:
  * pod   -- inter-pod batch parallelism and the compressed gradient mean
             (``dist/compressed_allreduce.py``): one pod a rank;
  * data  -- in-pod FSDP axis (parameter/optimizer sharding and batch);
  * model -- tensor parallel.

The same axis rules as the reference: ``make_local_mesh`` builds ``("pod",
"data", "model")`` only when ``pods > 1``, so ``make_local_mesh(pods=1)`` has
no ``pod`` axis and a step built on it never compresses (the reference
behaves the same on one device). The elastic entry point ``make_mesh`` builds
any layout, a one-rank ``(1, 1, 1)`` pod mesh included.

Every function runs over the running process group and starts one when none
runs (NCCL on the card, gloo on the CPU): from torchrun's environment
(``WORLD_SIZE`` above 1, ``env://``), else a one-rank group on an in-memory
store (no port, no file); a caller that runs several ranks otherwise starts
its group first (``torch.distributed.init_process_group``). Any layout runs:
``data`` and ``model`` larger than 1 run the step on DTensors
(``train/step.py``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..dist import compat


def start_local_group(device="cuda") -> bool:
    """Start a one-rank process group if none is running. Returns True if it
    started one (the caller then owns it: ``dist.destroy_process_group()``)."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:       # started by torchrun
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def _mk(shape, axes, device):
    dev = resolve_device(device)
    start_local_group(dev)
    return compat.make_mesh(shape, axes, device_type=dev.type)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device="cuda"):
    """Elastic entry point: any (pod, data, model) / (data, model) layout."""
    return _mk(shape, axes, device)


def make_local_mesh(model_parallel: int = 1, pods: int = 1, *, device="cuda"):
    """A mesh over the running group's ranks (a one-rank group if none runs)."""
    start_local_group(device)
    n = dist.get_world_size()
    data = n // (model_parallel * pods)
    if data * model_parallel * pods != n:
        raise ValueError(f"{n} ranks do not split into {pods} pods x {model_parallel} "
                         f"model-parallel ranks")
    if pods > 1:
        return _mk((pods, data, model_parallel), ("pod", "data", "model"), device)
    return _mk((data, model_parallel), ("data", "model"), device)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}``, as the reference prints ``dict(mesh.shape)``."""
    return {name: compat.axis_size(mesh, name) for name in compat.axis_names(mesh)}
