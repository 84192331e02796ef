"""Mesh construction over ``torch.distributed``: the port of ``repro/dist/compat.py``.

* :func:`make_mesh` builds a named ``DeviceMesh`` over the running process
  group (``torch.distributed.init_process_group`` first: one process a card,
  or gloo processes on the CPU).
* :func:`optimization_barrier` is the identity. The reference pins XLA's
  schedule with it; eager PyTorch runs each operation where it is issued, so
  there is nothing to pin.

The reference's ``shard_map`` has no counterpart: each rank is one process
that runs its own slice, and the collectives are explicit calls on the mesh
dimension's process group.
"""
from __future__ import annotations

from typing import Any

from ..device import resolve_device


def make_mesh(axis_shapes, axis_names, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` on ``device_type``
    ranks (``"cuda"`` unless the caller asks for ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device_type)
    return init_device_mesh(dev.type, tuple(int(s) for s in axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def optimization_barrier(x: Any) -> Any:
    """Identity (see the module docstring)."""
    return x


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of a stand-in with ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``: ``DeviceMesh.size(dim)``, or a stand-in's ``shape[axis]``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return int(mesh.size(names.index(axis)))
    return int(mesh.shape[axis])
