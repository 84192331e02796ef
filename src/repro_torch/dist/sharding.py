"""Logical-axis sharding resolution: the port of ``repro/dist/sharding.py``.

Models declare per-dimension *logical* axes and never see a mesh. This module
owns the logical vocabulary and resolves it against any mesh:

  * ``fsdp`` -- parameter/optimizer sharding (ZeRO-style);
  * ``tp``   -- tensor parallel (heads / ffn / vocab / experts);
  * ``dp``   -- batch parallelism; spans ``(pod, data)`` on multi-pod meshes;
  * ``None`` -- replicated.

Resolution rules (the reference's, entry for entry):
  * a dimension shards only if its size is divisible by the product of the
    assigned mesh axes; otherwise the longest divisible suffix of the axes is
    used, then replication;
  * a mesh axis is used at most once per spec (first dimension wins);
  * unknown logical names and absent mesh axes resolve to replication.

:func:`resolve_spec` reads only a mesh's axis names and sizes, so a stand-in
with ``axis_names`` and a ``shape`` dict works as in the reference; it returns
a tuple whose entries equal the reference's ``PartitionSpec`` entries.
:func:`tree_shardings` turns specs into DTensor placements on a ``DeviceMesh``.

DTensor stands in for GSPMD: :func:`distribute_tree` lays a tree of full
tensors out as DTensors (each rank keeps its slice; no collective, since every
rank holds the same full values), :func:`gather_tree` is its inverse
(``full_tensor()``), and :func:`sharded_ops` is the context a sharded step
runs in: plain tensors mix with DTensors as replicated values
(``implicit_replication``), and a view that DTensor cannot split evenly
(``(B, S, 2 * 32)`` sharded 4 ways into ``(B, S, 2, 32)``) first replicates
the tensor, where XLA would insert the same reshard.

``set_profile("zero3")`` turns the model axis into extra data parallelism, as
in the reference.
"""
from __future__ import annotations

import dataclasses
import contextlib
from typing import Any, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import pytree
from . import compat

_PROFILES = ("tp", "zero3")
_profile = "tp"


def set_profile(name: str) -> None:
    """Select the parameter-layout profile ("tp" | "zero3")."""
    global _profile
    if name not in _PROFILES:
        raise ValueError(f"unknown sharding profile {name!r}; want one of {_PROFILES}")
    _profile = name


def get_profile() -> str:
    return _profile


def logical_to_mesh_axes(mesh) -> dict[str, tuple[str, ...]]:
    """The logical-name -> mesh-axes table for ``mesh`` under the profile."""
    names = compat.axis_names(mesh)
    dp = ("pod", "data") if "pod" in names else ("data",)
    if _profile == "zero3":
        table = {"fsdp": ("data", "model"), "tp": (), "dp": dp + ("model",)}
    else:
        table = {"fsdp": ("data",), "tp": ("model",), "dp": dp}
    return {k: tuple(a for a in v if a in names) for k, v in table.items()}


def resolve_spec(logical: Sequence[str | None], shape: Sequence[int], mesh) -> tuple:
    """Resolve a per-dimension logical spec into the mesh axes of each dimension.

    Each entry is None (replicated), an axis name, or a tuple of names (the
    dimension split over several axes, the first outermost).
    """
    table = logical_to_mesh_axes(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for i, dim in enumerate(shape):
        name = logical[i] if i < len(logical) else None
        if name is None:
            entries.append(None)
            continue
        axes = tuple(a for a in table.get(name, ()) if a not in used)
        chosen: tuple[str, ...] = ()
        for start in range(len(axes)):
            cand = axes[start:]
            size = 1
            for a in cand:
                size *= compat.axis_size(mesh, a)
            if size > 1 and dim % size == 0:
                chosen = cand
                break
        if not chosen:
            entries.append(None)
            continue
        used.update(chosen)
        entries.append(chosen[0] if len(chosen) == 1 else chosen)
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a ``DeviceMesh``; ``placements`` are DTensor's."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec``: ``Shard(d)`` on each mesh dimension that
    splits tensor dimension ``d``, ``Replicate()`` elsewhere.

    A tensor dimension split over several mesh axes is split outermost by
    the first, as the reference lays it out; DTensor splits outermost by the
    lower mesh dimension, so those axes must follow the mesh's order.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = compat.axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {axes} of dimension {d} are not in the mesh's order "
                             f"{names}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


def _is_logical_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(e is None or isinstance(e, str) for e in x))


def tree_shardings(logical_tree: Any, abstract_tree: Any, mesh) -> Any:
    """A :class:`NamedSharding` for each leaf of ``abstract_tree`` (anything with a
    ``.shape``: tensors, meta tensors), laid out per ``logical_tree``, which
    mirrors it with tuple-of-logical-names leaves (``()`` for scalars)."""
    specs = _logical_leaves(logical_tree)
    ab = pytree.leaves(abstract_tree)
    if len(specs) != len(ab):
        raise ValueError(f"logical tree has {len(specs)} leaves, the tree {len(ab)}")
    out = [NamedSharding(mesh, resolve_spec(() if s is None else tuple(s), tuple(a.shape), mesh))
           for s, a in zip(specs, ab)]
    return pytree.unflatten(abstract_tree, out)


def _logical_leaves(tree: Any) -> list:
    """The logical specs of a tree in JAX's order (a spec tuple, or None, is a leaf)."""
    if _is_logical_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _logical_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _logical_leaves(v)]
    raise TypeError(f"not a logical spec tree: {tree!r}")


# ---------------------------------------------------------------------------
# DTensor trees
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` (a view, no copy)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(tuple(full.shape), mesh,
                                                          list(placements))
    return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def distribute(full: torch.Tensor, sharding: NamedSharding):
    """``full`` (the same values on every rank, or a meta tensor) as a DTensor laid
    out by ``sharding``: each rank keeps its own block."""
    from torch.distributed.tensor import DTensor
    pl = sharding.placements
    return DTensor.from_local(local_slice(full, sharding.mesh, pl).contiguous(),
                              sharding.mesh, pl, run_check=False,
                              shape=full.shape, stride=_contiguous_stride(full.shape))


def _contiguous_stride(shape) -> tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def distribute_tree(tree: Any, logical_tree: Any, mesh) -> Any:
    """Full tensors -> DTensors on ``mesh``, each laid out by its logical spec
    (:func:`tree_shardings`). Leaves that are DTensors already are gathered first."""
    return distribute_like(tree, tree_shardings(logical_tree, tree, mesh))


def distribute_like(tree: Any, shardings: Any) -> Any:
    """:func:`distribute` over a tree of :class:`NamedSharding` (``info["params"]``)."""
    return pytree.tree_map(lambda x, sh: distribute(gather(x), sh), tree, shardings)


def gather(x):
    """A DTensor's full value on every rank (a collective); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def gather_tree(tree: Any) -> Any:
    """The inverse of :func:`distribute_tree`: every DTensor leaf as its full tensor."""
    return pytree.tree_map(gather, tree)


_VIEWS = None


class _EvenViews(TorchDispatchMode):
    """Replicates a DTensor before a view that would split a sharded dimension
    unevenly; every other operation goes on to DTensor as it is."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        if func in _VIEWS and isinstance(args[0], DTensor):
            try:
                return func(*args, **kwargs)
            except RuntimeError:
                # DTensor refuses to split a sharded dimension here (its words
                # differ between versions); a view of the replicated tensor is
                # the same view
                x = args[0]
                if not any(p.is_shard() for p in x.placements):
                    raise
                pl = [Replicate() if p.is_shard() else p for p in x.placements]
                return func(x.redistribute(x.device_mesh, pl), *args[1:], **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return func(*args, **kwargs)


@contextlib.contextmanager
def sharded_ops():
    """The context of a sharded forward and backward (see the module docstring)."""
    global _VIEWS
    from torch.distributed.tensor.experimental import implicit_replication
    aten = torch.ops.aten
    _VIEWS = _VIEWS or {aten.view.default, aten._unsafe_view.default,
                        aten.reshape.default}
    with implicit_replication(), _EvenViews():
        yield
