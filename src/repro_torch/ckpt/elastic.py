"""Elastic rescaling: move a training state onto a different mesh. The port of
``repro/ckpt/elastic.py``.

On a node failure or a capacity change the mesh is re-made at the new rank
count and the state is laid out on it again:

    new_mesh  = compat.make_mesh(new_shape, axes)
    new_shard = sharding.tree_shardings(logical_specs, abstract, new_mesh)
    state     = ckpt.restore(root, template, shardings=new_shard)

Shardings are resolved from logical axis names for each mesh
(``dist/sharding.py``), so no model code changes across mesh shapes; a
dimension that does not divide falls back to replication.
"""
from __future__ import annotations

from typing import Any

from .. import pytree
from ..dist import compat
from ..dist import sharding as shd


def reshard(tree: Any, logical: Any, new_mesh) -> Any:
    """Live reshard of a tree onto ``new_mesh``: each leaf (a tensor, or a
    DTensor on another mesh, whose full value is gathered first) becomes a
    DTensor laid out per its logical spec. Every rank of ``new_mesh`` calls it."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    new_sh = shd.tree_shardings(logical, tree, new_mesh)

    def one(x, sh):
        full = x.full_tensor() if isinstance(x, DTensor) else x
        return distribute_tensor(full, sh.mesh, sh.placements)
    return pytree.tree_map(one, tree, new_sh)


def replan_batch(global_batch: int, new_mesh) -> dict:
    """Recompute the per-shard batch after a topology change."""
    names = compat.axis_names(new_mesh)
    dp = 1
    for ax in ("pod", "data"):
        if ax in names:
            dp *= compat.axis_size(new_mesh, ax)
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} not divisible by dp={dp}")
    return {"dp_shards": dp, "per_shard": global_batch // dp}
