"""AdamW with float32 master weights: the port of ``repro/optim/adamw.py``.

The update is the reference's, not ``torch.optim.AdamW``'s: after a
global-norm clip scale, each leaf's float32 master moves by
``lr * ((m / c1) / (sqrt(v / c2) + eps) + wd * p)`` -- weight decay inside the
step, with ``c1 = 1 - b1 ** count`` a float32 power -- and the new parameters
are the master cast to each parameter's type. The state is
``{"m", "v", "master", "count"}`` (``count`` an int32 0-d tensor); every
function returns new tensors and leaves its inputs as they were.

The leaves may be DTensors (the sharded step): every update is elementwise,
so the state keeps the parameters' layout, and ``global_norm``'s sums reduce
over whole tensors (a partial sum is reduced before the square root).

Leaves are taken in JAX's flatten order (``repro_torch.pytree``: sorted dict
keys), so ``global_norm``'s Python sum adds the leaves' squares in the
reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: Any) -> dict:
    """Zero moments, float32 master copies, ``count`` 0, on the parameters' devices."""
    f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    first = pytree.leaves(params)[0]
    return {
        "m": pytree.tree_map(f32, params),
        "v": pytree.tree_map(f32, params),
        "master": pytree.tree_map(lambda p: p.detach().to(torch.float32).clone(), params),
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a float32 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in pytree.leaves(tree)))


def adamw_update(grads: Any, state: dict, lr: torch.Tensor, cfg: AdamWConfig,
                 params: Any) -> tuple[Any, dict]:
    """Returns (new params in their original types, new state)."""
    count = state["count"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=gn.device),
                         count.to(torch.float32))
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=gn.device),
                         count.to(torch.float32))

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + cfg.weight_decay * p
        return m, v, p - lr * step

    flat_g = pytree.leaves(grads)
    out = [upd(g, m, v, p) for g, m, v, p in zip(
        flat_g, pytree.leaves(state["m"]), pytree.leaves(state["v"]),
        pytree.leaves(state["master"]))]
    new_state = {"m": pytree.unflatten(grads, [o[0] for o in out]),
                 "v": pytree.unflatten(grads, [o[1] for o in out]),
                 "master": pytree.unflatten(grads, [o[2] for o in out]),
                 "count": count}
    new_params = pytree.tree_map(lambda mst, p: mst.to(p.dtype), new_state["master"], params)
    return new_params, new_state
