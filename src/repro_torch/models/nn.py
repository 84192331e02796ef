"""Parameter declarations and stateless layer math: the port of ``repro/models/nn.py``.

A model is a pair of plain functions over a nested dict of parameter tensors.
Every parameter is declared as a :class:`Param` (shape, dtype, init);
``init_tree`` materializes the dict from a ``torch.Generator`` on the device.
Layer parameters are stacked ``[L, ...]`` as in the reference, and the forward
passes loop over the stack.

The rounding order is the reference's: ``rms_norm`` normalizes in float32,
casts to the input type, then multiplies by the scale in that type; ``dense``
multiplies in the operands' type with float32 accumulation and one rounding
of the output (a bfloat16 GEMM accumulates in float32 on the card and on the
CPU).

Means are XLA's: a sum times ``float32(1 / n)`` (``mean``), the way XLA on the
CPU computes the reference's ``jnp.mean``.

Two hooks that ``train.step.build_train_step`` installs, both the identity
unless installed:

* ``set_act_sharder`` / ``shard_act``: the model names each activation's
  logical axes at the reference's sites; a sharder may lay it out on a mesh.
* ``set_grad_tap`` / ``grad_tap``: the model marks where each parameter group's
  gradients become final; the overlap step installs its bucket reducer's tap
  there for the forward (``dist.bucketed_reduce.BucketReducer``).

The dry-run's bfloat16-output switch (``set_bf16_matmul_output``, off by
default): a bfloat16 GEMM here already rounds its float32 accumulation once to
bfloat16, as the reference's ``dense`` does in either mode, so the switch moves
only ``attention.flash_attention``'s operands (bfloat16 q/k/v and
probabilities, float32 statistics), as in the reference.

Sharded activations are DTensors (``train.step`` installs a sharder that
redistributes them). :func:`per_shard` runs a function that is parallel over
named dimensions (batch, heads) on each rank's local blocks: the chunked
attention and the recurrent scans run there as plain tensor code, where
DTensor would otherwise carry every chunk's operations.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..dist.sharding import is_dtensor


# ---------------------------------------------------------------------------
# Activation sharding constraints
# ---------------------------------------------------------------------------

_ACT_SHARDER: Callable[[torch.Tensor, tuple], torch.Tensor] | None = None


def set_act_sharder(fn: Callable[[torch.Tensor, tuple], torch.Tensor] | None) -> None:
    global _ACT_SHARDER
    _ACT_SHARDER = fn


def shard_act(x: torch.Tensor, logical: tuple) -> torch.Tensor:
    """Apply an activation sharding constraint (identity when no sharder)."""
    if _ACT_SHARDER is None:
        return x
    return _ACT_SHARDER(x, logical)


_BF16_MATMUL_OUT = False


def set_bf16_matmul_output(on: bool) -> None:
    global _BF16_MATMUL_OUT
    _BF16_MATMUL_OUT = on


def bf16_matmul_output() -> bool:
    return _BF16_MATMUL_OUT


_REPEAT_HOOK: Callable[[float], Any] | None = None


def set_repeat_hook(fn: Callable[[float], Any] | None) -> None:
    global _REPEAT_HOOK
    _REPEAT_HOOK = fn


def repeated(n: float):
    """A context whose operations stand for ``n`` runs of themselves: a cost
    trace (``launch.hlo_cost``) counts them ``n`` times; nothing else changes."""
    return _REPEAT_HOOK(n) if _REPEAT_HOOK is not None else contextlib.nullcontext()


def per_shard(fn: Callable, args: list, roles: list[dict], out_roles: list[dict]):
    """``fn(*args)`` on each rank's local blocks, for a function that is parallel
    over the dimensions named in ``roles``.

    ``roles[i]`` maps a dimension of ``args[i]`` to a role name (``"batch"``,
    ``"heads"``); ``out_roles`` does the same for each of ``fn``'s outputs (a
    tuple, or one tensor), and its key ``"sum"`` (``"max"``) names a role that
    the function reduces away: the output is a partial sum (max) over that
    role's ranks. A role is split over the mesh dimensions that split
    it in the first DTensor argument that has it, unless some argument's size
    there does not divide; every other dimension is replicated first. An
    argument replicated where the call is split gets its gradient summed over
    those ranks. Without a DTensor argument this is ``fn(*args)``.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    mesh = first.device_mesh
    role_mesh: dict[str, list[int]] = {}
    for a, r in zip(args, roles):
        if isinstance(a, DTensor):
            for d, role in r.items():
                if role not in role_mesh:
                    role_mesh[role] = [m for m, p in enumerate(a.placements) if p.is_shard(d)]
    for role, dims in role_mesh.items():
        n = 1
        for m in dims:
            n *= mesh.size(m)
        if any(a.shape[d] % n for a, r in zip(args, roles) for d, ro in r.items()
               if ro == role):
            role_mesh[role] = []
    split = {m for dims in role_mesh.values() for m in dims}

    def placements(r: dict) -> list:
        pl = [Replicate()] * mesh.ndim
        for d, role in r.items():
            for m in role_mesh.get(role, []):
                pl[m] = Partial(d) if d in ("sum", "max") else Shard(d)
        return pl

    locs = []
    for a, r in zip(args, roles):
        pl = placements(r)
        if isinstance(a, DTensor):
            grad_pl = [Partial() if m in split and p.is_replicate() else p
                       for m, p in enumerate(pl)]
            locs.append(a.redistribute(mesh, pl).to_local(grad_placements=grad_pl))
        elif isinstance(a, torch.Tensor):
            from ..dist.sharding import local_slice
            locs.append(local_slice(a, mesh, pl))
        else:
            locs.append(a)
    outs = fn(*locs)
    single = not isinstance(outs, tuple)
    wrapped = tuple(DTensor.from_local(o, mesh, placements(r), run_check=False)
                    for o, r in zip((outs,) if single else outs, out_roles))
    return wrapped[0] if single else wrapped


def cache_slots(x: torch.Tensor, extra: int) -> torch.Tensor:
    """K or V (B, S, H, D) padded with ``extra`` zero slots past the sequence,
    as bfloat16: a cache leaf. On DTensors, per shard of batch and heads."""
    pad = (0, 0, 0, 0, 0, extra)
    if is_dtensor(x):
        bh = {0: "batch", 2: "heads"}
        return per_shard(lambda xl: F.pad(xl, pad).to(torch.bfloat16), [x], [bh], [bh])
    return F.pad(x, pad).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Gradient-boundary taps
# ---------------------------------------------------------------------------

_GRAD_TAP: Callable[[Any, str], Any] | None = None


def set_grad_tap(fn: Callable[[Any, str], Any] | None) -> None:
    global _GRAD_TAP
    _GRAD_TAP = fn


def grad_tap(tree: Any, name: str = "") -> Any:
    """Mark a parameter-group gradient boundary (identity unless installed)."""
    if _GRAD_TAP is None:
        return tree
    return _GRAD_TAP(tree, name)


@dataclasses.dataclass(frozen=True)
class Param:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...] = ()   # logical axis per dim: "fsdp"|"tp"|None
    init: str = "normal"                 # "normal"|"zeros"|"ones"|"embed"|"scaled"
    dtype: torch.dtype = torch.bfloat16

    def materialize(self, generator: torch.Generator, device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "embed":
            std = 0.02
        elif self.init in ("normal", "scaled"):
            # the reference's rule: fan-in is the second-to-last dim (the only
            # one of a 1D shape); normal: fan_in**-0.5, scaled: (2/fan_in)**0.5
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[0]
            std = (2.0 / max(fan_in, 1)) ** 0.5 if self.init == "scaled" else fan_in ** -0.5
        else:
            raise ValueError(f"unknown init {self.init!r}")
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return (x.mul_(std)).to(self.dtype)


def _leaves(defs: dict, prefix=()):
    """(path, Param) pairs in sorted-key order, the order JAX flattens a dict."""
    for key in sorted(defs):
        val = defs[key]
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def init_tree(defs: dict, generator: torch.Generator | None = None, *,
              device="cuda") -> dict:
    """Materialize a nested dict of :class:`Param` declarations on ``device``.

    ``generator`` (default: a new one seeded 0 on ``device``) draws every
    leaf in turn, in sorted-key order. Its numbers are not the reference's
    ``jax.random`` numbers; parity tests carry the reference's parameters over
    with ``interop.params_from_reference`` instead.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot fill tensors on {dev}")
    out: dict = {}
    for path, p in _leaves(defs):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.materialize(generator, dev)
    return out


def spec_tree(defs: dict) -> dict:
    """The matching tree of logical-axis tuples (resolved against a mesh by
    ``dist.sharding``)."""
    return {k: spec_tree(v) if isinstance(v, dict) else v.logical for k, v in defs.items()}


def param_count(defs: dict) -> int:
    total = 0
    for _, p in _leaves(defs):
        n = 1
        for s in p.shape:
            n *= s
        total += n
    return total


def unstack(stack: dict) -> list[dict]:
    """A ``[L, ...]`` layer stack as L per-layer dicts: one ``torch.unbind`` a
    leaf, whose backward stacks the layers' gradients once."""
    names = sorted(stack)
    return [dict(zip(names, slices))
            for slices in zip(*(torch.unbind(stack[n], 0) for n in names))]


# ---------------------------------------------------------------------------
# Stateless layer math
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def mean(x: torch.Tensor, dim: int | None = None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean`` as XLA computes it: the sum times ``float32(1 / n)``."""
    n = x.numel() if dim is None else x.shape[dim]
    total = torch.sum(x) if dim is None else torch.sum(x, dim=dim, keepdim=keepdim)
    return total * float(np.float32(1.0 / n))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = mean(xf, dim=-1, keepdim=True)
    var = mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) in x's type, float32 accumulation.

    On DTensors, ``x``'s contracted dimension stays split only on the mesh
    dimensions that split ``w``'s rows (the row-parallel product, a partial
    sum); elsewhere it is gathered first, and a partial sum is reduced first,
    so that ``w``'s columns keep their split (the column-parallel product)
    and no rank computes every column. A row-parallel product's partial sums
    are reduced at once, so no partial sum enters the residual stream."""
    if is_dtensor(x) and is_dtensor(w):
        from torch.distributed.tensor import Replicate
        last = x.ndim - 1
        pl = [Replicate() if p.is_partial() or (p.is_shard(last)
                                                 and not w.placements[m].is_shard(0)) else p
              for m, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
        y = torch.matmul(x, w.to(x.dtype))
        if any(p.is_partial() for p in y.placements):
            # the row-parallel product's sum over its ranks (Megatron's all-reduce)
            y = y.redistribute(y.device_mesh, [Replicate() if p.is_partial() else p
                                               for p in y.placements])
        return y
    return torch.matmul(x, w.to(x.dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, every op rounded to x's type: the reference's
    bfloat16 ``jax.nn.sigmoid`` rounds at these places (a fused float32
    sigmoid differs in the last bit for about a third of bfloat16 inputs)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, each op rounded to x's type, as the reference's
    bfloat16 ``jax.nn.silu``."""
    return x * sigmoid(x)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return dense(silu(dense(x, w_gate)) * dense(x, w_up), w_down)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """With ``gelu``, the reference's ``jax.nn.gelu`` (the tanh approximation)."""
    h = gelu(dense(x, w_up) + b_up.to(x.dtype))
    return dense(h, w_down) + b_down.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)``: ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))``
    op by op in x's type, each rounded to it, with both constants in that type,
    as the reference computes it (``F.gelu`` rounds once, a few bfloat16 ulps
    away)."""
    c = torch.tensor(_SQRT_2_OVER_PI, dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table``. ``F.embedding``'s backward is a dense, deterministic
    accumulation on the card (indexing's backward is an atomic ``index_put``)."""
    return F.embedding(tokens.to(torch.int64), table)


def sharded_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy in float32: the max is detached (the
    reference's ``stop_gradient``), then the log-sum-exp, then the mean over
    tokens."""
    lf = logits.to(torch.float32)
    if is_dtensor(lf):
        return mean(_sharded_lse_minus_gold(lf, labels))
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    gold = torch.take_along_dim(lf, labels.to(torch.int64)[..., None], dim=-1)[..., 0]
    return mean(lse - gold)


def _sharded_lse_minus_gold(lf, labels):
    """``sharded_xent``'s per-token terms on vocab-sharded DTensor logits: the
    max, the exp-sum and the label's column each on the rank's own columns
    (``per_shard``), then reduced over the vocabulary's ranks, so no rank holds
    a whole vocabulary row."""
    from torch.distributed.tensor import Replicate
    mesh = lf.device_mesh
    vdims = [m for m, p in enumerate(lf.placements) if p.is_shard(lf.ndim - 1)]
    coord, r = mesh.get_coordinate(), 0
    for m in vdims:
        r = r * mesh.size(m) + coord[m]
    v, bs = {0: "batch", 1: "seq", 2: "vocab"}, {0: "batch", 1: "seq"}
    m = per_shard(lambda ll: torch.amax(ll, dim=-1), [lf.detach()], [v],
                  [{0: "batch", 1: "seq", "max": "vocab"}])
    m = m.redistribute(mesh, [Replicate() if p.is_partial() else p for p in m.placements])
    sumexp = per_shard(lambda ll, mm: torch.sum(torch.exp(ll - mm[..., None]), dim=-1),
                       [lf, m], [v, bs], [{0: "batch", 1: "seq", "sum": "vocab"}])

    def pick(ll, lab):
        cols = torch.arange(ll.shape[-1], device=ll.device) + r * ll.shape[-1]
        return torch.sum(torch.where(cols == lab.to(torch.int64)[..., None], ll, 0.0), -1)
    gold = per_shard(pick, [lf, labels], [v, bs], [{0: "batch", 1: "seq", "sum": "vocab"}])
    return torch.log(sumexp) + m - gold
