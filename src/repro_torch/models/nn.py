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
CPU). The reference's sharding constraints, gradient taps and bfloat16-output
switch belong to the distributed and training slices and are not here.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Param:
    shape: tuple[int, ...]
    init: str = "normal"                 # "normal"|"ones"|"embed"|"scaled"
    dtype: torch.dtype = torch.bfloat16

    def materialize(self, generator: torch.Generator, device: torch.device) -> torch.Tensor:
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


def param_count(defs: dict) -> int:
    total = 0
    for _, p in _leaves(defs):
        n = 1
        for s in p.shape:
            n *= s
        total += n
    return total


# ---------------------------------------------------------------------------
# Stateless layer math
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) in x's type, float32 accumulation."""
    return torch.matmul(x, w.to(x.dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with ``sigmoid = 1 / (1 + exp(-x))``, every op rounded
    to x's type: the reference's bfloat16 ``jax.nn.silu`` rounds at these places
    (a fused float32 sigmoid differs in the last bit for about a third of
    bfloat16 inputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return dense(silu(dense(x, w_gate)) * dense(x, w_up), w_down)


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.to(torch.int64)]
