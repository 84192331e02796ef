"""Baseline compressors the paper compares against (§4.1): the port of
``repro.core.baselines``.

* ``cusz_like``: cuSZ's dual-quantization front end, radius-clipped codes and
  canonical Huffman (plus raw outliers). Host numpy, as in the reference,
  over this package's own ``entropy.huffman_code_lengths``; its ratio is
  exact for the emitted stream.
* ``cuszx_like``: cuSZx's constant / non-constant blocks: a block whose
  range is within 2 eb stores one float mean, the others their raw values.
  Torch ops on the data's device.
* ``cuzfp_like``: a fixed-rate transform coding proxy of cuZFP: block
  floating point, ZFP's decorrelating lifting per axis, and truncation to
  the top ``rate_bits`` bit planes. No error-bounded mode, as cuZFP. Torch
  ops on the data's device.

These are torch-op proxies, not cuSZ, cuSZx or cuZFP. ``cusz_like`` and
``cuzfp_like`` are bit-identical to the reference on the CPU, ``cuszx_like``
too; see ``cuzfp_like`` for its block exponent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .entropy import huffman_code_lengths

CUSZ_RADIUS = 512  # cuSZ's default dictionary radius (1024 bins)


def _host_f32(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.detach().to("cpu", torch.float32).numpy()
    return np.asarray(data, np.float32)


@dataclasses.dataclass
class CuszLikeResult:
    reconstruction: np.ndarray
    compressed_bytes: int
    n_outliers: int

    def compression_ratio(self, raw_bytes: int) -> float:
        return raw_bytes / self.compressed_bytes


def cusz_like(data, eb_abs: float) -> CuszLikeResult:
    """cuSZ-style compression on the host (ratio-exact stream accounting)."""
    data = _host_f32(data)
    two_eb = np.float32(2 * float(eb_abs))
    q = np.rint(data / two_eb).astype(np.int64)
    delta = q
    for ax in range(q.ndim):
        delta = np.diff(delta, axis=ax, prepend=0)
    # radius clip: codes in range -> histogram bins, the rest -> outliers
    inr = np.abs(delta) < CUSZ_RADIUS
    counts = np.bincount(delta[inr] + CUSZ_RADIUS, minlength=2 * CUSZ_RADIUS)
    lengths = huffman_code_lengths(counts)
    # the stream: Huffman bits for every value (outliers emit the escape bin 0)
    esc = int(inr.size - np.count_nonzero(inr))
    payload_bits = int((counts * lengths).sum()) + esc * max(int(lengths.max()), 1)
    codebook_bytes = 2 * CUSZ_RADIUS * 4 // 8 + 1024  # canonical lengths + header
    outlier_bytes = esc * 8  # 4 B index + 4 B value
    total = payload_bits // 8 + codebook_bytes + outlier_bytes + 32
    # reconstruction (outliers kept exact, as cuSZ does)
    rec_q = delta
    for ax in range(q.ndim):
        rec_q = np.cumsum(rec_q, axis=ax)
    return CuszLikeResult(rec_q.astype(np.float32) * two_eb, total, esc)


def cuszx_like(data: torch.Tensor, eb_abs, block: int = 256) -> tuple[torch.Tensor, int]:
    """Returns (reconstruction, compressed_bytes)."""
    flat = data.reshape(-1).to(torch.float32)
    x = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    two_eb = torch.as_tensor(eb_abs, dtype=torch.float32, device=x.device) * 2
    const = (hi - lo) <= two_eb
    rec = torch.where(const, (hi + lo) / 2, x).reshape(-1)[: flat.numel()].reshape(data.shape)
    nblocks = x.shape[0]
    n_const = int(const.sum())
    return rec, (nblocks + 7) // 8 + n_const * 4 + (nblocks - n_const) * block * 4 + 32


# -- cuZFP-like -------------------------------------------------------------

def _zfp_lift(x: torch.Tensor, axis: int) -> torch.Tensor:
    """ZFP's forward decorrelating lifting on length-4 groups along ``axis``
    (int32; ``>>`` is arithmetic, sums wrap)."""
    a, b, c, d = x.movedim(axis, -1).unbind(-1)
    a = a + d; a = a >> 1; d = d - a   # noqa: E702
    c = c + b; c = c >> 1; b = b - c   # noqa: E702
    a = a + c; a = a >> 1; c = c - a   # noqa: E702
    d = d + b; d = d >> 1; b = b - d   # noqa: E702
    d = d + (b >> 1); b = b - (d >> 1)   # noqa: E702
    return torch.stack([a, b, c, d], dim=-1).movedim(-1, axis)


def _zfp_unlift(x: torch.Tensor, axis: int) -> torch.Tensor:
    a, b, c, d = x.movedim(axis, -1).unbind(-1)
    b = b + (d >> 1); d = d - (b >> 1)   # noqa: E702
    b = b + d; d = d << 1; d = d - b   # noqa: E702
    c = c + a; a = a << 1; a = a - c   # noqa: E702
    b = b + c; c = c << 1; c = c - b   # noqa: E702
    d = d + a; a = a << 1; a = a - d   # noqa: E702
    return torch.stack([a, b, c, d], dim=-1).movedim(-1, axis)


# The reference's block exponent is floor(jnp.log2(emax)) in float32, and
# XLA's log2 is log(x) * (1 / log 2) with XLA's own log: a Cephes polynomial,
# which is not the correctly rounded log2 (at 8192 it gives 12.999999, floor
# 12). So the exponent is computed here the same way, in float32 torch ops,
# each rounded once: it then agrees with the reference's floor at every normal
# float32, powers of two included.
_SQRT_HALF = 0.707106781186547524
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def _floor_log2(v: torch.Tensor) -> torch.Tensor:
    """floor(log(v) * (1 / log 2)) with the Cephes float32 log, for normal v > 0."""
    f = lambda c: torch.tensor(c, dtype=torch.float32, device=v.device)  # noqa: E731
    mant, e = torch.frexp(v)                   # v = mant * 2**e, mant in [0.5, 1)
    e = e.to(torch.float32)
    small = mant < f(_SQRT_HALF)               # then log(2 mant) + (e - 1) log 2
    x = (mant - f(1.0)) + torch.where(small, mant, f(0.0))
    e = e - small.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    p = [f(c) for c in _LOG_P]
    y = p[0] * x + p[1]
    y1 = p[3] * x + p[4]
    y2 = p[6] * x + p[7]
    y = y * x + p[2]
    y1 = y1 * x + p[5]
    y2 = y2 * x + p[8]
    y = (y * x3 + y1) * x3 + y2
    y = y * x3 + e * f(_LOG_Q1)
    x = x - x2 * f(0.5)
    log = (x + y) + e * f(_LOG_Q2)
    inv_ln2 = f(1.0) / f(float(np.log(np.float32(2.0))))
    return torch.floor(log * inv_ln2)


def cuzfp_like(data: torch.Tensor, rate_bits: int) -> tuple[torch.Tensor, int]:
    """Fixed-rate transform coder on 4^d blocks. Returns (rec, bytes).

    Block floating point -> lifting transform -> keep the top ``rate_bits``
    bit planes of each 30-bit coefficient (sign-magnitude truncation).
    Subnormal floats count as zero, as on the reference's CPU, where XLA
    flushes them: subnormal inputs code as zeros, and so does a block whose
    step ``2**(e - 28)`` (XLA reconstructs ``coef * (scale * 2**-28)``) is
    below the smallest normal float32.
    """
    nd = data.ndim
    shape = tuple(data.shape)
    pad = [p for s in reversed(shape) for p in (0, (-s) % 4)]
    x = F.pad(data.to(torch.float32), pad)
    x = torch.where(x.abs() < _F32_MIN_NORMAL, torch.zeros_like(x), x)
    padded = tuple(x.shape)
    # gather 4^d blocks: (n0, 4, n1, 4, ...) -> (n0, n1, ..., 4, 4, ...)
    x = x.reshape([v for s in padded for v in (s // 4, 4)])
    x = x.permute(list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2)))
    block_axes = tuple(range(nd, 2 * nd))
    emax = x.abs().amax(dim=block_axes, keepdim=True)
    nonzero = emax > 0
    expo = _floor_log2(torch.where(nonzero, emax, torch.ones_like(emax)))
    pow2 = ((expo.to(torch.int32) + 127) << 23).view(torch.float32)   # exactly 2**expo
    scale = torch.where(nonzero, pow2, torch.ones_like(pow2))
    xi = torch.round(x / scale * float(1 << 28)).clamp(-(1 << 30), (1 << 30) - 1)
    xi = xi.to(torch.int32)
    for ax in block_axes:
        xi = _zfp_lift(xi, ax)
    # truncate to rate_bits of the 30-bit magnitude
    drop = max(30 - rate_bits, 0)
    trunc = (xi.abs() >> drop) << drop
    xi_t = torch.where(xi < 0, -trunc, trunc)
    for ax in reversed(block_axes):
        xi_t = _zfp_unlift(xi_t, ax)
    step = scale * 2.0 ** -28
    step = torch.where(step < _F32_MIN_NORMAL, torch.zeros_like(step), step)
    rec = xi_t.to(torch.float32) * step
    # scatter the blocks back: -> (n0, 4, n1, 4, ...) -> padded
    inv = [0] * (2 * nd)
    for i in range(nd):
        inv[2 * i] = i
        inv[2 * i + 1] = nd + i
    rec = rec.permute(inv).reshape(padded)
    rec = rec[tuple(slice(0, s) for s in shape)].contiguous()
    n_blocks = xi.numel() // (4 ** nd)
    return rec, n_blocks * (2 + (rate_bits * 4 ** nd + 7) // 8)   # exponent + planes
