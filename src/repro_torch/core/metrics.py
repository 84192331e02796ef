"""Distortion and ratio metrics of the paper's evaluation (§4.2): the port of
``repro.core.metrics``.

The error reductions run in float64, so on large arrays they agree with the
reference's float32 sums to float32 rounding, not bit for bit. ``ssim2d``
makes its window means in float32, as the reference, with sums in another
order.
"""
from __future__ import annotations

import math

import torch


def max_abs_err(orig: torch.Tensor, rec: torch.Tensor) -> float:
    return float(torch.max(torch.abs(orig.to(torch.float32) - rec.to(torch.float32))))


def _mse_and_range(orig: torch.Tensor, rec: torch.Tensor):
    o = orig.to(torch.float64)
    mse = float(torch.mean((o - rec.to(torch.float64)) ** 2))
    return mse, float(o.max() - o.min())


def psnr(orig: torch.Tensor, rec: torch.Tensor) -> float:
    """Range-based PSNR in dB (the paper's primary distortion metric)."""
    mse, rng = _mse_and_range(orig, rec)
    peak = 20.0 * math.log10(rng) if rng > 0 else -math.inf   # the reference's log10(0)
    return peak - 10.0 * math.log10(max(mse, 1e-30))


def nrmse(orig: torch.Tensor, rec: torch.Tensor) -> float:
    mse, rng = _mse_and_range(orig, rec)
    return mse ** 0.5 / max(rng, 1e-30)


def bitrate(raw_bytes: float, compressed_bytes, dtype: torch.dtype = torch.float32):
    """Average bits per source value; ``dtype`` is the source element type (a
    bfloat16 field at the same compressed size costs twice the bits per value
    of a float32 one)."""
    return dtype.itemsize * 8 * compressed_bytes / raw_bytes


def _window_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """Uniform k x k window mean of a 2-D array ('valid'): a box filter along
    each axis, each term weighted by float32(1 / k) before the sum."""
    w = torch.ones(k, dtype=x.dtype, device=x.device) / k
    x = (x.unfold(1, k, 1) * w).sum(-1)
    return (x.unfold(0, k, 1) * w).sum(-1)


def ssim2d(orig: torch.Tensor, rec: torch.Tensor, k: int = 7) -> float:
    """SSIM over a 2-D field with a uniform window (the paper's secondary
    fidelity metric)."""
    orig = orig.to(torch.float32)
    rec = rec.to(torch.float32)
    rng = orig.max() - orig.min()
    c1 = (0.01 * rng) ** 2 + 1e-12
    c2 = (0.03 * rng) ** 2 + 1e-12
    mu_x, mu_y = _window_mean(orig, k), _window_mean(rec, k)
    xx, yy = _window_mean(orig * orig, k), _window_mean(rec * rec, k)
    xy = _window_mean(orig * rec, k)
    var_x = torch.clamp_min(xx - mu_x ** 2, 0.0)
    var_y = torch.clamp_min(yy - mu_y ** 2, 0.0)
    cov = xy - mu_x * mu_y
    s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / ((mu_x ** 2 + mu_y ** 2 + c1)
                                                    * (var_x + var_y + c2))
    return float(s.to(torch.float64).mean())
