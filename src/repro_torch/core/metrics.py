"""Distortion metrics of the paper's evaluation (§4.2): the port of ``repro.core.metrics``.

Reductions run in float64, so on large arrays these agree with the
reference's float32 sums to float32 rounding, not bit for bit.
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
