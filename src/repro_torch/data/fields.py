"""Synthetic scientific-field generators (SDRBench proxies).

A numpy copy of ``repro/data/fields.py``: the same (kind, shape, seed) gives
the same field bit for bit, so the port and the reference compress one input.

SDRBench datasets (HACC/CESM/Nyx/Hurricane/QMCPACK/RTM) are not
redistributable offline, so benchmarks run on synthetic fields whose
qualitative structure matches the classes the paper evaluates:

  * ``smooth``     — multiscale band-limited fields (CESM / Hurricane-like):
                     sums of low-frequency separable harmonics + mild noise.
  * ``turbulent``  — power-law spectrum fields (Nyx / RTM-like): spectral
                     synthesis with k^-alpha amplitude decay.
  * ``particle``   — heavy-tailed, rough point data after log transform
                     (HACC-like; the paper log-transforms HACC, §4.1).
  * ``wavefront``  — propagating-front snapshot with large zero regions
                     (RTM-like; exercises the zero-block encoder's best case).

All generators are deterministic in (kind, shape, seed).
"""
from __future__ import annotations

import numpy as np

FIELD_KINDS = ("smooth", "turbulent", "particle", "wavefront")


def _grid(shape):
    axes = [np.linspace(0.0, 1.0, s, dtype=np.float32) for s in shape]
    return np.meshgrid(*axes, indexing="ij")


def make_field(kind: str, shape=(128, 128, 128), seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        gs = _grid(shape)
        out = np.zeros(shape, np.float32)
        for _ in range(6):
            freqs = rng.uniform(0.5, 4.0, size=len(shape))
            phase = rng.uniform(0, 2 * np.pi, size=len(shape))
            amp = rng.uniform(0.2, 1.0)
            term = amp * np.ones(shape, np.float32)
            for g, f, p in zip(gs, freqs, phase):
                term = term * np.sin(2 * np.pi * f * g + p, dtype=np.float32)
            out += term
        out += 0.01 * rng.standard_normal(shape).astype(np.float32)
        return out
    if kind == "turbulent":
        white = rng.standard_normal(shape).astype(np.float32)
        spec = np.fft.rfftn(white)
        k2 = np.zeros_like(spec, dtype=np.float32)
        for ax, s in enumerate(shape):
            k = np.fft.fftfreq(s) * s if ax < len(shape) - 1 else np.fft.rfftfreq(s) * s
            sl = [None] * len(shape)
            sl[ax] = slice(None)
            k2 = k2 + (k[tuple(sl)] ** 2).astype(np.float32)
        amp = (1.0 + k2) ** (-11.0 / 12.0)  # ~Kolmogorov-ish slope
        return np.fft.irfftn(spec * amp, s=shape,
                             axes=list(range(len(shape)))).astype(np.float32)
    if kind == "particle":
        x = rng.lognormal(mean=0.0, sigma=2.0, size=shape).astype(np.float32)
        return np.log1p(x)  # the paper compresses log-transformed HACC
    if kind == "wavefront":
        gs = _grid(shape)
        r = np.zeros(shape, np.float32)
        for g in gs:
            r += (g - 0.4) ** 2
        r = np.sqrt(r)
        front = np.exp(-((r - 0.25) ** 2) / 2e-3, dtype=np.float32) * np.sin(80 * r, dtype=np.float32)
        front[r > 0.45] = 0.0  # untouched region: exact zeros, RTM-style
        return front
    raise ValueError(f"unknown field kind {kind!r}; options {FIELD_KINDS}")
