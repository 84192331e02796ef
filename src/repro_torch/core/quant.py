"""Dual-quantization (FZ-GPU §3.2) in PyTorch: the port of ``repro.core.quant``.

    q     = rint(d / (2 * eb))       # pre-quantization, IEEE divide, half-even
    delta = Lorenzo(q)               # integer finite differences (exact, int32)
    code  = sign_mag_u16(delta)      # or zigzag; saturating

Codes and words are carried as int32 tensors holding u16 values: torch's
``uint16`` on the CPU lacks shifts and comparisons. They become ``uint16``
only at the container boundary (``core/fz.py``).

With ``outlier_capacity`` K > 0 the first K overflowing deltas, in flat order,
keep their exact int32 residual against their flat index; unused index slots
hold ``n`` and value slots 0, as the reference fills them. Finding them is a
``nonzero``, whose size the host reads: it counts one
``fz_host_syncs{site=dual_quantize}``. The fused route's strict K4
(``kernels.fused_compress_strict``) writes the same channel on the card
without it.
"""
from __future__ import annotations

import torch

from ..obs import spans

MAX_MAG = 0x7FFF   # largest |delta| a sign-magnitude u16 code carries
SIGN_BIT = 0x8000
_SYNC_SITE = {"site": "dual_quantize"}


def lorenzo_delta(q: torch.Tensor) -> torch.Tensor:
    """Forward Lorenzo transform: per-axis backward differences, zero boundary."""
    if q.ndim > 3:
        raise ValueError(f"Lorenzo supports 1-3D, got {q.ndim}D")
    d = q
    for ax in range(q.ndim):
        d = torch.diff(d, dim=ax, prepend=torch.zeros_like(d.narrow(ax, 0, 1)))
    return d


def lorenzo_inverse(delta: torch.Tensor) -> torch.Tensor:
    """Inverse Lorenzo transform: per-axis prefix sums.

    Summed in int64 and cut to int32: addition modulo 2**32 gives the same
    bits as the reference's wrapping int32 cumsum.
    """
    if delta.ndim > 3:
        raise ValueError(f"Lorenzo supports 1-3D, got {delta.ndim}D")
    q = delta.to(torch.int64)
    for ax in range(delta.ndim):
        q = torch.cumsum(q, dim=ax)
    return q.to(torch.int32)


def to_codes(delta: torch.Tensor, *, code_mode: str = "sign_mag"):
    """int32 delta -> (code as int32 in [0, 0xFFFF], overflow mask, int32 residual)."""
    d = delta.to(torch.int32)
    if code_mode == "sign_mag":
        mag = torch.abs(d)
        over = mag > MAX_MAG
        sat = torch.clamp(mag, max=MAX_MAG)
        code = (sat & 0xFFFF) | torch.where(d < 0, SIGN_BIT, 0).to(torch.int32)
        rec = torch.where(d < 0, -sat, sat)
    elif code_mode == "zigzag":
        z = (d << 1) ^ (d >> 31)
        over = z > 0xFFFF
        zs = torch.clamp(z, max=0xFFFF)
        code = zs & 0xFFFF
        rec = (zs >> 1) ^ -(zs & 1)
    else:
        raise ValueError(f"unknown code_mode {code_mode!r}")
    return code, over, d - rec


def from_codes(code: torch.Tensor, *, code_mode: str = "sign_mag") -> torch.Tensor:
    """u16 code (any integer dtype) -> int32 saturated delta."""
    c = code.to(torch.int32)
    if code_mode == "sign_mag":
        mag = c & MAX_MAG
        return torch.where((c & SIGN_BIT) != 0, -mag, mag)
    if code_mode == "zigzag":
        return (c >> 1) ^ -(c & 1)
    raise ValueError(f"unknown code_mode {code_mode!r}")


_INT32_MAX = 2**31 - 1
_BELOW_2_31 = 2147483520.0     # the largest float32 below 2**31


def prequantize(data: torch.Tensor, eb: torch.Tensor) -> torch.Tensor:
    """``rint(x / (2 eb))`` as int32: a true divide, rounded half to even.

    The conversion is XLA's ``astype(int32)`` (and the card's
    ``__float2int_rn``): NaN becomes 0 and values past the int32 range
    saturate, where a bare ``.to(torch.int32)`` is undefined for them.
    """
    r = torch.round(data.to(torch.float32) / (2.0 * eb))
    q = torch.nan_to_num(r, nan=0.0).clamp(-2.0**31, _BELOW_2_31).to(torch.int32)
    return torch.where(r >= 2.0**31, _INT32_MAX, q)


def dual_quantize(data: torch.Tensor, eb: torch.Tensor, *,
                  code_mode: str = "sign_mag", outlier_capacity: int = 0):
    """float data -> (int32 codes, outlier_idx, outlier_val, n_outliers).

    ``eb`` is a 0-d float32 tensor on the data's device.
    """
    delta = lorenzo_delta(prequantize(data, eb))
    codes, over, resid = to_codes(delta, code_mode=code_mode)
    n = codes.numel()
    flat_over = over.reshape(-1)
    n_over = flat_over.sum(dtype=torch.int32)
    dev = codes.device
    if outlier_capacity > 0:
        hit = torch.nonzero(flat_over).reshape(-1)[:outlier_capacity]
        spans.count("fz_host_syncs", _SYNC_SITE)
        idx = torch.full((outlier_capacity,), n, dtype=torch.int32, device=dev)
        val = torch.zeros(outlier_capacity, dtype=torch.int32, device=dev)
        idx[: hit.numel()] = hit.to(torch.int32)
        val[: hit.numel()] = resid.reshape(-1)[hit]
    else:
        idx = torch.zeros(0, dtype=torch.int32, device=dev)
        val = torch.zeros(0, dtype=torch.int32, device=dev)
    return codes, idx, val, n_over


def dual_dequantize(codes: torch.Tensor, eb: torch.Tensor, shape: tuple[int, ...], *,
                    code_mode: str = "sign_mag",
                    outlier_idx: torch.Tensor | None = None,
                    outlier_val: torch.Tensor | None = None) -> torch.Tensor:
    """codes (+ optional outlier residuals) -> float32 reconstruction."""
    delta = from_codes(codes, code_mode=code_mode).reshape(-1)
    n = delta.numel()
    if outlier_idx is not None and outlier_idx.numel():
        idx = outlier_idx.to(torch.int64)
        add = torch.where(idx < n, outlier_val.to(torch.int32), 0).to(torch.int32)
        delta = delta.index_add(0, torch.clamp(idx, max=n - 1), add)
    q = lorenzo_inverse(delta.reshape(shape))
    return q.to(torch.float32) * (2.0 * eb)
