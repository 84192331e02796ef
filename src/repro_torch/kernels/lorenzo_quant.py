"""Wrapper of K1 ``lorenzo_quant`` (csrc/fz_staged.cu).

Replaces the Pallas TPU kernel ``repro/kernels/lorenzo_quant.py:lorenzo_quant``:
float32/bfloat16 (1-3)D data -> uint16 Lorenzo codes of the same shape,
saturating (paper mode: no outlier channel). A 1D input is one continuous
difference stream.

For a CPU tensor the wrapper runs its plain version (``kernels/ref.py``); for
a CUDA tensor it launches the kernel on the current stream or raises. It
counts its launches in ``lorenzo_quant.launches``.
"""
from __future__ import annotations

import torch

from . import build, ref
from .fused_compress import MAX_N, _check_eb, _code_mode

_SOURCE = "fz_staged.cu"


def lorenzo_quant(data: torch.Tensor, eb: torch.Tensor, *,
                  code_mode: str = "sign_mag") -> torch.Tensor:
    """float32/bfloat16 (1-3)D -> uint16 codes of the same shape."""
    if data.device.type == "cpu":
        return ref.lorenzo_quant_ref(data, eb, code_mode=code_mode)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lorenzo_quant takes float32 or bfloat16, got {data.dtype}")
    if not 1 <= data.ndim <= 3:
        raise ValueError(f"lorenzo_quant supports 1-3D, got {data.ndim}D")
    if not data.is_contiguous():
        raise ValueError("lorenzo_quant needs a contiguous tensor")
    n = data.numel()
    if not 0 < n <= MAX_N:
        raise ValueError(f"lorenzo_quant takes 1..{MAX_N} elements, got {n}")
    _check_eb(eb, data.device)
    dims = list(data.shape) + [1] * (3 - data.ndim)
    codes = torch.empty(data.shape, dtype=torch.uint16, device=data.device)
    lib = build.library(_SOURCE)
    rc = lib.fz_lorenzo_quant(
        data.data_ptr(), int(data.dtype == torch.bfloat16), data.ndim, *dims,
        eb.data_ptr(), _code_mode(code_mode), codes.data_ptr(),
        torch.cuda.current_stream(data.device).cuda_stream)
    build.check(lib, "fz_lorenzo_quant", rc)
    lorenzo_quant.launches += 1
    return codes


lorenzo_quant.launches = 0
