"""Wrapper of K1 ``lorenzo_quant`` (csrc/fz_staged.cu).

Replaces the Pallas TPU kernel ``repro/kernels/lorenzo_quant.py:lorenzo_quant``:
float32/bfloat16 (1-3)D data -> uint16 Lorenzo codes of the same shape,
saturating (paper mode: no outlier channel). A 1D input is one continuous
difference stream.

For a CPU tensor the wrapper runs its plain version (``kernels/ref.py``); for
a CUDA tensor it launches the kernel on the current stream or raises. It
counts its launches in ``lorenzo_quant.launches``.

K1 launches one of two kernels (``fz_staged.cu:lorenzo_quant``): the walk
along the leading axis where the planes (3-D) or rows (2-D) hold a tile and
two windows fit in shared memory, else the tile step. Each registers its spec
builder here (``lorenzo_quant.walk``, ``lorenzo_quant.tiles``); which of them
launches and with how many dynamic shared bytes is asked of the C side on the
card (``fz_lorenzo_quant_walks``, ``fz_lorenzo_quant_smem``).
"""
from __future__ import annotations

import torch

from ..analysis.kernelspec import KernelSpec, register_spec
from . import build, ref
from .fused_compress import (MAX_N, THREADS, TILE, WINDOW_MIN_CTAS, _check_eb, _code_mode,
                             dims3, query_args)

_SOURCE = "fz_staged.cu"
WALK_MIN_CTAS = 4             # __launch_bounds__ minimum of the walk


def _smem_query(shape, dtype):
    return _SOURCE, "fz_lorenzo_quant_smem", query_args(shape, dtype)


@register_spec("lorenzo_quant.tiles")
def tiles_spec(shape, dtype: str = "float32", point: str = "") -> KernelSpec:
    """K1's tile step (``lorenzo_quant_tiles``): one CTA a tile, K4's windows."""
    n = 1
    for s in shape:
        n *= int(s)
    q = _smem_query(shape, dtype)
    return KernelSpec(
        name="lorenzo_quant.tiles", module=_SOURCE, symbol="lorenzo_quant_tiles",
        grid=(-(-n // TILE),), threads=THREADS, dynamic_smem=build.query(*q),
        min_ctas=WINDOW_MIN_CTAS, point=point or f"{tuple(shape)} {dtype}", c_query=q)


@register_spec("lorenzo_quant.walk")
def walk_spec(shape, dtype: str = "float32", point: str = "") -> KernelSpec:
    """K1's walk (``lorenzo_quant_walk``): a CTA a run of a plane over a chunk of
    planes. The grid is its most, runs x planes: the card's wave of CTAs
    chunks the planes."""
    d0, d1, d2 = dims3(shape)
    plane = d1 * d2 if len(shape) == 3 else d1
    q = _smem_query(shape, dtype)
    return KernelSpec(
        name="lorenzo_quant.walk", module=_SOURCE, symbol="lorenzo_quant_walk",
        grid=(-(-plane // TILE) * d0,), threads=THREADS, dynamic_smem=build.query(*q),
        min_ctas=WALK_MIN_CTAS, point=point or f"{tuple(shape)} {dtype}", c_query=q)


def specs(shape, dtype: str = "float32", point: str = "") -> list[KernelSpec]:
    """The spec of the one launch K1 makes for ``shape``, as the C side picks it
    (``fz_lorenzo_quant_walks``); without a card, both of its launch sites."""
    walks = build.query(_SOURCE, "fz_lorenzo_quant_walks", query_args(shape, dtype))
    sites = {None: (walk_spec, tiles_spec), 1: (walk_spec,), 0: (tiles_spec,)}[walks]
    return [site(shape, dtype, point) for site in sites]


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
