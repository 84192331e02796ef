"""Plain PyTorch versions of the port's CUDA kernels, composed from ``core``.

Each function computes exactly what its kernel computes, the way
``repro.kernels.ref`` composes the reference stages into oracles:

* K4 ``fused_compress``:       encode(bitshuffle(pad(quantize(data))))
* K5 ``fused_shuffle_encode``: encode(bitshuffle(codes))
* K6 ``fused_decompress``:     dual_dequantize(bitunshuffle(decode(...)))

The kernel wrappers run these for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them on the card.
"""
from __future__ import annotations

import torch

from ..core import encode as enc
from ..core import quant, shuffle

TILE = shuffle.TILE


def lorenzo_quant_ref(data: torch.Tensor, eb: torch.Tensor, *,
                      code_mode: str = "sign_mag") -> torch.Tensor:
    """Pre-quantization + Lorenzo + saturating codes (no outlier channel)."""
    codes, _, _ = quant.to_codes(quant.lorenzo_delta(quant.prequantize(data, eb)),
                                 code_mode=code_mode)
    return codes


def fused_compress_ref(data: torch.Tensor, eb: torch.Tensor, *, capacity: int,
                       code_mode: str = "sign_mag"):
    """float (1-3)D -> (bitflags uint32[W], payload uint16[capacity, 8], nnz int32[])."""
    codes = lorenzo_quant_ref(data, eb, code_mode=code_mode)
    return fused_shuffle_encode_ref(shuffle.pad_to_tiles(codes.reshape(-1)),
                                    capacity=capacity)


def fused_shuffle_encode_ref(codes_flat: torch.Tensor, *, capacity: int):
    """(k*TILE,) codes -> (bitflags uint32[W], payload uint16[capacity, 8], nnz int32[])."""
    return enc.encode(shuffle.bitshuffle(codes_flat), capacity=capacity)


def fused_decompress_ref(bitflags: torch.Tensor, payload: torch.Tensor, eb: torch.Tensor, *,
                         shape: tuple[int, ...], code_mode: str = "sign_mag",
                         outlier_idx: torch.Tensor | None = None,
                         outlier_val: torch.Tensor | None = None) -> torch.Tensor:
    """Container fields -> float32[shape]."""
    n = 1
    for s in shape:
        n *= s
    n_blocks = (n + TILE - 1) // TILE * TILE // enc.BLOCK_WORDS
    words = enc.decode(bitflags, payload, n_blocks=n_blocks)
    codes = shuffle.bitunshuffle(words)[:n]
    return quant.dual_dequantize(codes, eb, tuple(shape), code_mode=code_mode,
                                 outlier_idx=outlier_idx, outlier_val=outlier_val)
