"""Plain PyTorch versions of the port's CUDA kernels, composed from ``core``.

Each function computes exactly what its kernel computes, the way
``repro.kernels.ref`` composes the reference stages into oracles:

* K1 ``lorenzo_quant``:        to_codes(lorenzo_delta(prequantize(data)))
* K2 ``bitshuffle_flag``:      bitshuffle(codes), block_flags(...) as bytes
* K3 ``bitunshuffle_tiles``:   bitunshuffle(words)
* K4 ``fused_compress``:       encode(bitshuffle(pad(quantize(data))))
* K5 ``fused_shuffle_encode``: encode(bitshuffle(codes))
* K6 ``fused_decompress``:     dual_dequantize(bitunshuffle(decode(...)))

K1-K3 return the reference kernels' ``uint16``/``uint8`` results.

The kernel wrappers run these for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them on the card.
"""
from __future__ import annotations

import torch

from ..core import encode as enc
from ..core import quant, shuffle

TILE = shuffle.TILE
BLOCKS_PER_TILE = TILE // enc.BLOCK_WORDS    # 512


def lorenzo_quant_ref(data: torch.Tensor, eb: torch.Tensor, *,
                      code_mode: str = "sign_mag") -> torch.Tensor:
    """Pre-quantization + Lorenzo + saturating codes (no outlier channel) -> uint16."""
    codes, _, _ = quant.to_codes(quant.lorenzo_delta(quant.prequantize(data, eb)),
                                 code_mode=code_mode)
    return codes.to(torch.uint16)


def bitshuffle_flag_ref(codes_tiles: torch.Tensor):
    """(n_tiles, TILE) codes -> (shuffled (n_tiles, TILE) uint16, flags (n_tiles, 512) uint8);
    flag b of a tile covers its shuffled words [8b, 8b + 8)."""
    n_tiles = codes_tiles.shape[0]
    shuffled = shuffle.bitshuffle(codes_tiles.reshape(-1))
    flags = enc.block_flags(shuffled).reshape(n_tiles, BLOCKS_PER_TILE)
    return shuffled.reshape(n_tiles, TILE).to(torch.uint16), flags.to(torch.uint8)


def bitunshuffle_ref(shuffled_tiles: torch.Tensor) -> torch.Tensor:
    """(n_tiles, TILE) shuffled words -> (n_tiles, TILE) uint16 codes in their order."""
    n_tiles = shuffled_tiles.shape[0]
    return shuffle.bitunshuffle(shuffled_tiles.reshape(-1)).reshape(n_tiles, TILE).to(torch.uint16)


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
