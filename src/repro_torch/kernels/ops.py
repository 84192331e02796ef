"""The kernel routes of the compressor: the port of ``repro.kernels.ops``.

Two routes, selected by ``FZConfig.kernel_mode`` (``core/fz.py``):

* **fused** -- ``fused_compress_stages`` keeps the reference's explicit
  outlier route (``repro/kernels/ops.py:127-153``): the exact residual
  channel needs the unsaturated int32 deltas, which K4 never materializes,
  so in strict mode (``outlier_capacity > 0``) quantization runs as plain
  PyTorch ops (``core.quant.dual_quantize``, on the card when the data is
  there) and K5 shuffles, flags and compacts the codes. Paper mode runs K4
  alone. Decompression is K6 in both modes.
* **staged** -- the paper's unfused pipeline, one launch per stage with the
  codes in device memory between them, mirroring
  ``repro/kernels/ops.py:72-120``: ``lorenzo_quantize`` (K1 in paper mode,
  the same explicit ``dual_quantize`` route in strict mode),
  ``bitshuffle_flag_encode`` (K2, then the phase-2 compaction as torch ops,
  ``core.encode.compact_blocks``, as the reference leaves it to XLA) and
  ``bitunshuffle`` (K3). The staged wrappers take the signatures of the
  plain stages they replace.
"""
from __future__ import annotations

import torch

from ..core import encode as enc
from ..core import quant, shuffle
from .bitshuffle_flag import bitshuffle_flag, bitunshuffle_tiles
from .fused_compress import TILE, fused_compress, fused_shuffle_encode
from .fused_decode import fused_decompress
from .lorenzo_quant import lorenzo_quant

__all__ = ["fused_compress_stages", "fused_decompress", "lorenzo_quantize",
           "bitshuffle_flag_encode", "bitshuffle", "bitunshuffle"]


def _no_outliers(device: torch.device):
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    return empty, empty, torch.zeros((), dtype=torch.int32, device=device)


def fused_compress_stages(data: torch.Tensor, eb: torch.Tensor, *, code_mode: str,
                          capacity: int, outlier_capacity: int = 0):
    """-> (bitflags, payload, nnz, outlier_idx, outlier_val, n_over)."""
    if outlier_capacity > 0:
        codes, oidx, oval, n_over = quant.dual_quantize(
            data, eb, code_mode=code_mode, outlier_capacity=outlier_capacity)
        flat = shuffle.pad_to_tiles(codes.reshape(-1)).to(torch.uint16)
        bitflags, payload, nnz = fused_shuffle_encode(flat, capacity=capacity)
        return bitflags, payload, nnz, oidx, oval, n_over
    bitflags, payload, nnz = fused_compress(data, eb, capacity=capacity, code_mode=code_mode)
    return (bitflags, payload, nnz, *_no_outliers(data.device))


def lorenzo_quantize(data: torch.Tensor, eb: torch.Tensor, *, code_mode: str = "sign_mag",
                     outlier_capacity: int = 0):
    """Staged quantization -> (codes, outlier_idx, outlier_val, n_over).

    Paper mode is K1 (saturating uint16 codes, no outlier channel); strict
    mode routes to ``dual_quantize`` for the residuals, as the reference does.
    """
    if outlier_capacity > 0:
        return quant.dual_quantize(data, eb, code_mode=code_mode,
                                   outlier_capacity=outlier_capacity)
    return (lorenzo_quant(data, eb, code_mode=code_mode), *_no_outliers(data.device))


def bitshuffle_flag_encode(codes_flat: torch.Tensor, *, capacity: int):
    """K2 + phase-2 compaction: equals ``encode(bitshuffle(codes_flat), capacity)``."""
    if codes_flat.numel() % TILE:
        raise ValueError(f"size {codes_flat.numel()} not a multiple of TILE={TILE}")
    shuffled, byteflags = bitshuffle_flag(codes_flat.to(torch.uint16).reshape(-1, TILE))
    # int16 view: the same bits, and a type every device's gather takes
    return enc.compact_blocks(byteflags.reshape(-1).to(torch.bool),
                              shuffled.view(torch.int16).reshape(-1, enc.BLOCK_WORDS),
                              capacity=capacity)


def bitshuffle(codes_flat: torch.Tensor) -> torch.Tensor:
    """Shuffle only (K2, flags dropped), the signature of ``core.shuffle.bitshuffle``."""
    shuffled, _ = bitshuffle_flag(codes_flat.to(torch.uint16).reshape(-1, TILE))
    return shuffled.reshape(-1)


def bitunshuffle(words_flat: torch.Tensor) -> torch.Tensor:
    """K3 with the signature of ``core.shuffle.bitunshuffle``.

    The decoder's words are int32; they become uint16 here, one pass before K3.
    """
    return bitunshuffle_tiles(words_flat.to(torch.uint16).reshape(-1, TILE)).reshape(-1)
