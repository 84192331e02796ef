"""The fused kernel route of the compressor: the port of ``repro.kernels.ops``.

``fused_compress_stages`` keeps the reference's explicit outlier route
(``repro/kernels/ops.py:127-153``): the exact residual channel needs the
unsaturated int32 deltas, which K4 never materializes, so in strict mode
(``outlier_capacity > 0``) quantization runs as plain PyTorch ops
(``core.quant.dual_quantize``, on the card when the data is there) and K5
shuffles, flags and compacts the codes. Paper mode runs K4 alone.
Decompression is K6 in both modes.
"""
from __future__ import annotations

import torch

from ..core import quant, shuffle
from .fused_compress import fused_compress, fused_shuffle_encode
from .fused_decode import fused_decompress

__all__ = ["fused_compress_stages", "fused_decompress"]


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
    empty = torch.zeros(0, dtype=torch.int32, device=data.device)
    return bitflags, payload, nnz, empty, empty, torch.zeros((), dtype=torch.int32,
                                                             device=data.device)
