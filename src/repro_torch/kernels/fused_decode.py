"""Wrapper of K6 ``fused_decompress`` (csrc/fz_decompress.cu).

Replaces the Pallas TPU kernel ``repro/kernels/fused_decode.py:fused_decompress``:
container fields (+ optional outlier residuals) -> float32[shape],
bit-identical to ``dual_dequantize(bitunshuffle(decode(...)))``. On the card
it is one call, counted as one launch of K6: a residual binning pass (only
with outlier slots), the fused decode + last-axis prefix (which writes
float32 directly for 1-D data), then one in-place column pass for each other
axis, the last one dequantizing. Axes of size 1 are dropped first: a prefix
along them is the identity.

For CPU tensors the wrapper runs the plain version (``kernels/ref.py``); for
CUDA tensors it launches the kernels on the current stream or raises.
"""
from __future__ import annotations

import torch

from . import build, ref
from .fused_compress import _check_eb, _code_mode, FLAG_WORDS_PER_TILE, MAX_N, TILE

_SOURCE = "fz_decompress.cu"


def fused_decompress(bitflags: torch.Tensor, payload: torch.Tensor, eb: torch.Tensor, *,
                     shape: tuple[int, ...], code_mode: str = "sign_mag",
                     outlier_idx: torch.Tensor | None = None,
                     outlier_val: torch.Tensor | None = None) -> torch.Tensor:
    """Container fields -> float32[shape]."""
    shape = tuple(int(s) for s in shape)
    if bitflags.device.type == "cpu":
        return ref.fused_decompress_ref(bitflags, payload, eb, shape=shape,
                                        code_mode=code_mode, outlier_idx=outlier_idx,
                                        outlier_val=outlier_val)
    dev = bitflags.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"fused_decompress supports 1-3D, got {len(shape)}D")
    n = 1
    for s in shape:
        n *= s
    if not 0 < n <= MAX_N:
        raise ValueError(f"fused_decompress takes 1..{MAX_N} elements, got {n}")
    n_tiles = -(-n // TILE)
    if (bitflags.dtype != torch.uint32 or bitflags.shape != (n_tiles * FLAG_WORDS_PER_TILE,)
            or not bitflags.is_contiguous()):
        raise ValueError(f"bitflags must be contiguous uint32[{n_tiles * FLAG_WORDS_PER_TILE}]"
                         f", got {bitflags.dtype} {tuple(bitflags.shape)}")
    if (payload.dtype != torch.uint16 or payload.ndim != 2 or payload.shape[1] != 8
            or payload.shape[0] < 1 or not payload.is_contiguous() or payload.device != dev):
        raise ValueError(f"payload must be contiguous uint16[capacity, 8] on {dev}")
    _check_eb(eb, dev)
    n_out = 0
    if outlier_idx is not None and outlier_idx.numel():
        for t in (outlier_idx, outlier_val):
            if (t is None or t.dtype != torch.int32 or t.shape != outlier_idx.shape
                    or t.ndim != 1 or not t.is_contiguous() or t.device != dev):
                raise ValueError("outlier_idx/outlier_val must be contiguous int32[K] "
                                 f"of one size on {dev}")
        n_out = outlier_idx.numel()
    lib = build.library(_SOURCE)
    words = lib.fz_decompress_scratch_words(n_tiles, int(n_out > 0))
    scratch = torch.zeros(words, dtype=torch.int64, device=dev)   # look-back, tickets, bins
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    dims = [s for s in shape if s != 1] or [1]
    rc = lib.fz_fused_decompress(
        bitflags.data_ptr(), payload.data_ptr(), payload.shape[0], eb.data_ptr(),
        _code_mode(code_mode), len(dims), *dims, *[1] * (3 - len(dims)),
        outlier_idx.data_ptr() if n_out else None,
        outlier_val.data_ptr() if n_out else None, n_out,
        out.data_ptr(), scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "fz_fused_decompress", rc)
    fused_decompress.launches += 1
    return out


fused_decompress.launches = 0
