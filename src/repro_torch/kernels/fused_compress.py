"""Wrappers of K4 ``fused_compress`` and K5 ``fused_shuffle_encode`` (csrc/fz_compress.cu).

K4 replaces the Pallas TPU kernel ``repro/kernels/fused_compress.py:fused_compress``:
float (1-3)D data -> (bitflags uint32[16 * tiles], payload uint16[capacity, 8],
nnz int32[]) in one launch. K5 replaces ``:fused_shuffle_encode``: the same
from u16 codes, the strict-mode route.

For a CPU tensor a wrapper runs its plain version (``kernels/ref.py``); for a
CUDA tensor it launches the kernel on the current stream or raises. Each
wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from . import build, ref

TILE = ref.TILE
FLAG_WORDS_PER_TILE = 16
_SOURCE = "fz_compress.cu"
MAX_N = 2**31 - TILE          # the kernels index the stream in int32
_CODE_MODES = {"sign_mag": 0, "zigzag": 1}


def _code_mode(code_mode: str) -> int:
    if code_mode not in _CODE_MODES:
        raise ValueError(f"unknown code_mode {code_mode!r}")
    return _CODE_MODES[code_mode]


def _check_eb(eb: torch.Tensor, device: torch.device) -> None:
    if eb.dtype != torch.float32 or eb.numel() != 1 or eb.device != device:
        raise ValueError(f"eb must be a float32 scalar on {device}, got "
                         f"{eb.dtype} {tuple(eb.shape)} on {eb.device}")


def _outputs(n_tiles: int, capacity: int, device: torch.device):
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    bitflags = torch.empty(n_tiles * FLAG_WORDS_PER_TILE, dtype=torch.uint32, device=device)
    payload = torch.zeros(capacity, 8, dtype=torch.uint16, device=device)
    nnz = torch.empty((), dtype=torch.int32, device=device)
    scratch = torch.zeros(n_tiles + 1, dtype=torch.int64, device=device)  # look-back + ticket
    return bitflags, payload, nnz, scratch


def fused_compress(data: torch.Tensor, eb: torch.Tensor, *, capacity: int,
                   code_mode: str = "sign_mag"):
    """float32/bfloat16 (1-3)D -> (bitflags, payload, nnz).

    Bit-identical to ``encode(bitshuffle(pad(quantize(data))))``.
    """
    if data.device.type == "cpu":
        return ref.fused_compress_ref(data, eb, capacity=capacity, code_mode=code_mode)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_compress takes float32 or bfloat16, got {data.dtype}")
    if not 1 <= data.ndim <= 3:
        raise ValueError(f"fused_compress supports 1-3D, got {data.ndim}D")
    if not data.is_contiguous():
        raise ValueError("fused_compress needs a contiguous tensor")
    n = data.numel()
    if not 0 < n <= MAX_N:
        raise ValueError(f"fused_compress takes 1..{MAX_N} elements, got {n}")
    _check_eb(eb, data.device)
    dims = list(data.shape) + [1] * (3 - data.ndim)
    n_tiles = -(-n // TILE)
    bitflags, payload, nnz, scratch = _outputs(n_tiles, capacity, data.device)
    lib = build.library(_SOURCE)
    rc = lib.fz_fused_compress(
        data.data_ptr(), int(data.dtype == torch.bfloat16), data.ndim, *dims,
        eb.data_ptr(), _code_mode(code_mode), bitflags.data_ptr(), payload.data_ptr(),
        capacity, nnz.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(data.device).cuda_stream)
    build.check(lib, "fz_fused_compress", rc)
    fused_compress.launches += 1
    return bitflags, payload, nnz


fused_compress.launches = 0


def fused_shuffle_encode(codes_flat: torch.Tensor, *, capacity: int):
    """(k * TILE,) uint16 codes -> (bitflags, payload, nnz).

    Bit-identical to ``encode(bitshuffle(codes_flat))``.
    """
    if codes_flat.device.type == "cpu":
        return ref.fused_shuffle_encode_ref(codes_flat, capacity=capacity)
    if codes_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {codes_flat.device}")
    if codes_flat.dtype != torch.uint16:
        raise ValueError(f"fused_shuffle_encode takes uint16 codes, got {codes_flat.dtype}")
    if codes_flat.ndim != 1 or not codes_flat.is_contiguous():
        raise ValueError("fused_shuffle_encode takes a contiguous 1D tensor")
    n = codes_flat.numel()
    if n == 0 or n % TILE or n > MAX_N + TILE:
        raise ValueError(f"size {n} is not a positive multiple of TILE={TILE} below 2**31")
    n_tiles = n // TILE
    bitflags, payload, nnz, scratch = _outputs(n_tiles, capacity, codes_flat.device)
    lib = build.library(_SOURCE)
    rc = lib.fz_fused_shuffle_encode(
        codes_flat.data_ptr(), n_tiles, bitflags.data_ptr(), payload.data_ptr(), capacity,
        nnz.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(codes_flat.device).cuda_stream)
    build.check(lib, "fz_fused_shuffle_encode", rc)
    fused_shuffle_encode.launches += 1
    return bitflags, payload, nnz


fused_shuffle_encode.launches = 0
