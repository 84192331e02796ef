"""Wrappers of K2 ``bitshuffle_flag`` and K3 ``bitunshuffle_tiles`` (csrc/fz_staged.cu).

K2 replaces the Pallas TPU kernel ``repro/kernels/bitshuffle_flag.py:bitshuffle_flag``:
uint16 codes (n_tiles, 4096) -> (bitshuffled words uint16 (n_tiles, 4096),
nonzero flag per 8-word block uint8 (n_tiles, 512)). K3 replaces
``:bitunshuffle_tiles``, the inverse shuffle.

For a CPU tensor a wrapper runs its plain version (``kernels/ref.py``); for a
CUDA tensor it launches the kernel on the current stream or raises. Each
wrapper counts its launches in ``<wrapper>.launches`` and registers the spec
builder of its launch (one CTA a tile, static shared memory only).
"""
from __future__ import annotations

import torch

from ..analysis.kernelspec import KernelSpec, register_spec
from . import build, ref
from .fused_compress import MAX_N, THREADS, TILE

_SOURCE = "fz_staged.cu"
BLOCKS_PER_TILE = ref.BLOCKS_PER_TILE
SHUFFLE_MIN_CTAS = 8          # __launch_bounds__ minimum of K2


@register_spec("bitshuffle_flag")
def bitshuffle_flag_spec(n_tiles: int, point: str = "") -> KernelSpec:
    """K2 (``bitshuffle_flag_tiles``)."""
    return KernelSpec(name="bitshuffle_flag", module=_SOURCE, symbol="bitshuffle_flag_tiles",
                      grid=(int(n_tiles),), threads=THREADS, min_ctas=SHUFFLE_MIN_CTAS,
                      point=point or f"{n_tiles} tiles")


@register_spec("bitunshuffle_tiles")
def bitunshuffle_tiles_spec(n_tiles: int, point: str = "") -> KernelSpec:
    """K3 (``bitunshuffle_tiles_k``)."""
    return KernelSpec(name="bitunshuffle_tiles", module=_SOURCE, symbol="bitunshuffle_tiles_k",
                      grid=(int(n_tiles),), threads=THREADS,
                      point=point or f"{n_tiles} tiles")


def _check_tiles(tiles: torch.Tensor, name: str) -> int:
    """-> n_tiles of a (n_tiles, TILE) uint16 CUDA tensor the kernels can read."""
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    if tiles.dtype != torch.uint16:
        raise ValueError(f"{name} takes uint16 tiles, got {tiles.dtype}")
    if tiles.ndim != 2 or tiles.shape[1] != TILE or not 0 < tiles.shape[0] * TILE <= MAX_N + TILE:
        raise ValueError(f"{name} takes (n_tiles, {TILE}) tiles below 2**31 codes, "
                         f"got {tuple(tiles.shape)}")
    if not tiles.is_contiguous() or tiles.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous tensor aligned to 16 bytes")
    return tiles.shape[0]


def bitshuffle_flag(codes_tiles: torch.Tensor):
    """(n_tiles, TILE) uint16 -> (shuffled (n_tiles, TILE) uint16, flags (n_tiles, 512) uint8)."""
    if codes_tiles.device.type == "cpu":
        return ref.bitshuffle_flag_ref(codes_tiles)
    n_tiles = _check_tiles(codes_tiles, "bitshuffle_flag")
    dev = codes_tiles.device
    shuffled = torch.empty(n_tiles, TILE, dtype=torch.uint16, device=dev)
    flags = torch.empty(n_tiles, BLOCKS_PER_TILE, dtype=torch.uint8, device=dev)
    lib = build.library(_SOURCE)
    rc = lib.fz_bitshuffle_flag(codes_tiles.data_ptr(), n_tiles, shuffled.data_ptr(),
                                flags.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "fz_bitshuffle_flag", rc)
    bitshuffle_flag.launches += 1
    return shuffled, flags


bitshuffle_flag.launches = 0


def bitunshuffle_tiles(shuffled_tiles: torch.Tensor) -> torch.Tensor:
    """(n_tiles, TILE) uint16 shuffled words -> the codes in their original order."""
    if shuffled_tiles.device.type == "cpu":
        return ref.bitunshuffle_ref(shuffled_tiles)
    n_tiles = _check_tiles(shuffled_tiles, "bitunshuffle_tiles")
    dev = shuffled_tiles.device
    codes = torch.empty(n_tiles, TILE, dtype=torch.uint16, device=dev)
    lib = build.library(_SOURCE)
    rc = lib.fz_bitunshuffle_tiles(shuffled_tiles.data_ptr(), n_tiles, codes.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "fz_bitunshuffle_tiles", rc)
    bitunshuffle_tiles.launches += 1
    return codes


bitunshuffle_tiles.launches = 0
