"""Bitshuffle (FZ-GPU §3.3) in PyTorch: the port of ``repro.core.shuffle``.

The bit convention is the reference's involution

    (element e, bit b)  ->  (element 15-b, bit 15-e)

applied to every 16-code group, with the groups' words written plane-major
inside each 4096-code tile (256 words per plane). The paper's 32-wide warp
ballot layout differs and would break container parity.

Words are int32 tensors holding u16 values (see ``core/quant.py``).
"""
from __future__ import annotations

import torch

TILE = 4096                       # codes per shuffle tile
GROUP = 16                        # codes per bit-matrix transpose group
GROUPS_PER_TILE = TILE // GROUP   # 256

_STAGES = ((8, 0xFF00), (4, 0xF0F0), (2, 0xCCCC), (1, 0xAAAA))


def transpose16(x: torch.Tensor) -> torch.Tensor:
    """Bit-matrix transpose of (..., 16) groups of u16 values (an involution)."""
    if x.shape[-1] != GROUP:
        raise ValueError(f"last dim must be {GROUP}, got {tuple(x.shape)}")
    x = x.to(torch.int32)
    idx = torch.arange(GROUP, device=x.device)
    for delta, mask in _STAGES:
        lo = ~mask & 0xFFFF
        partner = x[..., idx ^ delta]
        hi_val = (x & mask) | ((partner & mask) >> delta)
        lo_val = ((partner & lo) << delta) | (x & lo)
        x = torch.where((idx & delta) == 0, hi_val, lo_val)
    return x


def pad_to_tiles(codes_flat: torch.Tensor) -> torch.Tensor:
    """Zero-pad a flat code stream to a whole number of tiles."""
    n = codes_flat.numel()
    padded = (n + TILE - 1) // TILE * TILE
    return torch.nn.functional.pad(codes_flat.reshape(-1), (0, padded - n))


def bitshuffle(codes: torch.Tensor) -> torch.Tensor:
    """Flat (multiple-of-TILE) codes -> plane-major bitshuffled words."""
    if codes.numel() % TILE:
        raise ValueError(f"size {codes.numel()} not a multiple of TILE={TILE}; pad first")
    t = transpose16(codes.reshape(-1, GROUPS_PER_TILE, GROUP))
    return t.transpose(1, 2).reshape(-1)


def bitunshuffle(shuffled: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bitshuffle`: word transpose back, then bit transpose."""
    if shuffled.numel() % TILE:
        raise ValueError(f"size {shuffled.numel()} not a multiple of TILE={TILE}")
    t = shuffled.reshape(-1, GROUP, GROUPS_PER_TILE).transpose(1, 2)
    return transpose16(t).reshape(-1)
