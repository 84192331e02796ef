"""Plain PyTorch versions of the port's CUDA kernels, composed from ``core``.

Each function computes exactly what its kernel computes, the way
``repro.kernels.ref`` composes the reference stages into oracles:

* K1 ``lorenzo_quant``:        to_codes(lorenzo_delta(prequantize(data)))
* K2 ``bitshuffle_flag``:      bitshuffle(codes), block_flags(...) as bytes
* K3 ``bitunshuffle_tiles``:   bitunshuffle(words)
* K4 ``fused_compress``:       encode(bitshuffle(pad(quantize(data))))
* K5 ``fused_shuffle_encode``: encode(bitshuffle(codes))
* K6 ``fused_decompress``:     dual_dequantize(bitunshuffle(decode(...)))
* K7 ``flash_decode``:         the reference kernel's per-tile online softmax,
                               over each split of the tiles, then the combine

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


NEG_INF = -1e30          # the reference's finite -inf stand-in (never -inf)


def flash_decode_ref(q4: torch.Tensor, k_tiles: torch.Tensor, v_tiles: torch.Tensor,
                     length_eff: torch.Tensor):
    """K7's plain version: the Pallas kernel body (``_flash_decode_kernel``) run
    over the tiles in order.

    q4: (B, KVH, G, D) float32, pre-scaled; k/v_tiles: (B, T, tile, KVH, D);
    length_eff: (B,) int32. Returns (m, num, den) float32, (B, KVH, G[, D]).
    """
    B, KVH, G, D = q4.shape
    T, tile = k_tiles.shape[1], k_tiles.shape[2]
    dev = q4.device
    m = torch.full((B, KVH, G), NEG_INF, dtype=torch.float32, device=dev)
    num = torch.zeros((B, KVH, G, D), dtype=torch.float32, device=dev)
    den = torch.zeros((B, KVH, G), dtype=torch.float32, device=dev)
    length = length_eff.to(torch.int32).reshape(B, 1)
    for t in range(T):
        k = k_tiles[:, t].to(torch.float32)                     # (B, tile, KVH, D)
        v = v_tiles[:, t].to(torch.float32)
        s = torch.einsum("bhgd,bkhd->bhgk", q4, k)
        pos = t * tile + torch.arange(tile, dtype=torch.int32, device=dev)
        valid = (pos[None, :] < length)[:, None, None, :]       # (B, 1, 1, tile)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)   # empty-tile safety
        corr = torch.exp(m - m_new)                             # 1 while both are NEG_INF
        den = den * corr + p.sum(-1)
        num = num * corr[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, v)
        m = m_new
    return m, num, den


def flash_decode_split_ref(q4: torch.Tensor, k_tiles: torch.Tensor, v_tiles: torch.Tensor,
                           length_eff: torch.Tensor, splits: int):
    """K7 split over its tiles: split s runs ``flash_decode_ref`` on tiles
    ``[s * tps, (s + 1) * tps)``, ``tps = ceil(T / splits)``, with the length
    shifted to the split's first position, and ``combine_splits_ref`` merges the
    splits. One split is ``flash_decode_ref`` itself."""
    T, tile = k_tiles.shape[1], k_tiles.shape[2]
    if splits <= 1:
        return flash_decode_ref(q4, k_tiles, v_tiles, length_eff)
    tps = -(-T // splits)
    parts = [flash_decode_ref(q4, k_tiles[:, t0:t0 + tps], v_tiles[:, t0:t0 + tps],
                              length_eff.to(torch.int32) - t0 * tile)
             for t0 in range(0, splits * tps, tps)]
    return combine_splits_ref(*(torch.stack(p) for p in zip(*parts)))


def combine_splits_ref(m_s: torch.Tensor, num_s: torch.Tensor, den_s: torch.Tensor):
    """Merge split partials stacked on a leading axis: ``m = max m_s``, ``num =
    sum num_s exp(m_s - m)``, ``den`` likewise. Splits with no valid position
    (m_s = NEG_INF, zeros) weigh 0 beside a real one, and an all-empty row stays
    exactly (NEG_INF, 0, 0): its weights are exp(0) = 1 on zeros."""
    m = m_s.amax(0)
    w = torch.exp(m_s - m)
    return m, (num_s * w[..., None]).sum(0), (den_s * w).sum(0)
