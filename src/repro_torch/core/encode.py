"""Zero-block encoder (FZ-GPU §3.4) in PyTorch: the port of ``repro.core.encode``.

Phase 1 flags every non-zero 16-byte block (8 words) of the shuffled stream
and packs the flags into u32 words, least significant bit first. Phase 2
compacts the flagged blocks, in order, into a fixed-capacity payload;
blocks past the capacity are dropped and ``nnz`` keeps the unclipped count.
Payload slots past ``nnz`` are zero.

Words and blocks are int32 tensors holding u16 values; the packed flags come
out as ``uint32`` and the payload as ``uint16``, the container's types.
"""
from __future__ import annotations

import torch

BLOCK_WORDS = 8           # u16 words per zero-detection block (16 bytes)
BLOCK_BYTES = 2 * BLOCK_WORDS
FLAGS_PER_WORD = 32       # bit flags packed per u32


def flag_words(n_blocks: int) -> int:
    """u32 words in the packed bit-flag array: ceil(n_blocks / 32)."""
    return -(-n_blocks // FLAGS_PER_WORD)


def block_flags(shuffled: torch.Tensor) -> torch.Tensor:
    """(n_words,) words -> (n_blocks,) bool non-zero flags."""
    if shuffled.numel() % BLOCK_WORDS:
        raise ValueError(f"{shuffled.numel()} words not a multiple of {BLOCK_WORDS}")
    return torch.any(shuffled.reshape(-1, BLOCK_WORDS) != 0, dim=-1)


def pack_bitflags(flags: torch.Tensor) -> torch.Tensor:
    """(n_blocks,) bool -> (ceil(n/32),) uint32, least significant bit first."""
    pad = (-flags.numel()) % FLAGS_PER_WORD
    f = torch.nn.functional.pad(flags.reshape(-1).to(torch.int64), (0, pad))
    shifts = torch.arange(FLAGS_PER_WORD, dtype=torch.int64, device=flags.device)
    return (f.reshape(-1, FLAGS_PER_WORD) << shifts).sum(-1).to(torch.uint32)


def unpack_bitflags(bitflags: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(W,) uint32 -> (n_blocks,) bool."""
    shifts = torch.arange(FLAGS_PER_WORD, dtype=torch.int64, device=bitflags.device)
    bits = (bitflags.to(torch.int64)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n_blocks].to(torch.bool)


def compact_blocks(flags: torch.Tensor, blocks: torch.Tensor, *, capacity: int):
    """(flags bool[n_blocks], blocks[n_blocks, 8]) ->
    (bitflags uint32[W], payload uint16[capacity, 8], nnz int32[]).

    ``blocks`` holds u16 words in any integer type (int16 bits included).
    """
    nnz = flags.sum(dtype=torch.int32)
    src = torch.nonzero(flags).reshape(-1)[:capacity]
    payload = torch.zeros(capacity, BLOCK_WORDS, dtype=torch.int32, device=blocks.device)
    payload[: src.numel()] = blocks[src].to(torch.int32) & 0xFFFF
    return pack_bitflags(flags), payload.to(torch.uint16), nnz


def encode(shuffled: torch.Tensor, *, capacity: int):
    """Shuffled words -> (bitflags uint32[W], payload uint16[capacity, 8], nnz int32[])."""
    blocks = shuffled.reshape(-1, BLOCK_WORDS)
    return compact_blocks(torch.any(blocks != 0, dim=-1), blocks, capacity=capacity)


def decode(bitflags: torch.Tensor, payload: torch.Tensor, *, n_blocks: int) -> torch.Tensor:
    """Inverse of :func:`encode` -> flat int32 word stream (n_blocks * 8 words).

    A flagged block reads the payload slot at the exclusive prefix of the
    flags; an unflagged block, or one whose slot is past the capacity, is zero.
    """
    flags = unpack_bitflags(bitflags, n_blocks)
    fi = flags.to(torch.int64)
    offsets = torch.cumsum(fi, 0) - fi
    cap = payload.shape[0]
    in_cap = flags & (offsets < cap)
    rows = payload.to(torch.int32)[torch.clamp(offsets, max=cap - 1)]
    return torch.where(in_cap[:, None], rows, 0).reshape(-1)


def used_bytes(n_blocks: int, nnz: int, n_outliers: int = 0, header_bytes: int = 32) -> int:
    """Exact compressed size: header + ideal bit-flag bytes + blocks + outliers."""
    return header_bytes + (n_blocks + 7) // 8 + nnz * BLOCK_BYTES + n_outliers * 8
