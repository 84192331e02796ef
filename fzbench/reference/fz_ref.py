"""Plain PyTorch reference of the FZ-GPU pipeline, frozen for the benchmark.

A copy of the port's plain stages (``core/quant.py``, ``core/shuffle.py``,
``core/encode.py`` and the assembly of ``core/fz.py``), kept here so that a
change to the program cannot change the yardstick it is judged by. It imports
torch alone: nothing of the program, of the JAX package or of JAX.

    eb    = eb_rel * max(range, max|x|)      (eb_mode "rel", float32)
    q     = rint(x / (2 eb))                 pre-quantization, half to even
    delta = Lorenzo(q)                       int32 backward differences
    code  = sign_mag_u16(delta)              or zigzag; saturating
    words = bitshuffle(codes)                16x16 bit transposes, plane-major tiles
    flags = any(block of 8 words != 0)       packed LSB first into uint32
    rows  = the flagged blocks, in order     the used payload
    size  = header + a flag bit a block + used rows + 8 bytes an outlier

With exact outliers the first ``max(1, int(n * outlier_frac))`` overflowing
deltas, in flat order, keep their int32 residual against their flat index.

The shuffle, flag and compaction stages and their inverses run over blocks of
``CHUNK_TILES`` tiles, so a field of 2^28 elements fits beside the program's
state on the card; the Lorenzo stage runs over the whole field.
"""
from __future__ import annotations

import dataclasses

import torch

TILE = 4096                       # codes a shuffle tile
GROUP = 16                        # codes a bit-matrix transpose group
GROUPS_PER_TILE = TILE // GROUP   # 256
BLOCK_WORDS = 8                   # u16 words a zero-detection block (16 bytes)
BLOCK_BYTES = 2 * BLOCK_WORDS
FLAGS_PER_WORD = 32
BLOCKS_PER_TILE = TILE // BLOCK_WORDS            # 512
FLAG_WORDS_PER_TILE = BLOCKS_PER_TILE // FLAGS_PER_WORD   # 16
CHUNK_TILES = 4096                # tiles a block of the shuffle stages (16.8M codes)
HEADER_BYTES = 32                 # the stored size's fixed header
OUTLIER_BYTES = 8                 # an outlier's index and residual, int32 each
MAX_MAG = 0x7FFF
SIGN_BIT = 0x8000
_STAGES = ((8, 0xFF00), (4, 0xF0F0), (2, 0xCCCC), (1, 0xAAAA))
_INT32_MAX = 2**31 - 1
_BELOW_2_31 = 2147483520.0        # the largest float32 below 2**31


@dataclasses.dataclass
class Container:
    """What the reference works out for one field: the used parts only."""
    bitflags: torch.Tensor        # uint32[n_tiles * 16]
    payload: torch.Tensor         # uint16[nnz, 8], the flagged blocks in order
    nnz: int
    outlier_idx: torch.Tensor     # int32[n_outliers]
    outlier_val: torch.Tensor     # int32[n_outliers]
    n_outliers: int
    eb_abs: torch.Tensor          # float32[]
    shape: tuple[int, ...]


def n_padded(n: int) -> int:
    return -(-n // TILE) * TILE


def stored_bytes(n: int, nnz: int, n_outliers: int) -> int:
    """Bytes a writer stores for a container of ``n`` elements: the header, one
    flag bit a 16-byte block, the used blocks and the outliers."""
    return (HEADER_BYTES + (n_padded(n) // BLOCK_WORDS + 7) // 8 + nnz * BLOCK_BYTES
            + n_outliers * OUTLIER_BYTES)


def resolve_eb(x: torch.Tensor, eb: float, eb_mode: str) -> torch.Tensor:
    """Absolute bound as a float32 scalar: ``eb`` or ``eb * max(range, max|x|)``."""
    if eb_mode == "abs":
        return torch.full((), eb, dtype=torch.float32, device=x.device)
    if eb_mode != "rel":
        raise ValueError(f"unknown eb_mode {eb_mode!r}")
    hi = x.amax().to(torch.float32)
    lo = x.amin().to(torch.float32)
    out = torch.maximum(hi - lo, torch.maximum(hi.abs(), lo.abs())) \
        * torch.full((), eb, dtype=torch.float32, device=x.device)
    return torch.clamp(out, min=1e-30)


def prequantize(x: torch.Tensor, eb: torch.Tensor) -> torch.Tensor:
    """``rint(x / (2 eb))`` as int32; NaN to 0, saturating past the int32 range."""
    r = torch.round(x.to(torch.float32) / (2.0 * eb))
    q = torch.nan_to_num(r, nan=0.0).clamp(-2.0**31, _BELOW_2_31).to(torch.int32)
    return torch.where(r >= 2.0**31, _INT32_MAX, q)


def lorenzo_delta(q: torch.Tensor) -> torch.Tensor:
    d = q
    for ax in range(q.ndim):
        d = torch.diff(d, dim=ax, prepend=torch.zeros_like(d.narrow(ax, 0, 1)))
    return d


def lorenzo_inverse(delta: torch.Tensor) -> torch.Tensor:
    """Prefix sums per axis in int64, cut to int32 (wrapping int32 arithmetic)."""
    q = delta.to(torch.int64)
    for ax in range(delta.ndim):
        q = torch.cumsum(q, dim=ax)
    return q.to(torch.int32)


def to_codes(d: torch.Tensor, code_mode: str):
    """int32 delta -> (u16 code as int32, overflow mask, int32 residual)."""
    if code_mode == "sign_mag":
        mag = torch.abs(d)
        over = mag > MAX_MAG
        sat = torch.clamp(mag, max=MAX_MAG)
        code = (sat & 0xFFFF) | torch.where(d < 0, SIGN_BIT, 0).to(torch.int32)
        rec = torch.where(d < 0, -sat, sat)
    elif code_mode == "zigzag":
        z = (d << 1) ^ (d >> 31)
        over = z > 0xFFFF
        zs = torch.clamp(z, max=0xFFFF)
        code = zs & 0xFFFF
        rec = (zs >> 1) ^ -(zs & 1)
    else:
        raise ValueError(f"unknown code_mode {code_mode!r}")
    return code, over, d - rec


def from_codes(code: torch.Tensor, code_mode: str) -> torch.Tensor:
    c = code.to(torch.int32)
    if code_mode == "sign_mag":
        mag = c & MAX_MAG
        return torch.where((c & SIGN_BIT) != 0, -mag, mag)
    if code_mode == "zigzag":
        return (c >> 1) ^ -(c & 1)
    raise ValueError(f"unknown code_mode {code_mode!r}")


def transpose16(x: torch.Tensor) -> torch.Tensor:
    """Bit-matrix transpose of (..., 16) groups of u16 values (an involution)."""
    idx = torch.arange(GROUP, device=x.device)
    for delta, mask in _STAGES:
        lo = ~mask & 0xFFFF
        partner = x[..., idx ^ delta]
        hi_val = (x & mask) | ((partner & mask) >> delta)
        lo_val = ((partner & lo) << delta) | (x & lo)
        x = torch.where((idx & delta) == 0, hi_val, lo_val)
    return x


def bitshuffle(codes: torch.Tensor) -> torch.Tensor:
    """Whole tiles of int32 codes -> plane-major shuffled words."""
    return transpose16(codes.reshape(-1, GROUPS_PER_TILE, GROUP)).transpose(1, 2).reshape(-1)


def bitunshuffle(words: torch.Tensor) -> torch.Tensor:
    return transpose16(words.reshape(-1, GROUP, GROUPS_PER_TILE).transpose(1, 2)).reshape(-1)


def pack_flags(flags: torch.Tensor) -> torch.Tensor:
    """(k * 32,) bool -> (k,) uint32, least significant bit first."""
    shifts = torch.arange(FLAGS_PER_WORD, dtype=torch.int64, device=flags.device)
    return (flags.to(torch.int64).reshape(-1, FLAGS_PER_WORD) << shifts).sum(-1).to(torch.uint32)


def unpack_flags(words: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(FLAGS_PER_WORD, dtype=torch.int64, device=words.device)
    return ((words.to(torch.int64)[:, None] >> shifts) & 1).reshape(-1).to(torch.bool)


def _tile_chunks(n_tiles: int):
    for t0 in range(0, n_tiles, CHUNK_TILES):
        yield t0, min(n_tiles, t0 + CHUNK_TILES)


def compress(x: torch.Tensor, *, eb: float, eb_mode: str = "rel", code_mode: str = "sign_mag",
             exact_outliers: bool = True, outlier_frac: float = 1 / 256) -> Container:
    """A 1-3D float32 (or bfloat16) field -> its :class:`Container`."""
    n, shape = x.numel(), tuple(x.shape)
    eb_abs = resolve_eb(x, eb, eb_mode)
    code, over, resid = to_codes(lorenzo_delta(prequantize(x, eb_abs)), code_mode)
    over = over.reshape(-1)
    ocap = max(1, int(n * outlier_frac)) if exact_outliers else 0
    hit = torch.nonzero(over).reshape(-1)[:ocap]
    outlier_val = resid.reshape(-1)[hit].to(torch.int32)
    del over, resid
    codes = torch.nn.functional.pad(code.reshape(-1), (0, n_padded(n) - n))
    del code
    words, rows = [], []
    for t0, t1 in _tile_chunks(codes.numel() // TILE):
        blocks = bitshuffle(codes[t0 * TILE:t1 * TILE]).reshape(-1, BLOCK_WORDS)
        flags = torch.any(blocks != 0, dim=-1)
        words.append(pack_flags(flags))
        rows.append((blocks[flags] & 0xFFFF).to(torch.uint16))
    payload = torch.cat(rows)
    return Container(bitflags=torch.cat(words), payload=payload, nnz=payload.shape[0],
                     outlier_idx=hit.to(torch.int32), outlier_val=outlier_val,
                     n_outliers=hit.numel(), eb_abs=eb_abs, shape=shape)


def decompress(bitflags: torch.Tensor, payload: torch.Tensor, eb_abs: torch.Tensor,
               shape: tuple[int, ...], *, code_mode: str = "sign_mag",
               outlier_idx: torch.Tensor | None = None, outlier_val: torch.Tensor | None = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Container parts -> float32[shape]. ``payload`` holds the used rows first
    (rows past them are ignored); outlier slots at index ``n`` or past it add
    nothing. ``out_dtype`` is the precision of the dequantizing product."""
    n = 1
    for s in shape:
        n *= s
    n_tiles = n_padded(n) // TILE
    codes = torch.empty(n_tiles * TILE, dtype=torch.int32, device=payload.device)
    row = 0
    for t0, t1 in _tile_chunks(n_tiles):
        flags = unpack_flags(bitflags[t0 * FLAG_WORDS_PER_TILE:t1 * FLAG_WORDS_PER_TILE])
        k = int(flags.sum())
        blocks = torch.zeros(flags.numel(), BLOCK_WORDS, dtype=torch.int32,
                             device=payload.device)
        blocks[flags] = payload[row:row + k].to(torch.int32) & 0xFFFF
        row += k
        codes[t0 * TILE:t1 * TILE] = bitunshuffle(blocks.reshape(-1))
    delta = from_codes(codes[:n], code_mode)
    del codes
    if outlier_idx is not None and outlier_idx.numel():
        idx = outlier_idx.to(torch.int64)
        add = torch.where(idx < n, outlier_val.to(torch.int32), 0).to(torch.int32)
        delta = delta.index_add(0, torch.clamp(idx, max=n - 1), add)
    q = lorenzo_inverse(delta.reshape(shape))
    del delta
    return (q.to(out_dtype) * (2.0 * eb_abs).to(out_dtype)).to(torch.float32)
