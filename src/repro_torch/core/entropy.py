"""Second-stage lossless entropy coder for serialized containers: the port of
``repro.core.entropy``, byte for byte the same blobs.

The bitshuffle + zero-flag pipeline trades compression ratio for
throughput. This module recovers ratio where latency does not matter --
parked KV pages and checkpoints -- with a canonical Huffman coder over the
compacted payload *bytes*:

* **Canonical, length-limited codes.** Code lengths come from a Huffman
  build (`huffman_code_lengths`), capped at ``MAX_CODE_LEN`` by count-halving
  until the tree fits, so decode uses one ``2**MAX_CODE_LEN``-entry table.
* **Gap-array chunked layout.** The bitstream is cut into fixed-size source
  chunks and the bit offset of every chunk start is stored in the blob
  header (arXiv 2201.09118), so the decoder walks all chunks in lockstep,
  one symbol per step, vectorized across the chunk axis.
* **Skip probe.** ``plan()`` gives the *exact* encoded size from a byte
  histogram without building the bitstream, so callers skip incompressible
  containers for the cost of one histogram.

Host-side numpy only: variable-length codes do not fit fixed-shape device
tensors, and the cold tier is latency-insensitive. The hot path
(``core/fz.py`` compress/decompress) never calls into this module.

Blob layout (all little-endian, offsets in bytes)::

    0    u64   n_bytes      source length
    8    u32   chunk_bytes  source bytes per chunk
    12   u32   n_chunks     ceil(n_bytes / chunk_bytes)
    16   u64   total_bits   bitstream length in bits
    24   u8[256]            canonical code length per byte symbol
    280  u64[n_chunks]      gap array: bit offset of each chunk start
    ...  u8[ceil(total_bits / 8)]   bitstream, MSB-first within each byte
"""
from __future__ import annotations

import heapq
import struct

import numpy as np

MAX_CODE_LEN = 15          # decode table is 2**MAX_CODE_LEN entries (32 K)
DEFAULT_CHUNK = 4096       # source bytes per gap-array chunk
_HEADER = struct.Struct("<QIIQ")
_FIXED_OVERHEAD = _HEADER.size + 256  # header + code-length table

__all__ = [
    "MAX_CODE_LEN", "DEFAULT_CHUNK", "EntropyError",
    "huffman_code_lengths", "limit_code_lengths", "canonical_codes",
    "plan", "encode", "decode", "overhead_bytes",
]


class EntropyError(ValueError):
    """Raised on malformed / truncated entropy blobs."""


# ---------------------------------------------------------------------------
# code construction
# ---------------------------------------------------------------------------

def huffman_code_lengths(counts: np.ndarray) -> np.ndarray:
    """Code lengths of a Huffman code for symbol counts (package-free).

    O(k log k) over the nonzero alphabet.
    """
    counts = np.asarray(counts)
    sym = np.nonzero(counts)[0]
    if sym.size == 0:
        return np.zeros_like(counts)
    if sym.size == 1:
        lengths = np.zeros_like(counts)
        lengths[sym[0]] = 1
        return lengths
    heap = [(int(counts[s]), i, [int(s)]) for i, s in enumerate(sym)]
    heapq.heapify(heap)
    lengths = np.zeros_like(counts)
    uid = len(heap)
    while len(heap) > 1:
        c1, _, s1 = heapq.heappop(heap)
        c2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (c1 + c2, uid, s1 + s2))
        uid += 1
    return lengths


def limit_code_lengths(counts: np.ndarray,
                       max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Huffman code lengths capped at ``max_len`` via count-halving.

    Halving skewed counts flattens the tree; the fixed point (all counts 1)
    is the balanced tree of depth ceil(log2 k) <= 8 for byte symbols, so the
    loop always terminates well under any ``max_len`` >= 8.
    """
    counts = np.asarray(counts, np.int64)
    lengths = huffman_code_lengths(counts)
    while int(lengths.max(initial=0)) > max_len:
        counts = np.where(counts > 0, (counts + 1) // 2, 0)
        lengths = huffman_code_lengths(counts)
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical Huffman codewords (MSB-aligned ints) from code lengths.

    Symbols are ordered by (length, symbol); consecutive codewords tile the
    ``[0, 2**max_len)`` prefix space contiguously, which is what lets decode
    use a flat lookup table built with two ``np.repeat`` calls.
    """
    lengths = np.asarray(lengths, np.int64)
    codes = np.zeros_like(lengths)
    code = 0
    prev_len = 0
    for s in np.lexsort((np.arange(lengths.size), lengths)):
        l = int(lengths[s])
        if l == 0:
            continue
        code <<= (l - prev_len)
        codes[s] = code
        code += 1
        prev_len = l
    return codes


# ---------------------------------------------------------------------------
# skip probe
# ---------------------------------------------------------------------------

def overhead_bytes(n_chunks: int) -> int:
    """Fixed blob overhead: header + length table + gap array."""
    return _FIXED_OVERHEAD + 8 * n_chunks


def plan(counts: np.ndarray, n_bytes: int,
         chunk_bytes: int = DEFAULT_CHUNK) -> tuple[np.ndarray, int]:
    """(code lengths, exact encoded blob size) from a byte histogram.

    This is the skip probe: one ``np.bincount`` plus a 256-symbol Huffman
    build gives the *exact* size ``encode`` would produce, without the
    O(total_bits) bit expansion — callers compare it against ``n_bytes``
    and skip incompressible containers.
    """
    lengths = limit_code_lengths(counts)
    total_bits = int((np.asarray(counts, np.int64) * lengths).sum())
    n_chunks = -(-n_bytes // chunk_bytes) if n_bytes else 0
    return lengths, overhead_bytes(n_chunks) + (total_bits + 7) // 8


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

_ENC_SEGMENT = 1 << 16  # source bytes bit-expanded per vectorized pass


def encode(data: bytes | np.ndarray, chunk_bytes: int = DEFAULT_CHUNK,
           lengths: np.ndarray | None = None) -> bytes:
    """Encode bytes into a self-describing gap-array Huffman blob."""
    arr = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    n = arr.size
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    if lengths is None:
        lengths = limit_code_lengths(np.bincount(arr, minlength=256))
    lengths = np.asarray(lengths, np.int64)
    if n == 0:
        return _HEADER.pack(0, chunk_bytes, 0, 0) + bytes(256)
    codes = canonical_codes(lengths).astype(np.uint32)
    sym_len = lengths[arr]
    ends = np.cumsum(sym_len)
    starts = ends - sym_len
    total_bits = int(ends[-1])
    offsets = starts[np.arange(0, n, chunk_bytes)]
    # MSB-first bit expansion, segmented to bound peak memory at
    # ~MAX_CODE_LEN * _ENC_SEGMENT int64 temporaries per pass
    bits = np.empty(total_bits, np.uint8)
    for s0 in range(0, n, _ENC_SEGMENT):
        s1 = min(n, s0 + _ENC_SEGMENT)
        seg_len = sym_len[s0:s1]
        seg_bits = int(seg_len.sum())
        if seg_bits == 0:
            continue
        base = int(starts[s0])
        rel = np.repeat(np.arange(s1 - s0), seg_len)
        k = (np.arange(seg_bits, dtype=np.int64)
             - (starts[s0:s1] - base)[rel])
        c = codes[arr[s0:s1]][rel]
        bits[base:base + seg_bits] = (
            (c >> (seg_len[rel] - 1 - k)) & 1).astype(np.uint8)
    stream = np.packbits(bits)
    return (_HEADER.pack(n, chunk_bytes, offsets.size, total_bits)
            + lengths.astype(np.uint8).tobytes()
            + offsets.astype("<u8").tobytes()
            + stream.tobytes())


def _decode_table(lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Flat 2**M lookup: next-M-bits window -> (symbol, code length)."""
    m = int(lengths.max(initial=1))
    order = np.lexsort((np.arange(256), lengths))
    order = order[lengths[order] > 0]
    widths = 1 << (m - lengths[order])
    table_sym = np.repeat(order.astype(np.uint8), widths)
    table_len = np.repeat(lengths[order].astype(np.int64), widths)
    pad = (1 << m) - table_sym.size  # nonzero for incomplete (1-symbol) codes
    if pad:
        table_sym = np.concatenate([table_sym, np.zeros(pad, np.uint8)])
        table_len = np.concatenate([table_len, np.zeros(pad, np.int64)])
    return table_sym, table_len, m


def decode(blob: bytes | memoryview) -> bytes:
    """Decode a blob produced by :func:`encode`.

    Chunks are walked in lockstep — one symbol per step for *every* chunk,
    vectorized across the chunk axis from the gap-array offsets — i.e. the
    block-parallel structure of arXiv 2201.09118 expressed in numpy.
    """
    blob = memoryview(blob)
    if len(blob) < _FIXED_OVERHEAD:
        raise EntropyError(f"entropy blob truncated: {len(blob)} bytes")
    n, chunk_bytes, n_chunks, total_bits = _HEADER.unpack_from(blob, 0)
    if n == 0:
        return b""
    lengths = np.frombuffer(blob, np.uint8, 256, _HEADER.size).astype(np.int64)
    body = _FIXED_OVERHEAD + 8 * n_chunks
    need = body + (total_bits + 7) // 8
    if len(blob) < need or n_chunks != -(-n // chunk_bytes):
        raise EntropyError(
            f"entropy blob inconsistent: {len(blob)} bytes, need {need} "
            f"({n_chunks} chunks of {chunk_bytes})")
    offsets = np.frombuffer(blob, "<u8", n_chunks, _FIXED_OVERHEAD
                            ).astype(np.int64)
    stream = np.frombuffer(blob, np.uint8, (total_bits + 7) // 8, body)
    stream = np.concatenate([stream, np.zeros(4, np.uint8)])  # window slack
    table_sym, table_len, m = _decode_table(lengths)

    out = np.empty(n, np.uint8)
    pos = offsets.copy()
    base = np.arange(n_chunks, dtype=np.int64) * chunk_bytes
    last_size = n - int(base[-1])  # only the final chunk may be short
    for step in range(chunk_bytes):
        if step >= last_size and n_chunks == 1:
            break
        act = slice(0, n_chunks if step < last_size else n_chunks - 1)
        if act.stop == 0:
            break
        p = pos[act]
        b = np.minimum(p >> 3, stream.size - 3)  # stay in-bounds if corrupt
        window = ((stream[b].astype(np.uint32) << 16)
                  | (stream[b + 1].astype(np.uint32) << 8)
                  | stream[b + 2].astype(np.uint32))
        idx = (window >> (24 - m - (p & 7))) & ((1 << m) - 1)
        ln = table_len[idx]
        if not ln.all():
            raise EntropyError("corrupt entropy stream: unassigned codeword")
        out[base[act] + step] = table_sym[idx]
        pos[act] = p + ln
    # every chunk must land exactly on the next chunk's gap-array offset
    expected_ends = np.concatenate([offsets[1:], [total_bits]])
    if not np.array_equal(pos, expected_ends):
        raise EntropyError("corrupt entropy stream: chunk boundary mismatch")
    return out.tobytes()
