"""Wrapper of K7 flash-decode (csrc/flash_decode.cu) and its public entry points.

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py:_decode_partials_tiles``:
split-KV online-softmax decode attention partials ``(m, num, den)`` with GQA,
over a contiguous ``(B, S, KVH, D)`` cache or the pool's page view
``(B, P, ps, KVH, D)``. q is pre-scaled by ``D**-0.5`` in float32 before the
kernel; accumulation is float32; the mask is ``pos < min(length - shard_offset,
S_slice)``. A fully masked row gives ``m == NEG_INF`` and ``num == den == 0``.

``flash_decode_partials`` is the one wrapper that launches the kernel and
counts its launches. Each row's tiles are split across CTAs
(``split_count``), and a second small launch combines the splits; the call
counts as one launch of K7. For a CPU tensor it runs the plain version of the
same split and combine (``kernels/ref.py:flash_decode_split_ref``); for a CUDA
tensor it launches the kernel on the current stream or raises. The page view
is read in place through its batch and page strides (each page's
``(ps, KVH, D)`` block must be contiguous); a contiguous cache is read as tiles
of ``kv_tile`` positions, the ragged last tile masked in the kernel instead of
padded.

Entry points (``device`` defaults to the card, as everywhere in the port):
``decode_partials``, ``decode_partials_pages``, ``flash_decode``; and
``combine_partials`` to normalize partials.

Both launches register their spec builders here (``flash_decode``,
``flash_decode.combine``); :func:`specs` lists a call's launches, from
:func:`split_count`, with the dynamic shared bytes asked of the C side on the
card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..analysis.kernelspec import KernelSpec, register_spec
from ..device import resolve_device
from . import build, ref

NEG_INF = ref.NEG_INF    # the reference's finite -inf stand-in
KV_TILE = 128            # default KV positions a tile on the contiguous entry
TARGET_CTAS = 264        # about two CTAs on each of the H100's 132 SMs
_SOURCE = "flash_decode.cu"
THREADS, COMBINE_THREADS = 256, 128


def split_count(B: int, KVH: int, n_tiles: int) -> int:
    """Splits of a row's tiles: enough for about ``TARGET_CTAS`` CTAs over the
    (split, KVH, B) grid, at most one tile a split, every split non-empty. The
    Yi-6B page set (B 4, KVH 4, 13 pages) gets 13 splits, 208 CTAs."""
    want = max(1, min(n_tiles, -(-TARGET_CTAS // (B * KVH))))
    tps = -(-n_tiles // want)
    return -(-n_tiles // tps)


@register_spec("flash_decode")
def partials_spec(B: int, n_tiles: int, KVH: int, G: int, D: int, dtype: str = "bfloat16",
                  point: str = "") -> KernelSpec:
    """The split partials: grid (splits, KVH, B)."""
    q = (_SOURCE, "fz_flash_decode_smem", (int(dtype == "bfloat16"), D))
    return KernelSpec(
        name="flash_decode", module=_SOURCE, symbol="flash_decode_partials",
        grid=(split_count(B, KVH, n_tiles), KVH, B), threads=THREADS,
        dynamic_smem=build.query(*q),
        point=point or f"B {B} KVH {KVH} G {G} D {D} {n_tiles} tiles {dtype}", c_query=q)


@register_spec("flash_decode.combine")
def combine_spec(B: int, KVH: int, G: int, splits: int, point: str = "") -> KernelSpec:
    """The combine of the splits: grid (G, KVH, B)."""
    q = (_SOURCE, "fz_flash_decode_combine_smem", (int(splits),))
    return KernelSpec(
        name="flash_decode.combine", module=_SOURCE, symbol="flash_decode_combine",
        grid=(G, KVH, B), threads=COMBINE_THREADS, dynamic_smem=build.query(*q),
        point=point or f"B {B} KVH {KVH} G {G} {splits} splits", c_query=q)


def specs(B: int, n_tiles: int, KVH: int, G: int, D: int, dtype: str = "bfloat16",
          point: str = "") -> list[KernelSpec]:
    """The launches of one call of K7: the partials, and the combine where a row
    has more than one split."""
    out = [partials_spec(B, n_tiles, KVH, G, D, dtype, point)]
    splits = out[0].grid[0]
    if splits > 1:
        out.append(combine_spec(B, KVH, G, splits, point))
    return out


def _strides(t: torch.Tensor, KVH: int, D: int) -> tuple[int, int]:
    """(batch, tile) element strides of a (B, T, tile, KVH, D) view whose tiles are
    contiguous."""
    if t.stride(4) != 1 or t.stride(3) != D or t.stride(2) != KVH * D:
        raise ValueError("flash_decode needs each (tile, KVH, D) block contiguous, got "
                         f"strides {t.stride()}")
    return t.stride(0), t.stride(1)


def flash_decode_partials(q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length_eff: torch.Tensor, *, tile: int | None = None):
    """K7: (m, num, den) partials of one KV slice.

    q4: (B, KVH, G, D) float32, pre-scaled; length_eff: (B,) int32, the valid
    positions of the slice. k/v: the tiles (B, T, tile, KVH, D), float32 or
    bfloat16, or a contiguous slice (B, S, KVH, D) read in tiles of ``tile``
    positions. Returns (B, KVH, G), (B, KVH, G, D), (B, KVH, G) float32.
    """
    B, KVH, G, D = q4.shape
    if k.ndim == 4:                       # contiguous slice: T tiles, the last ragged
        S = k.shape[1]
        tile = min(tile or KV_TILE, S)
        n_tiles = -(-S // tile)
    else:
        n_tiles, tile = k.shape[1], k.shape[2]
    splits = split_count(B, KVH, n_tiles)
    if k.device.type == "cpu":
        if k.ndim == 4:
            pad = n_tiles * tile - k.shape[1]
            k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)).reshape(B, n_tiles, tile, KVH, D)
                    for t in (k, v))
        return ref.flash_decode_split_ref(q4, k, v, length_eff, splits)
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise ValueError(f"flash_decode takes float32 or bfloat16 K/V, got {k.dtype}, {v.dtype}")
    if (q4.dtype != torch.float32 or not q4.is_contiguous() or q4.device != dev
            or v.device != dev or length_eff.device != dev):
        raise ValueError(f"q must be contiguous float32 (B, KVH, G, D) on {dev}")
    if length_eff.dtype != torch.int32 or length_eff.shape != (B,) \
            or not length_eff.is_contiguous():
        raise ValueError(f"length_eff must be contiguous int32[{B}]")
    if k.shape[0] != B or k.shape[-2:] != (KVH, D) or v.shape != k.shape:
        raise ValueError(f"K/V shape {tuple(k.shape)} does not fit q {tuple(q4.shape)}")
    if not (1 <= G <= 32 and 1 <= D <= 256):
        raise ValueError(f"flash_decode supports 1 <= G <= 32 and D <= 256, got G={G} D={D}")
    if k.ndim == 4:
        strides = []
        for t in (k, v):
            if t.stride(3) != 1 or t.stride(2) != D or t.stride(1) != KVH * D:
                raise ValueError("flash_decode needs each position's (KVH, D) block "
                                 f"contiguous, got strides {t.stride()}")
            strides += [t.stride(0), tile * t.stride(1)]
    else:
        strides = [*_strides(k, KVH, D), *_strides(v, KVH, D)]
    m = torch.empty((B, KVH, G), dtype=torch.float32, device=dev)
    num = torch.empty((B, KVH, G, D), dtype=torch.float32, device=dev)
    den = torch.empty((B, KVH, G), dtype=torch.float32, device=dev)
    lib = build.library(_SOURCE)
    words = lib.fz_flash_decode_scratch_floats(B, KVH, G, D, splits)
    scratch = torch.empty(words, dtype=torch.float32, device=dev) if words else None
    rc = lib.fz_flash_decode(
        q4.data_ptr(), k.data_ptr(), v.data_ptr(), length_eff.data_ptr(),
        int(k.dtype == torch.bfloat16), B, KVH, G, D, n_tiles, tile, splits, *strides,
        m.data_ptr(), num.data_ptr(), den.data_ptr(),
        scratch.data_ptr() if words else None, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "fz_flash_decode", rc)
    flash_decode_partials.launches += 1
    return m, num, den


flash_decode_partials.launches = 0


def prep_q(q: torch.Tensor, KVH: int) -> torch.Tensor:
    """(B, H, D) -> (B, KVH, G, D) float32 scaled by D**-0.5."""
    B, H, D = q.shape
    return (q.reshape(B, KVH, H // KVH, D).to(torch.float32) * D ** -0.5).contiguous()


def length_eff(length: torch.Tensor, shard_offset, s_valid: int) -> torch.Tensor:
    """``min(length - shard_offset, s_valid)`` as int32: the slice's global offset
    folded into the mask, clamped to the slice's real width (positions past it
    belong to a later slice and must never pass the mask)."""
    le = length.to(torch.int32).reshape(-1) - shard_offset
    return torch.clamp(le, max=s_valid).to(torch.int32).contiguous()


def _empty(B: int, KVH: int, G: int, D: int, dev: torch.device):
    return (torch.full((B, KVH, G), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((B, KVH, G, D), dtype=torch.float32, device=dev),
            torch.zeros((B, KVH, G), dtype=torch.float32, device=dev))


def decode_partials(q, k_cache, v_cache, length, *, shard_offset=0,
                    kv_tile: int | None = None, device="cuda"):
    """Kernel drop-in for ``dist.flash_decode.decode_partials`` (contiguous slice).

    q: (B, H, D); k_cache/v_cache: (B, S_slice, KVH, D); length: (B,) global
    valid prefix; ``shard_offset``: global position of the slice's first slot.
    Tiles are ``kv_tile`` positions (default ``KV_TILE``, clamped to the
    slice). Returns (m, num, den).
    """
    dev = resolve_device(device)
    q, k_cache, v_cache = (torch.as_tensor(t).to(dev) for t in (q, k_cache, v_cache))
    B, S, KVH, D = k_cache.shape
    if S == 0:                            # zero-width slice: the empty contract
        return _empty(B, KVH, q.shape[1] // KVH, D, dev)
    le = length_eff(torch.as_tensor(length).to(dev), shard_offset, S)
    return flash_decode_partials(prep_q(q, KVH), k_cache, v_cache, le, tile=kv_tile)


def decode_partials_pages(q, k_pages, v_pages, length, *, device="cuda"):
    """Page-native partials: ``k_pages``/``v_pages`` (B, P, ps, KVH, D) as
    ``PagePool.gather_pages`` emits them (a page is a tile, read in place);
    length: (B,) valid prefix over the concatenated pages. Returns (m, num, den)."""
    dev = resolve_device(device)
    q, k_pages, v_pages = (torch.as_tensor(t).to(dev) for t in (q, k_pages, v_pages))
    _, P, ps, KVH, _ = k_pages.shape
    le = length_eff(torch.as_tensor(length).to(dev), 0, P * ps)
    return flash_decode_partials(prep_q(q, KVH), k_pages, v_pages, le)


def combine_partials(m, num, den, dtype=torch.float32) -> torch.Tensor:
    """Normalize partials to the attention output (B, H, D). All-empty rows have
    num == den == 0 and come out exactly 0."""
    B, KVH, G, D = num.shape
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, KVH * G, D).to(dtype)


def flash_decode(q, k_cache, v_cache, length, *, kv_tile: int | None = None,
                 device="cuda") -> torch.Tensor:
    """Decode attention over a contiguous cache through K7; drop-in for
    ``models.attention.decode_attention``."""
    m, num, den = decode_partials(q, k_cache, v_cache, length, kv_tile=kv_tile,
                                  device=device)
    return combine_partials(m, num, den, dtype=torch.as_tensor(q).dtype)
