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

Each of the call's three launch sites registers its spec builder here
(``fused_decompress.bin_residuals``, ``.decode_scan_rows``,
``.scan_columns``); :func:`specs` lists the launches of one call, the column
passes from :func:`column_passes`.

While ``obs`` records, each call on the card counts its column passes in
``fz_column_passes{stash=1|0}``: stashed (the strip's rows kept in shared
memory) or read twice from HBM (:func:`column_stash`). No device read.
"""
from __future__ import annotations

import torch

from ..analysis.kernelspec import KernelSpec, register_spec
from ..obs import registry as _reg
from ..obs import spans
from . import build, ref
from .fused_compress import _check_eb, _code_mode, FLAG_WORDS_PER_TILE, MAX_N, THREADS, TILE

_SOURCE = "fz_decompress.cu"
ROWS_MIN_CTAS = 4             # __launch_bounds__ minimum of decode_scan_rows
BIN_THREADS = 256


def column_passes(shape) -> list[tuple[int, int, int]]:
    """(len, inner, outer) of each column pass after the row pass, in launch
    order: every axis but the last of the shape without its axes of size 1,
    the last pass on axis 0 (``fz_fused_decompress``)."""
    dims = [int(s) for s in shape if s != 1] or [1]
    out = []
    for a in range(len(dims) - 2, -1, -1):
        outer = inner = 1
        for b in dims[:a]:
            outer *= b
        for b in dims[a + 1:]:
            inner *= b
        out.append((dims[a], inner, outer))
    return out


_stash: dict = {}     # shape -> the fz_column_passes increments of a call


def column_stash(shape: tuple) -> tuple:
    """The ``fz_column_passes`` increments of one call on the card at ``shape``,
    as (labels, n): a pass is stashed where the library's
    ``fz_scan_columns_smem(len)`` is not 0. Worked out once a shape (the
    library's query needs the card)."""
    got = _stash.get(shape)
    if got is None:
        lib = build.library(_SOURCE)
        lens = [p[0] for p in column_passes(shape)]
        unstashed = sum(lib.fz_scan_columns_smem(n) == 0 for n in lens)
        got = _stash[shape] = tuple((labels, k) for labels, k in
                                    (({"stash": 1}, len(lens) - unstashed),
                                     ({"stash": 0}, unstashed)) if k)
    return got


@register_spec("fused_decompress.bin_residuals")
def bin_residuals_spec(n_out: int, point: str = "") -> KernelSpec:
    """The residual binning pass (outlier slots only)."""
    return KernelSpec(name="fused_decompress.bin_residuals", module=_SOURCE,
                      symbol="bin_residuals", grid=(-(-int(n_out) // BIN_THREADS),),
                      threads=BIN_THREADS, point=point or f"{n_out} outlier slots")


@register_spec("fused_decompress.decode_scan_rows")
def decode_scan_rows_spec(n_tiles: int, point: str = "") -> KernelSpec:
    """The fused decode + last-axis prefix: one CTA a tile, static shared memory."""
    return KernelSpec(name="fused_decompress.decode_scan_rows", module=_SOURCE,
                      symbol="decode_scan_rows", grid=(int(n_tiles),), threads=THREADS,
                      min_ctas=ROWS_MIN_CTAS, point=point or f"{n_tiles} tiles",
                      carry="lookback")


@register_spec("fused_decompress.scan_columns")
def scan_columns_spec(length: int, inner: int, outer: int, point: str = "") -> KernelSpec:
    """A column pass: one CTA a strip of 32 columns, the strip's rows in dynamic
    shared memory where they fit (``fz_scan_columns_smem``)."""
    q = (_SOURCE, "fz_scan_columns_smem", (int(length),))
    return KernelSpec(name="fused_decompress.scan_columns", module=_SOURCE,
                      symbol="scan_columns", grid=(int(outer) * -(-int(inner) // 32),),
                      threads=THREADS, dynamic_smem=build.query(*q),
                      point=point or f"columns of {length}, inner {inner}, outer {outer}",
                      c_query=q)


def specs(shape, n_out: int = 0, point: str = "") -> list[KernelSpec]:
    """The launches of one call of K6 on ``shape`` with ``n_out`` outlier slots."""
    n = 1
    for s in shape:
        n *= int(s)
    point = point or f"{tuple(shape)}"
    out = [bin_residuals_spec(n_out, point)] if n_out else []
    out.append(decode_scan_rows_spec(-(-n // TILE), point))
    out += [scan_columns_spec(*p, point=point) for p in column_passes(shape)]
    return out


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
    if _reg._enabled:         # the guard of core/fz.py's dispatch count
        for labels, k in column_stash(shape):
            spans.count("fz_column_passes", labels, k)
    return out


fused_decompress.launches = 0
