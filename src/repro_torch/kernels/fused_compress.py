"""Wrappers of K4 ``fused_compress`` and K5 ``fused_shuffle_encode`` (csrc/fz_compress.cu).

K4 replaces the Pallas TPU kernel ``repro/kernels/fused_compress.py:fused_compress``:
float (1-3)D data -> (bitflags uint32[16 * tiles], payload uint16[capacity, 8],
nnz int32[]) in one launch. ``fused_compress_strict`` is the same launch with
the exact outlier channel of ``core.quant.dual_quantize`` (strict K4): the
fused route's strict mode. K5 replaces ``:fused_shuffle_encode``: the same
from u16 codes, the reference's strict-mode route, which the port's routes no
longer take. K4's payload is zeroed here before the launch; K5 writes all of
its payload itself (zero past ``nnz``).

For a CPU tensor a wrapper runs its plain version (``kernels/ref.py``); for a
CUDA tensor it launches the kernel on the current stream or raises. Each
wrapper counts its launches in ``<wrapper>.launches``.

``range_eb`` launches the bound's range pass of the same library: the
relative bound of ``core/fz.py:resolve_eb`` from one read of the field, the
same bits as its torch ops (``kernels/ops.py:relative_eb``, which routes
between the two). It has no plain version (those torch ops are it) and runs
on the card only.

Each launch registers its :class:`~repro_torch.analysis.kernelspec.KernelSpec`
builder here (``fused_compress``, ``fused_compress_strict``,
``fused_shuffle_encode``, ``range_eb``). K4's dynamic shared bytes are what
the C side's window plan sets (``fz_windows.cuh``), asked of the library on
the card (``fz_fused_compress_smem``, ``fz_fused_compress_strict_smem``).
"""
from __future__ import annotations

import torch

from ..analysis.kernelspec import KernelSpec, register_spec
from . import build, ref

TILE = ref.TILE
FLAG_WORDS_PER_TILE = 16
THREADS = 256                 # threads a CTA of K1-K4 and K6 (fz_common.cuh)
_SOURCE = "fz_compress.cu"
MAX_N = 2**31 - TILE          # the kernels index the stream in int32
_CODE_MODES = {"sign_mag": 0, "zigzag": 1}
WINDOW_MIN_CTAS = 5           # __launch_bounds__ minimum of K4 and K1's tile step
K5_THREADS = THREADS // 2     # two groups a thread
K5_MIN_CTAS = 16
RANGE_UNROLL = 4              # the range pass's 16-byte loads in flight a thread
RANGE_MIN_CTAS = 4            # its __launch_bounds__ minimum and CTAs an SM
RANGE_MAX_CTAS = 1024         # the CTAs' pairs its scratch holds (fz_compress.cu)
_RANGE_SCRATCH_WORDS = 2 + RANGE_MAX_CTAS   # int64: the ticket's 16 bytes, then the pairs
_RANGE_DTYPES = (torch.float32, torch.bfloat16)


def dims3(shape) -> tuple[int, int, int]:
    """(d0, d1, d2) of a 1-3D shape, padded with ones as the launches take it."""
    d = [int(s) for s in shape] + [1] * (3 - len(shape))
    return d[0], d[1], d[2]


def query_args(shape, dtype: str) -> tuple:
    """The arguments of K4's and K1's C queries for data of ``shape``, element 0
    on a 16-byte boundary."""
    return int(dtype == "bfloat16"), len(shape), *dims3(shape), 0


def _k4_spec(name: str, shape, dtype: str, point: str) -> KernelSpec:
    n = 1
    for s in shape:
        n *= int(s)
    q = (_SOURCE, f"fz_{name}_smem", query_args(shape, dtype))
    return KernelSpec(
        name=name, module=_SOURCE, symbol="encode_tiles",
        grid=(-(-n // TILE),), threads=THREADS, dynamic_smem=build.query(*q),
        min_ctas=WINDOW_MIN_CTAS, point=point or f"{tuple(shape)} {dtype}", c_query=q,
        carry="lookback")


@register_spec("fused_compress")
def fused_compress_spec(shape, dtype: str = "float32", point: str = "") -> KernelSpec:
    """K4 (``encode_tiles``): one CTA a tile, the windows in dynamic shared memory."""
    return _k4_spec("fused_compress", shape, dtype, point)


@register_spec("fused_compress_strict")
def fused_compress_strict_spec(shape, dtype: str = "float32", point: str = "") -> KernelSpec:
    """Strict K4 (``encode_tiles`` of ``WindowCodesStrict``): K4's, with shared
    memory that also holds the shuffled tile and the overflows' residuals past
    it (at least 24 KiB)."""
    return _k4_spec("fused_compress_strict", shape, dtype, point)


@register_spec("fused_shuffle_encode")
def fused_shuffle_encode_spec(n_tiles: int, point: str = "") -> KernelSpec:
    """K5 (``shuffle_encode_tiles``): one CTA a tile, static shared memory only."""
    return KernelSpec(
        name="fused_shuffle_encode", module=_SOURCE, symbol="shuffle_encode_tiles",
        grid=(int(n_tiles),), threads=K5_THREADS, min_ctas=K5_MIN_CTAS,
        point=point or f"{n_tiles} tiles", carry="lookback")


@register_spec("range_eb")
def range_eb_spec(shape, dtype: str = "float32", point: str = "") -> KernelSpec:
    """The range pass (``range_eb``): a grid-stride read, the grid at most
    ``RANGE_MIN_CTAS`` CTAs an SM (here the H100's 132 SMs), static shared
    memory only."""
    n = 1
    for s in shape:
        n *= int(s)
    per_cta = THREADS * RANGE_UNROLL * (8 if dtype == "bfloat16" else 4)
    return KernelSpec(
        name="range_eb", module=_SOURCE, symbol="range_eb",
        grid=(min(-(-n // per_cta), 132 * RANGE_MIN_CTAS, RANGE_MAX_CTAS),), threads=THREADS,
        min_ctas=RANGE_MIN_CTAS, point=point or f"{tuple(shape)} {dtype}")


def _code_mode(code_mode: str) -> int:
    if code_mode not in _CODE_MODES:
        raise ValueError(f"unknown code_mode {code_mode!r}")
    return _CODE_MODES[code_mode]


def _check_eb(eb: torch.Tensor, device: torch.device) -> None:
    if eb.dtype != torch.float32 or eb.numel() != 1 or eb.device != device:
        raise ValueError(f"eb must be a float32 scalar on {device}, got "
                         f"{eb.dtype} {tuple(eb.shape)} on {eb.device}")


def _outputs(n_tiles: int, capacity: int, device: torch.device, *, zero_payload: bool,
             lookbacks: int = 1):
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    bitflags = torch.empty(n_tiles * FLAG_WORDS_PER_TILE, dtype=torch.uint32, device=device)
    alloc = torch.zeros if zero_payload else torch.empty
    payload = alloc(capacity, 8, dtype=torch.uint16, device=device)
    nnz = torch.empty((), dtype=torch.int32, device=device)
    # the look-back words, the ticket after the first array, and any further array
    scratch = torch.zeros(lookbacks * n_tiles + 1, dtype=torch.int64, device=device)
    return bitflags, payload, nnz, scratch


def _check_data(data: torch.Tensor, eb: torch.Tensor, who: str) -> None:
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{who} takes float32 or bfloat16, got {data.dtype}")
    if not 1 <= data.ndim <= 3:
        raise ValueError(f"{who} supports 1-3D, got {data.ndim}D")
    if not data.is_contiguous():
        raise ValueError(f"{who} needs a contiguous tensor")
    if not 0 < data.numel() <= MAX_N:
        raise ValueError(f"{who} takes 1..{MAX_N} elements, got {data.numel()}")
    _check_eb(eb, data.device)


def fused_compress(data: torch.Tensor, eb: torch.Tensor, *, capacity: int,
                   code_mode: str = "sign_mag"):
    """float32/bfloat16 (1-3)D -> (bitflags, payload, nnz).

    Bit-identical to ``encode(bitshuffle(pad(quantize(data))))``.
    """
    if data.device.type == "cpu":
        return ref.fused_compress_ref(data, eb, capacity=capacity, code_mode=code_mode)
    _check_data(data, eb, "fused_compress")
    n = data.numel()
    dims = list(data.shape) + [1] * (3 - data.ndim)
    n_tiles = -(-n // TILE)
    bitflags, payload, nnz, scratch = _outputs(n_tiles, capacity, data.device,
                                                zero_payload=True)
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


def fused_compress_strict(data: torch.Tensor, eb: torch.Tensor, *, capacity: int,
                          outlier_capacity: int, code_mode: str = "sign_mag"):
    """float32/bfloat16 (1-3)D -> (bitflags, payload, nnz, outlier_idx,
    outlier_val, n_over), strict K4's one launch.

    Bit-identical to ``dual_quantize`` with ``outlier_capacity`` slots, then
    ``encode(bitshuffle(pad(codes)))``: outlier slots past the overflows hold
    index n and value 0; ``n_over`` is the uncapped overflow count.
    """
    if outlier_capacity < 1:
        raise ValueError(f"outlier_capacity must be >= 1, got {outlier_capacity}")
    if data.device.type == "cpu":
        return ref.fused_compress_strict_ref(data, eb, capacity=capacity,
                                             outlier_capacity=outlier_capacity,
                                             code_mode=code_mode)
    _check_data(data, eb, "fused_compress_strict")
    n = data.numel()
    dims = list(data.shape) + [1] * (3 - data.ndim)
    n_tiles = -(-n // TILE)
    bitflags, payload, nnz, scratch = _outputs(n_tiles, capacity, data.device,
                                                zero_payload=True, lookbacks=2)
    outlier_idx = torch.full((outlier_capacity,), n, dtype=torch.int32, device=data.device)
    outlier_val = torch.zeros(outlier_capacity, dtype=torch.int32, device=data.device)
    n_over = torch.empty((), dtype=torch.int32, device=data.device)
    lib = build.library(_SOURCE)
    rc = lib.fz_fused_compress_strict(
        data.data_ptr(), int(data.dtype == torch.bfloat16), data.ndim, *dims,
        eb.data_ptr(), _code_mode(code_mode), bitflags.data_ptr(), payload.data_ptr(),
        capacity, nnz.data_ptr(), outlier_idx.data_ptr(), outlier_val.data_ptr(),
        outlier_capacity, n_over.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(data.device).cuda_stream)
    build.check(lib, "fz_fused_compress_strict", rc)
    fused_compress_strict.launches += 1
    return bitflags, payload, nnz, outlier_idx, outlier_val, n_over


fused_compress_strict.launches = 0


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
    bitflags, payload, nnz, scratch = _outputs(n_tiles, capacity, codes_flat.device,
                                                zero_payload=False)
    lib = build.library(_SOURCE)
    rc = lib.fz_fused_shuffle_encode(
        codes_flat.data_ptr(), n_tiles, bitflags.data_ptr(), payload.data_ptr(), capacity,
        nnz.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(codes_flat.device).cuda_stream)
    build.check(lib, "fz_fused_shuffle_encode", rc)
    fused_shuffle_encode.launches += 1
    return bitflags, payload, nnz


fused_shuffle_encode.launches = 0


def range_eb(data: torch.Tensor, eb_rel: float) -> torch.Tensor:
    """Floating data of any shape on the card -> the float32 scalar
    ``clamp(max(hi - lo, max(|hi|, |lo|)) * float32(eb_rel), min=1e-30)``,
    ``hi`` and ``lo`` the data's max and min in float32 (NaN if any value is NaN).

    One read of the data: a 4-byte memset and one launch on the current
    stream, no host read. Bit-identical to ``kernels/ops.py:relative_eb``'s
    torch ops. The kernel reads float32 or bfloat16 laid out contiguously;
    other data is copied so first (float16 and float64 as float32: rounding is
    monotone, so the extremes round as the torch ops' do).
    """
    if data.device.type != "cuda" or not data.is_floating_point() or data.numel() == 0:
        raise ValueError(f"range_eb takes floating data of one element or more on the card, "
                         f"got {data.dtype} {tuple(data.shape)} on {data.device}")
    if data.dtype not in _RANGE_DTYPES:
        data = data.to(torch.float32)
    data = data.contiguous()
    eb = torch.empty((), dtype=torch.float32, device=data.device)
    scratch = torch.empty(_RANGE_SCRATCH_WORDS, dtype=torch.int64, device=data.device)
    lib = build.library(_SOURCE)
    rc = lib.fz_range_eb(data.data_ptr(), int(data.dtype == torch.bfloat16), data.numel(),
                         eb_rel, eb.data_ptr(), scratch.data_ptr(),
                         torch.cuda.current_stream(data.device).cuda_stream)
    build.check(lib, "fz_range_eb", rc)
    range_eb.launches += 1
    return eb


range_eb.launches = 0


def shuffle_encode_ctas() -> int:
    """How many CTAs of K5 the current card runs at once: one wave of tiles."""
    ctas = build.library(_SOURCE).fz_fused_shuffle_encode_ctas()
    if ctas < 1:
        raise RuntimeError("fz_fused_shuffle_encode_ctas: CUDA error")
    return ctas
