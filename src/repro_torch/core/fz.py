"""FZ public API in PyTorch: the hot-path port of ``repro.core.fz``.

Pipeline (paper Fig. 1): dual-quantization -> bitshuffle -> zero-block
encoding, and its inverse. A container (:class:`FZCompressed`) holds
fixed-shape tensors, field for field the reference's.

Two routes, bit-identical in containers and reconstructions:

* ``use_kernels=True`` (the port's default): the fused kernels
  (``kernels/ops.py``) -- K4 in paper mode, plain ``dual_quantize`` + K5 in
  strict mode, K6 to decompress. ``kernel_mode="auto"`` resolves to
  ``"fused"``. For CPU tensors the kernel wrappers run their plain versions.
* ``use_kernels=False``: the plain stages of ``core.quant``, ``core.shuffle``
  and ``core.encode`` -- the oracle the tests and ``chip_smoke.py`` use.

This differs from the reference on purpose: there ``use_kernels`` defaults to
False. The entry points run on the CUDA card unless ``device="cpu"`` is given,
and raise when no card is available.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..kernels import ops
from . import encode as enc
from . import quant, shuffle

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


@dataclasses.dataclass(frozen=True)
class FZConfig:
    """Static compressor configuration."""
    eb: float = 1e-3               # error bound (absolute, or relative to range)
    eb_mode: str = "rel"           # "abs" | "rel"
    code_mode: str = "sign_mag"    # "sign_mag" (paper) | "zigzag"
    capacity_frac: float = 1.0     # payload capacity as a fraction of the worst case
    outlier_frac: float = 1 / 256  # exact-outlier channel capacity fraction
    exact_outliers: bool = True    # strict error bound; False = paper-faithful
    use_kernels: bool = True       # route through the CUDA kernels
    kernel_mode: str = "auto"      # "auto" (= "fused") | "fused" | "staged"

    def __post_init__(self):
        if self.kernel_mode not in ("auto", "fused", "staged"):
            raise ValueError(f"unknown kernel_mode {self.kernel_mode!r}")

    def payload_capacity(self, n: int) -> int:
        return max(1, int(self.n_blocks(n) * self.capacity_frac))

    def outlier_capacity(self, n: int) -> int:
        if not self.exact_outliers:
            return 0
        return max(1, int(n * self.outlier_frac))

    @staticmethod
    def padded_n(n: int) -> int:
        return (n + shuffle.TILE - 1) // shuffle.TILE * shuffle.TILE

    @classmethod
    def n_blocks(cls, n: int) -> int:
        return cls.padded_n(n) // enc.BLOCK_WORDS


@dataclasses.dataclass
class FZCompressed:
    """Fixed-shape compressed tensor."""
    bitflags: torch.Tensor       # uint32[ceil(n_blocks / 32)]
    payload: torch.Tensor        # uint16[capacity, 8]
    nnz_blocks: torch.Tensor     # int32[] -- used payload prefix (unclipped)
    outlier_idx: torch.Tensor    # int32[K]
    outlier_val: torch.Tensor    # int32[K]
    n_outliers: torch.Tensor     # int32[]
    eb_abs: torch.Tensor         # float32[] -- resolved absolute error bound
    shape: tuple[int, ...]       # original tensor shape
    dtype_name: str              # original dtype

    FIELDS = ("bitflags", "payload", "nnz_blocks", "outlier_idx", "outlier_val",
              "n_outliers", "eb_abs")

    @property
    def n(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    def to(self, device: torch.device) -> "FZCompressed":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self.FIELDS})

    def used_bytes(self) -> int:
        return enc.used_bytes(FZConfig.n_blocks(self.n), int(self.nnz_blocks),
                              int(self.n_outliers))

    def raw_bytes(self) -> int:
        return self.n * _ITEMSIZE[self.dtype_name]

    def compression_ratio(self) -> float:
        return self.raw_bytes() / self.used_bytes()


def _dtype_name(data: torch.Tensor) -> str:
    """Source dtype the container's byte accounting is charged against."""
    name = str(data.dtype).removeprefix("torch.")
    return name if name in _ITEMSIZE else "float32"


def _as_input(data, device: torch.device) -> tuple[torch.Tensor, str]:
    """-> (float32 or bfloat16 contiguous tensor on ``device``, source dtype name).

    Other dtypes become float32, as the reference casts them.
    """
    src = torch.as_tensor(data)
    x = src.to(device)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    return x.contiguous(), _dtype_name(src)


def resolve_eb(data: torch.Tensor, cfg: FZConfig) -> torch.Tensor:
    """Absolute error bound as a float32 scalar on the data's device.

    ``rel``: ``eb * max(range, max|x|)`` in float32, floored at 1e-30, as the
    reference. Max and min are taken before widening bfloat16, which is
    exact. Nothing here waits on the card.
    """
    if cfg.eb_mode == "abs":
        return torch.full((), cfg.eb, dtype=torch.float32, device=data.device)
    if cfg.eb_mode == "rel":
        hi = data.amax().to(torch.float32)
        lo = data.amin().to(torch.float32)
        eb = torch.maximum(hi - lo, torch.maximum(hi.abs(), lo.abs())) \
            * torch.full((), cfg.eb, dtype=torch.float32, device=data.device)
        return torch.clamp(eb, min=1e-30)
    raise ValueError(f"unknown eb_mode {cfg.eb_mode!r}")


def _fused(cfg: FZConfig) -> bool:
    """True for the kernel route; ``"auto"`` resolves to ``"fused"``."""
    if not cfg.use_kernels:
        return False
    if cfg.kernel_mode == "staged":
        raise NotImplementedError(
            "kernel_mode='staged' needs K1-K3 (lorenzo_quant, bitshuffle_flag, "
            "bitunshuffle_tiles), which are not ported yet: ROADMAP.md, queue 2, "
            "'Staged path'. Use kernel_mode='fused' or 'auto'.")
    return True


def compress(data, cfg: FZConfig, *, device="cuda") -> FZCompressed:
    """Error-bounded lossy compression of a 1-3D float array."""
    x, dtype_name = _as_input(data, resolve_device(device))
    return _compress_core(x, resolve_eb(x, cfg), cfg, dtype_name)


def compress_with_eb(data, eb_abs, cfg: FZConfig, *, device="cuda") -> FZCompressed:
    """Compress against a caller-supplied absolute error bound."""
    x, dtype_name = _as_input(data, resolve_device(device))
    eb = torch.clamp(torch.as_tensor(eb_abs, dtype=torch.float32).to(x.device).reshape(()),
                     min=1e-30)
    return _compress_core(x, eb, cfg, dtype_name)


def _compress_core(x: torch.Tensor, eb: torch.Tensor, cfg: FZConfig,
                   dtype_name: str) -> FZCompressed:
    if not 1 <= x.ndim <= 3:
        raise ValueError(f"FZ compresses 1-3D arrays, got {x.ndim}D")
    n = x.numel()
    capacity, ocap = cfg.payload_capacity(n), cfg.outlier_capacity(n)
    if _fused(cfg):
        bitflags, payload, nnz, oidx, oval, n_over = ops.fused_compress_stages(
            x, eb, code_mode=cfg.code_mode, capacity=capacity, outlier_capacity=ocap)
    else:
        codes, oidx, oval, n_over = quant.dual_quantize(
            x.to(torch.float32), eb, code_mode=cfg.code_mode, outlier_capacity=ocap)
        shuffled = shuffle.bitshuffle(shuffle.pad_to_tiles(codes.reshape(-1)))
        bitflags, payload, nnz = enc.encode(shuffled, capacity=capacity)
    return FZCompressed(
        bitflags=bitflags, payload=payload, nnz_blocks=nnz, outlier_idx=oidx,
        outlier_val=oval, n_outliers=torch.clamp(n_over, max=oidx.numel()).to(torch.int32),
        eb_abs=eb, shape=tuple(x.shape), dtype_name=dtype_name)


def decompress(c: FZCompressed, cfg: FZConfig, *, device="cuda") -> torch.Tensor:
    """Inverse pipeline: decode -> bit-unshuffle -> inverse Lorenzo -> dequantize."""
    c = c.to(resolve_device(device))
    oidx = c.outlier_idx if cfg.exact_outliers else None
    oval = c.outlier_val if cfg.exact_outliers else None
    if _fused(cfg):
        return ops.fused_decompress(c.bitflags, c.payload, c.eb_abs, shape=c.shape,
                                    code_mode=cfg.code_mode, outlier_idx=oidx,
                                    outlier_val=oval)
    words = enc.decode(c.bitflags, c.payload, n_blocks=FZConfig.n_blocks(c.n))
    codes = shuffle.bitunshuffle(words)[: c.n]
    return quant.dual_dequantize(codes, c.eb_abs, c.shape, code_mode=cfg.code_mode,
                                 outlier_idx=oidx, outlier_val=oval)


def roundtrip(data, cfg: FZConfig, *, device="cuda"):
    """compress + decompress; returns (reconstruction, container)."""
    c = compress(data, cfg, device=device)
    return decompress(c, cfg, device=device), c
