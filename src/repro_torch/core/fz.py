"""FZ public API in PyTorch: the port of ``repro.core.fz``.

Pipeline (paper Fig. 1): dual-quantization -> bitshuffle -> zero-block
encoding, and its inverse. A container (:class:`FZCompressed`) holds
fixed-shape tensors, field for field the reference's (the hot form); the
byte container of ``docs/CONTAINER_FORMAT.md`` is the cold form
(:func:`to_bytes`, :func:`from_bytes`, :func:`decompress_bytes`).

Three routes, bit-identical in containers and reconstructions:

* ``use_kernels=True`` (the port's default), ``kernel_mode="fused"``: the
  fused kernels (``kernels/ops.py``) -- K4 in paper mode, strict K4 (K4
  with the exact outlier channel) in strict mode, K6 to decompress.
* ``use_kernels=True``, ``kernel_mode="staged"``: one kernel per stage, as
  ``repro/core/fz.py:_stages`` picks them -- K1 (paper mode) or plain
  ``dual_quantize`` (strict mode), K2 + torch-op compaction, and K3 to
  unshuffle; the codes go through device memory between the stages.
* ``use_kernels=False``: the plain stages of ``core.quant``, ``core.shuffle``
  and ``core.encode`` -- the oracle the tests and ``chip_smoke.py`` use.

``kernel_mode="auto"`` (the default) resolves at every public entry point,
before the route is chosen, through the tuner (:mod:`repro_torch.tune`), as the
reference's ``_resolved`` does: the cached winner for the call's device,
``fz.<direction>``, size bucket and dtype, else the static fallback (fused,
then staged, then reference, on the card and on the CPU; ``reference`` means
``use_kernels=False``, which the tuner never names on the card). Internal
callers that bypass the entry points take ``"auto"`` as ``"fused"``, the
fallback's first route.

For CPU tensors the kernel wrappers run their plain versions. This differs
from the reference on purpose: there ``use_kernels`` defaults to False. The
entry points run on the CUDA card unless ``device="cpu"`` is given, and raise
when no card is available.

Telemetry (:mod:`repro_torch.obs`), as the reference wires it: each public
entry point opens an ``fz.<op>`` span at its first line, so the span holds
the whole call (input preparation, ``resolve_device``, the tuner's route
lookup), and sets ``n=``/``rows=`` and ``path=`` (the resolved route:
``reference|staged|fused``) on it once the route is known; it counts one
``fz_dispatches{op,path}`` a call. The batch forms are one dispatch for all
their rows, which is what lets the pool's ``*_dispatches`` and the fz
counters agree. Inside the span, ``compress`` runs ``resolve_eb`` under the
leaf ``fz.stage.resolve_eb``; the routes' stages have theirs
(``kernels/ops.py``). ``FZCompressed.used_bytes`` runs under the leaf
``fz.used_bytes`` and counts its two host reads in
``fz_host_syncs{site=used_bytes}``, as ``core/quant.py`` and the staged
and plain shuffle-encode stages count their ``nonzero`` reads (sites
``dual_quantize`` and ``compact_blocks``). While a CUDA graph is
captured the entry points count nothing (a capture is not a dispatch);
deliberate difference: their span still opens and records a trace-time
event, where the reference opens none at trace time (it saves a capture
query a call). The entry point's span takes its stage spans' trace-time
decision and carries the dispatch accounting, so a call queues one record
(the paths are host-bound on the card). Deliberate difference: the
reference also fills two byte histograms a call, which nothing here read.
``decompress_unmetered`` is ``decompress``
without span or counter, for the error-bound sentinels, whose sampled checks
must not perturb the dispatch accounting they audit. ``to_bytes`` /
``from_bytes`` count ``entropy_stage{op,selected,tier}``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import struct
from typing import Any

import numpy as np
import torch

from .. import obs, pytree
from ..device import resolve_device
from ..kernels import ops
from ..obs import spans
from ..tune import dispatch as _tune
from . import encode as enc
from . import entropy as ent
from . import quant, shuffle

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}
_SYNC_SITE = {"site": "used_bytes"}


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
    kernel_mode: str = "auto"      # "auto" (tuned, repro_torch.tune) | "fused" | "staged"

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
        return math.prod(self.shape)

    def to(self, device: torch.device) -> "FZCompressed":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self.FIELDS})

    def used_bytes(self) -> int:
        with spans.leaf("fz.used_bytes"):
            nnz, n_outliers = int(self.nnz_blocks), int(self.n_outliers)
        spans.count("fz_host_syncs", _SYNC_SITE, 2)
        return enc.used_bytes(FZConfig.n_blocks(self.n), nnz, n_outliers)

    def raw_bytes(self) -> int:
        return self.n * _ITEMSIZE[self.dtype_name]

    def compression_ratio(self) -> float:
        return self.raw_bytes() / self.used_bytes()

    def wire_bytes(self) -> int:
        """Bytes moved if this container crosses a link (capacity-sized)."""
        return (self.bitflags.nbytes + self.payload.nbytes + self.nnz_blocks.nbytes
                + self.outlier_idx.nbytes + self.outlier_val.nbytes + self.n_outliers.nbytes
                + self.eb_abs.nbytes)


def _dtype_name(data: torch.Tensor) -> str:
    """Source dtype the container's byte accounting is charged against.

    float64 is charged as the float32 it becomes, as the reference (JAX with
    x64 off) names it; non-float inputs likewise.
    """
    name = str(data.dtype).removeprefix("torch.")
    return name if name in ("float32", "bfloat16", "float16") else "float32"


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
    reference (``kernels/ops.py:relative_eb``): with ``use_kernels`` on the
    card, the range pass, one read of the data and one launch; the torch ops
    on the CPU, on ``meta`` tensors and on the plain route. Nothing here waits
    on the card.
    """
    if cfg.eb_mode == "abs":
        return torch.full((), cfg.eb, dtype=torch.float32, device=data.device)
    if cfg.eb_mode == "rel":
        return ops.relative_eb(data, cfg.eb, use_kernels=cfg.use_kernels)
    raise ValueError(f"unknown eb_mode {cfg.eb_mode!r}")


def _fused(cfg: FZConfig) -> bool:
    """True for the fused kernel route; ``"auto"`` that no entry point resolved
    (an internal caller) is fused, the static fallback's first route."""
    return cfg.use_kernels and cfg.kernel_mode != "staged"


@functools.lru_cache(maxsize=256)      # a replace costs microseconds on host-bound paths
def _with_impl(cfg: FZConfig, impl: str) -> FZConfig:
    """``cfg`` on one route: ``"reference"`` is the plain route."""
    if impl == "reference":
        return dataclasses.replace(cfg, use_kernels=False, kernel_mode="staged")
    return dataclasses.replace(cfg, kernel_mode=impl)


def _resolved(cfg: FZConfig, direction: str, n: int, dtype_name: str,
              device: torch.device) -> FZConfig:
    """Resolve ``kernel_mode="auto"`` to a concrete route for this call.

    Called by every public entry point before the route is chosen. The tuned
    winner comes from :func:`repro_torch.tune.resolve_fz` (cache hit) or its
    static fallback (cache miss): fused, staged, reference.
    """
    if not (cfg.use_kernels and cfg.kernel_mode == "auto"):
        return cfg
    return _with_impl(cfg, _tune.resolve_fz(direction, n, dtype_name, device))


def _ref_quant(data, eb, *, code_mode, outlier_capacity):
    with spans.leaf("fz.stage.quantize", backend="reference"):
        return quant.dual_quantize(data, eb, code_mode=code_mode,
                                   outlier_capacity=outlier_capacity)


def _ref_shuffle_encode(codes_flat, *, capacity):
    with spans.leaf("fz.stage.shuffle_encode", backend="reference"):
        out = enc.encode(shuffle.bitshuffle(codes_flat), capacity=capacity)
    spans.count("fz_host_syncs", ops.COMPACT_SYNC_SITE)
    return out


def _ref_unshuffle(words_flat):
    with spans.leaf("fz.stage.unshuffle", backend="reference"):
        return shuffle.bitunshuffle(words_flat)


def _stages(cfg: FZConfig):
    """(quantize, shuffle_encode, unshuffle): the staged kernels or the plain stages.

    The fused route does not decompose into these three stages; ``_fused``
    routes it wholesale.
    """
    if cfg.use_kernels:
        return ops.lorenzo_quantize, ops.bitshuffle_flag_encode, ops.bitunshuffle
    return _ref_quant, _ref_shuffle_encode, _ref_unshuffle


def _path(cfg: FZConfig) -> str:
    """Route label for metrics and spans."""
    if _fused(cfg):
        return "fused"
    return "staged" if cfg.use_kernels else "reference"


def _metered(s: obs.span) -> obs.span:
    """The entry point's span collects its stage spans (``fz.stage.*``, leaf
    spans with its trace-time decision: nothing between can start a capture)."""
    s.leaves = []
    return s


def _count_dispatch(s: obs.span, op: str) -> None:
    """One public call = one dispatch, counted on the route of the entry point's
    span ``s`` (its ``path`` attribute) if the span ran (a capture is not a
    dispatch)."""
    if obs.registry._enabled:
        s.then = (obs.registry.add_now, "fz_dispatches", {"op": op, "path": s.attrs["path"]})


def _eb_tensor(eb_abs, device: torch.device) -> torch.Tensor:
    return torch.clamp(torch.as_tensor(eb_abs, dtype=torch.float32).to(device).reshape(()),
                       min=1e-30)


def compress(data, cfg: FZConfig, *, device="cuda") -> FZCompressed:
    """Error-bounded lossy compression of a 1-3D float array."""
    with _metered(obs.span("fz.compress")) as s:
        x, dtype_name = _as_input(data, resolve_device(device, allow_meta=True))
        cfg = _resolved(cfg, "compress", x.numel(), dtype_name, x.device)
        s.attrs = {"n": x.numel(), "path": _path(cfg)}
        with spans.leaf("fz.stage.resolve_eb", backend=ops.backend_label(x)):
            eb = resolve_eb(x, cfg)
        out = _compress_core(x, eb, cfg, dtype_name)
        _count_dispatch(s, "compress")
    return out


def compress_with_eb(data, eb_abs, cfg: FZConfig, *, device="cuda") -> FZCompressed:
    """Compress against a caller-supplied absolute error bound."""
    with _metered(obs.span("fz.compress")) as s:
        x, dtype_name = _as_input(data, resolve_device(device))
        cfg = _resolved(cfg, "compress", x.numel(), dtype_name, x.device)
        s.attrs = {"n": x.numel(), "path": _path(cfg)}
        out = _compress_core(x, _eb_tensor(eb_abs, x.device), cfg, dtype_name)
        _count_dispatch(s, "compress")
    return out


def _compress_unmetered(data: torch.Tensor, cfg: FZConfig) -> FZCompressed:
    """``compress`` on the data's device without span or dispatch counter (the
    tuner's runners, as the reference's use its ``_compress_jit``)."""
    x, dtype_name = _as_input(data, data.device)
    return _compress_core(x, resolve_eb(x, cfg), cfg, dtype_name)


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
        quantize, shuffle_encode, _ = _stages(cfg)
        codes, oidx, oval, n_over = quantize(x, eb, code_mode=cfg.code_mode,
                                             outlier_capacity=ocap)
        bitflags, payload, nnz = shuffle_encode(shuffle.pad_to_tiles(codes.reshape(-1)),
                                                capacity=capacity)
    return FZCompressed(
        bitflags=bitflags, payload=payload, nnz_blocks=nnz, outlier_idx=oidx,
        outlier_val=oval, n_outliers=torch.clamp(n_over, max=oidx.numel()).to(torch.int32),
        eb_abs=eb, shape=tuple(x.shape), dtype_name=dtype_name)


def decompress(c: FZCompressed, cfg: FZConfig, *, device="cuda") -> torch.Tensor:
    """Inverse pipeline: decode -> bit-unshuffle -> inverse Lorenzo -> dequantize."""
    with _metered(obs.span("fz.decompress")) as s:
        c = c.to(resolve_device(device, allow_meta=True))
        cfg = _resolved(cfg, "decompress", c.n, c.dtype_name, c.payload.device)
        s.attrs = {"n": c.n, "path": _path(cfg)}
        out = _decompress(c, cfg)
        _count_dispatch(s, "decompress")
    return out


def decompress_unmetered(c: FZCompressed, cfg: FZConfig, *, device="cuda") -> torch.Tensor:
    """``decompress`` without span or dispatch counter, for the error-bound
    sentinels' sampled checks (the same computation, bit-identical output)."""
    c = c.to(resolve_device(device))
    return _decompress(c, _resolved(cfg, "decompress", c.n, c.dtype_name, c.payload.device))


def _decompress(c: FZCompressed, cfg: FZConfig) -> torch.Tensor:
    oidx = c.outlier_idx if cfg.exact_outliers else None
    oval = c.outlier_val if cfg.exact_outliers else None
    if _fused(cfg):
        return ops.fused_decompress(c.bitflags, c.payload, c.eb_abs, shape=c.shape,
                                    code_mode=cfg.code_mode, outlier_idx=oidx,
                                    outlier_val=oval)
    _, _, unshuffle = _stages(cfg)
    words = enc.decode(c.bitflags, c.payload, n_blocks=FZConfig.n_blocks(c.n))
    codes = unshuffle(words)[: c.n]
    return quant.dual_dequantize(codes, c.eb_abs, c.shape, code_mode=cfg.code_mode,
                                 outlier_idx=oidx, outlier_val=oval)


def roundtrip(data, cfg: FZConfig, *, device="cuda"):
    """compress + decompress; returns (reconstruction, container)."""
    c = compress(data, cfg, device=device)
    return decompress(c, cfg, device=device), c


# ---------------------------------------------------------------------------
# Batch and tree forms
# ---------------------------------------------------------------------------

def compress_batch_with_eb(pages_flat, eb_abs, cfg: FZConfig, *,
                           device="cuda") -> FZCompressed:
    """``compress_with_eb`` over same-shaped rows at one shared bound.

    The container stacks each field along a leading batch dimension and keeps
    the row's shape; each row is bit-identical to a single-row
    ``compress_with_eb`` call, as the reference pins its vmapped form. The
    rows run one after another.
    """
    with _metered(obs.span("fz.compress_batch")) as s:
        x = torch.as_tensor(pages_flat).to(resolve_device(device))
        if x.ndim < 2 or x.shape[0] == 0:
            raise ValueError(f"compress_batch_with_eb takes a non-empty leading batch "
                             f"dimension, got shape {tuple(x.shape)}")
        cfg = _resolved(cfg, "compress", x[0].numel(), _dtype_name(x), x.device)
        s.attrs = {"rows": x.shape[0], "path": _path(cfg)}
        eb = _eb_tensor(eb_abs, x.device)
        rows = []
        for i in range(x.shape[0]):
            row, dtype_name = _as_input(x[i], x.device)
            rows.append(_compress_core(row, eb, cfg, dtype_name))
        out = dataclasses.replace(
            rows[0], **{f: torch.stack([getattr(r, f) for r in rows])
                        for f in FZCompressed.FIELDS})
        _count_dispatch(s, "compress")
    return out


def decompress_batch(comp: FZCompressed, cfg: FZConfig, *, device="cuda") -> torch.Tensor:
    """Inverse of :func:`compress_batch_with_eb` -> float32[batch, *shape]."""
    with _metered(obs.span("fz.decompress_batch")) as s:
        comp = comp.to(resolve_device(device))
        if comp.nnz_blocks.ndim != 1:
            raise ValueError("decompress_batch takes a container stacked along a batch "
                             "dimension")
        cfg = _resolved(cfg, "decompress", comp.n, comp.dtype_name, comp.payload.device)
        s.attrs = {"rows": comp.nnz_blocks.shape[0], "path": _path(cfg)}
        out = torch.stack([
            _decompress(dataclasses.replace(comp, **{f: getattr(comp, f)[i]
                                                     for f in FZCompressed.FIELDS}), cfg)
            for i in range(comp.nnz_blocks.shape[0])])
        _count_dispatch(s, "decompress")
    return out


def tree_compress(tree: Any, cfg: FZConfig, *, device="cuda") -> Any:
    """Compress every float tensor leaf of >= one tile and <= 3 dims; others pass through."""
    dev = resolve_device(device)

    def leaf(x):
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and x.numel() >= shuffle.TILE and x.ndim <= 3):
            return compress(x, cfg, device=dev)
        return x
    return pytree.tree_map(leaf, tree)


def tree_decompress(tree: Any, cfg: FZConfig, dtypes: Any | None = None, *,
                    device="cuda") -> Any:
    """Decompress every container leaf; ``dtypes`` (same structure) casts the leaves."""
    dev = resolve_device(device)
    out = pytree.tree_map(lambda x: decompress(x, cfg, device=dev) if isinstance(x, FZCompressed)
                    else x, tree)
    if dtypes is not None:
        out = pytree.tree_map(lambda x, d: x.to(d), out, dtypes)
    return out


# ---------------------------------------------------------------------------
# Serialized byte containers (cold tier, checkpoints): docs/CONTAINER_FORMAT.md
#
# Host-side numpy. The bytes are the reference's, byte for byte.
# ---------------------------------------------------------------------------

CONTAINER_MAGIC = b"FZGC"
CONTAINER_VERSION = 1

FLAG_ENTROPY = 1 << 0    # payload section is a core.entropy blob
FLAG_ZIGZAG = 1 << 1     # zigzag quantization codes (else sign-magnitude)
FLAG_OUTLIERS = 1 << 2   # exact-outlier channel present in the stream

ENTROPY_MIN_GAIN = 0.02      # probe must predict >= 2% saving to encode
_MIN_ENTROPY_BYTES = 256     # below this the blob overhead can't win

_DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "float64": 3}
_DTYPE_NAMES = {v: k for k, v in _DTYPE_CODES.items()}

_HDR = struct.Struct("<4sHHBBH")   # magic, version, flags, ndim, dtype, rsvd
_TAIL = struct.Struct("<QQfQ")     # nnz, n_outliers, eb_abs, payload_len
_LEGACY_HDR_BYTES = 28             # i64 n/nnz/n_out + f32 eb (pre-v1 streams)


class FZFormatError(ValueError):
    """Raised for malformed, truncated, or unsupported serialized containers."""


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_bytes(c: FZCompressed, cfg: FZConfig, *, entropy: bool | str = "auto",
             chunk_bytes: int = ent.DEFAULT_CHUNK, tier: str | None = None) -> bytes:
    """Serialize a container (on any device) to the exact v1 byte stream.

    ``entropy``: ``"auto"`` probes the payload byte histogram
    (``entropy.plan``) and entropy-codes only when the exact predicted blob
    is at least ``ENTROPY_MIN_GAIN`` smaller; ``True``/``False`` force the
    choice. The header flags record it, so :func:`from_bytes` routes on its
    own. ``tier`` labels the ``entropy_stage`` counters (``adhoc`` when
    None); the ratio EWMAs are left to callers, who know their sampling.
    """
    if entropy not in (True, False, "auto"):
        raise ValueError(f"entropy must be True/False/'auto', got {entropy!r}")
    if c.dtype_name not in _DTYPE_CODES:
        raise FZFormatError(f"unserializable container dtype {c.dtype_name!r}")
    nnz = int(c.nnz_blocks)
    rows = min(nnz, int(c.payload.shape[0]))
    n_out = int(c.n_outliers)
    payload = _host(c.payload[:rows]).astype("<u2").tobytes()

    selected = False
    body = payload
    if entropy is True or (entropy == "auto" and len(payload) >= _MIN_ENTROPY_BYTES):
        counts = np.bincount(np.frombuffer(payload, np.uint8), minlength=256)
        lengths, est = ent.plan(counts, len(payload), chunk_bytes)
        if entropy is True or est <= len(payload) * (1.0 - ENTROPY_MIN_GAIN):
            blob = ent.encode(payload, chunk_bytes, lengths=lengths)
            if entropy is True or len(blob) < len(payload):
                selected, body = True, blob
    obs.counter("entropy_stage", op="encode",
                selected=str(selected).lower(), tier=tier or "adhoc").inc()

    flags = ((FLAG_ENTROPY if selected else 0)
             | (FLAG_ZIGZAG if cfg.code_mode == "zigzag" else 0)
             | (FLAG_OUTLIERS if cfg.exact_outliers else 0))
    parts = [
        _HDR.pack(CONTAINER_MAGIC, CONTAINER_VERSION, flags, len(c.shape),
                  _DTYPE_CODES[c.dtype_name], 0),
        np.asarray(c.shape, "<u8").tobytes(),
        _TAIL.pack(nnz, n_out, float(c.eb_abs), len(body)),
        _host(c.bitflags).astype("<u4").tobytes(),
        body,
    ]
    if flags & FLAG_OUTLIERS:
        parts.append(_host(c.outlier_idx[:n_out]).astype("<i4").tobytes())
        parts.append(_host(c.outlier_val[:n_out]).astype("<i4").tobytes())
    return b"".join(parts)


def _np_slice(raw: memoryview, dtype: str, count: int, offset: int,
              what: str) -> np.ndarray:
    itemsize = np.dtype(dtype).itemsize
    if offset + count * itemsize > len(raw):
        raise FZFormatError(f"container truncated in {what} section ({len(raw)} bytes)")
    return np.frombuffer(raw, dtype, count, offset)


def _unpack(bitflags, rows, n, nnz, oidx, oval, n_out, eb_abs, shape, dtype_name, *,
            capacity, outlier_capacity, default_ocap, device) -> FZCompressed:
    """Parsed sections -> a container padded as ``compress`` pads it, on ``device``.

    Payload rows past the stored ones are zero; outlier index slots past
    ``n_out`` hold ``n`` and value slots 0.
    """
    cap = max(len(rows), 1) if capacity is None else capacity
    if cap < len(rows):
        raise FZFormatError(f"capacity {cap} < {len(rows)} stored payload rows")
    payload = np.zeros((cap, enc.BLOCK_WORDS), np.uint16)
    payload[: len(rows)] = rows
    ocap = default_ocap if outlier_capacity is None else outlier_capacity
    if ocap < len(oidx):
        raise FZFormatError(f"outlier_capacity {ocap} < {len(oidx)} stored")
    oi = np.full((ocap,), n, np.int32)
    oi[: len(oidx)] = oidx
    ov = np.zeros((ocap,), np.int32)
    ov[: len(oval)] = oval

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    return FZCompressed(
        bitflags=tensor(bitflags, np.uint32), payload=tensor(payload, np.uint16),
        nnz_blocks=tensor(nnz, np.int32), outlier_idx=tensor(oi, np.int32),
        outlier_val=tensor(ov, np.int32), n_outliers=tensor(n_out, np.int32),
        eb_abs=tensor(eb_abs, np.float32), shape=tuple(shape), dtype_name=dtype_name)


def from_bytes(raw: bytes, *, capacity: int | None = None,
               outlier_capacity: int | None = None, tier: str | None = None,
               device="cuda") -> tuple[FZCompressed, FZConfig]:
    """Parse a serialized container back into the fixed-shape form on ``device``.

    The result is field for field what ``compress`` produced (at equal
    capacities): payload rows past ``nnz`` are zero, outlier index slots past
    ``n_outliers`` hold ``n`` and value slots 0. ``capacity`` /
    ``outlier_capacity`` override the padded sizes; the defaults are the
    tightest sizes that decode exactly. Streams without the ``FZGC`` magic
    are parsed as the legacy headerless stream; a version other than
    ``CONTAINER_VERSION`` raises :class:`FZFormatError`. ``tier`` labels the
    ``entropy_stage`` counters (see :func:`to_bytes`).

    Returns ``(container, cfg)``; ``cfg`` carries the decode statics
    (``code_mode``, ``exact_outliers``) and ``eb=0.0`` (the bound travels in
    ``container.eb_abs``). Deliberate difference from the reference: ``cfg``
    keeps the port's default kernel route (``use_kernels=True``) where the
    reference returns ``use_kernels=False``, so that ``decompress_bytes``
    runs K6 on the card. The reconstruction is bit-identical either way.
    """
    dev = resolve_device(device)
    raw = memoryview(raw)
    if bytes(raw[:4]) != CONTAINER_MAGIC:
        return _from_legacy_bytes(raw, capacity=capacity,
                                  outlier_capacity=outlier_capacity, tier=tier, device=dev)
    if len(raw) < _HDR.size + _TAIL.size:
        raise FZFormatError(f"container truncated: {len(raw)} bytes")
    _, version, flags, ndim, dtcode, _ = _HDR.unpack_from(raw, 0)
    if version != CONTAINER_VERSION:
        raise FZFormatError(
            f"FZ container version {version} is not supported by this build "
            f"(max {CONTAINER_VERSION}); upgrade repro_torch or re-serialize with "
            f"a matching version")
    if dtcode not in _DTYPE_NAMES:
        raise FZFormatError(f"unknown container dtype code {dtcode}")
    off = _HDR.size
    shape = tuple(int(v) for v in _np_slice(raw, "<u8", ndim, off, "shape"))
    off += 8 * ndim
    if off + _TAIL.size > len(raw):
        raise FZFormatError(f"container truncated in header ({len(raw)} bytes)")
    nnz, n_out, eb_abs, payload_len = _TAIL.unpack_from(raw, off)
    off += _TAIL.size
    n = 1
    for s in shape:
        n *= s
    fw = enc.flag_words(FZConfig.n_blocks(n))
    bitflags = _np_slice(raw, "<u4", fw, off, "bitflags")
    off += 4 * fw
    if off + payload_len > len(raw):
        raise FZFormatError(f"container truncated in payload section ({len(raw)} bytes)")
    body = bytes(raw[off:off + payload_len])
    off += payload_len
    if flags & FLAG_ENTROPY:
        body = ent.decode(body)
    obs.counter("entropy_stage", op="decode", selected=str(bool(flags & FLAG_ENTROPY)).lower(),
                tier=tier or "adhoc").inc()
    if len(body) % enc.BLOCK_BYTES:
        raise FZFormatError(f"payload of {len(body)} bytes is not whole {enc.BLOCK_BYTES}-byte "
                            "blocks")
    n_rows = len(body) // enc.BLOCK_BYTES
    rows = np.frombuffer(body, "<u2", n_rows * enc.BLOCK_WORDS).reshape(n_rows, enc.BLOCK_WORDS)

    if flags & FLAG_OUTLIERS:
        oidx = _np_slice(raw, "<i4", n_out, off, "outlier idx")
        off += 4 * n_out
        oval = _np_slice(raw, "<i4", n_out, off, "outlier val")
        default_ocap = max(n_out, 1)
    else:
        oidx = oval = np.zeros(0, np.int32)
        default_ocap = 0
    c = _unpack(bitflags, rows, n, nnz, oidx, oval, n_out, eb_abs, shape,
                _DTYPE_NAMES[dtcode], capacity=capacity, outlier_capacity=outlier_capacity,
                default_ocap=default_ocap, device=dev)
    cfg = FZConfig(eb=0.0, eb_mode="abs",
                   code_mode="zigzag" if flags & FLAG_ZIGZAG else "sign_mag",
                   exact_outliers=bool(flags & FLAG_OUTLIERS))
    return c, cfg


def _from_legacy_bytes(raw: memoryview, *, capacity: int | None,
                       outlier_capacity: int | None, tier: str | None,
                       device: torch.device) -> tuple[FZCompressed, FZConfig]:
    """Parse the headerless pre-v1 checkpoint stream: i64 [n, nnz, n_outliers],
    f32 eb_abs, u32 bitflags, u16 payload rows, i32 outlier idx + val."""
    if len(raw) < _LEGACY_HDR_BYTES:
        raise FZFormatError(f"not an FZ container: {len(raw)} bytes, no magic")
    n, nnz, n_out = (int(v) for v in np.frombuffer(raw, "<i8", 3, 0))
    eb_abs = float(np.frombuffer(raw, "<f4", 1, 24)[0])
    if n <= 0 or nnz < 0 or n_out < 0:
        raise FZFormatError("not an FZ container: no magic and implausible legacy header")
    fw = enc.flag_words(FZConfig.n_blocks(n))
    expect = _LEGACY_HDR_BYTES + 4 * fw + enc.BLOCK_BYTES * nnz + 8 * n_out
    if len(raw) != expect:
        raise FZFormatError(
            f"not an FZ container: no magic and legacy stream length "
            f"mismatch ({len(raw)} bytes, expected {expect})")
    off = _LEGACY_HDR_BYTES
    bitflags = np.frombuffer(raw, "<u4", fw, off)
    off += 4 * fw
    rows = np.frombuffer(raw, "<u2", enc.BLOCK_WORDS * nnz, off).reshape(nnz, enc.BLOCK_WORDS)
    off += enc.BLOCK_BYTES * nnz
    oidx = np.frombuffer(raw, "<i4", n_out, off)
    off += 4 * n_out
    oval = np.frombuffer(raw, "<i4", n_out, off)
    obs.counter("entropy_stage", op="decode", selected="false", tier=tier or "adhoc").inc()
    c = _unpack(bitflags, rows, n, nnz, oidx, oval, n_out, eb_abs, (n,), "float32",
                capacity=capacity, outlier_capacity=outlier_capacity,
                default_ocap=max(n_out, 1), device=device)
    return c, FZConfig(eb=0.0, eb_mode="abs", exact_outliers=True)


def decompress_bytes(raw: bytes, *, tier: str | None = None, device="cuda") -> torch.Tensor:
    """Reconstruction from a serialized container of any supported version."""
    c, cfg = from_bytes(raw, tier=tier, device=device)
    return decompress(c, cfg, device=device)
