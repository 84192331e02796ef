"""The kernel routes of the compressor: the port of ``repro.kernels.ops``.

Two routes, selected by ``FZConfig.kernel_mode`` (``core/fz.py``):

* **fused** -- ``fused_compress_stages`` is one launch in both modes: K4 in
  paper mode, strict K4 (``fused_compress_strict``) in strict mode
  (``outlier_capacity > 0``), which also writes the exact outlier channel
  from the int32 deltas it holds in registers before they become codes.
  Deliberate difference: the reference keeps an explicit outlier route here
  (``repro/kernels/ops.py:127-153``: ``dual_quantize`` as jnp ops, then K5),
  whose docstring says the fused kernel never materializes the deltas; the
  containers are identical. Decompression is K6 in both modes.
* **staged** -- the paper's unfused pipeline, one launch per stage with the
  codes in device memory between them, mirroring
  ``repro/kernels/ops.py:72-120``: ``lorenzo_quantize`` (K1 in paper mode,
  the same explicit ``dual_quantize`` route in strict mode),
  ``bitshuffle_flag_encode`` (K2, then the phase-2 compaction as torch ops,
  ``core.encode.compact_blocks``, as the reference leaves it to XLA) and
  ``bitunshuffle`` (K3). The staged wrappers take the signatures of the
  plain stages they replace.

Each stage runs under an ``fz.stage.<name>`` span with ``backend=``, as in
the reference (an ``obs.spans.leaf``: a stage opens no span inside it);
``backend`` is ``"cuda"`` where the wrapper launches its kernel and ``"cpu"``
where it runs its plain version for a CPU tensor (the plain stages of
``core/fz.py`` say ``"reference"``). The fused route's compress is
``fz.stage.fused_compress`` in both modes, with ``outliers=`` (the channel's
slots) in strict mode; its decompress is ``fz.stage.fused_decompress``. The
staged route's are ``fz.stage.quantize``, ``fz.stage.shuffle_encode`` and
``fz.stage.unshuffle``; ``core/fz.py`` adds ``fz.stage.resolve_eb``, which
runs ``relative_eb`` for a relative bound. Deliberate difference: in the
reference these spans run only while jax traces the enclosing fz jit
(``cat="jit-trace"``, once a compilation); the port has no jit, so they are
runtime spans, nested under the ``fz.*`` span of every call.

On ``meta`` tensors (the dry-run's count) K4 and K6 are reached through two
``torch.library`` custom ops, ``repro_torch::fused_compress`` and
``repro_torch::fused_decompress``, whose fake implementations give the
outputs' shapes alone -- capacity-sized bitflags, payload and ``nnz``, or the
field -- so the pod hop runs without a kernel and without a host read; the
wrappers themselves refuse every device but the card and the CPU. Every
other call goes to the wrapper directly: a custom op's first call imports
``torch._dynamo`` (seconds), and serving and training are host-bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import encode as enc
from ..core import quant
from ..obs import spans
from . import fused_decode as _fd
from .bitshuffle_flag import bitshuffle_flag, bitunshuffle_tiles
from .fused_compress import (FLAG_WORDS_PER_TILE, TILE, fused_compress, fused_compress_strict,
                             range_eb)
from .lorenzo_quant import lorenzo_quant

__all__ = ["relative_eb", "fused_compress_stages", "fused_decompress", "lorenzo_quantize",
           "bitshuffle_flag_encode", "bitshuffle", "bitunshuffle"]


# the staged route's compaction reads its nonzero's size on the host: one
# fz_host_syncs a call, counted by the stage (K4's and K5's plain versions
# compact the same way for CPU tensors, where the kernels read nothing)
COMPACT_SYNC_SITE = {"site": "compact_blocks"}


def backend_label(t: torch.Tensor) -> str:
    """Span label for where a stage runs: its kernel on the card, or its plain
    version on the CPU."""
    return "cuda" if t.device.type == "cuda" else "cpu"


def _no_outliers(device: torch.device):
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    return empty, empty, torch.zeros((), dtype=torch.int32, device=device)


def relative_eb(data: torch.Tensor, eb_rel: float, *, use_kernels: bool) -> torch.Tensor:
    """The relative bound of ``core/fz.py:resolve_eb``: ``eb_rel * max(hi - lo,
    max|x|)`` in float32, floored at 1e-30, ``hi`` and ``lo`` the data's max
    and min. On the card with the kernels, the range pass (``range_eb``, one
    read and one launch); else the torch ops below, the same bits: the CPU,
    ``meta`` tensors (the dry-run) and the plain route. Max and min are taken
    before the cast to float32, which is monotone."""
    if use_kernels and data.is_cuda:
        return range_eb(data, eb_rel)
    hi = data.amax().to(torch.float32)
    lo = data.amin().to(torch.float32)
    eb = torch.maximum(hi - lo, torch.maximum(hi.abs(), lo.abs())) \
        * torch.full((), eb_rel, dtype=torch.float32, device=data.device)
    return torch.clamp(eb, min=1e-30)


@torch.library.custom_op("repro_torch::fused_compress", mutates_args=())
def _k4(data: torch.Tensor, eb: torch.Tensor, capacity: int,
        code_mode: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return fused_compress(data, eb, capacity=capacity, code_mode=code_mode)


@_k4.register_fake
def _k4_shapes(data, eb, capacity, code_mode):
    n_tiles = -(-data.numel() // TILE)
    return (data.new_empty((n_tiles * FLAG_WORDS_PER_TILE,), dtype=torch.uint32),
            data.new_empty((capacity, 8), dtype=torch.uint16),
            data.new_empty((), dtype=torch.int32))


@torch.library.custom_op("repro_torch::fused_decompress", mutates_args=())
def _k6(bitflags: torch.Tensor, payload: torch.Tensor, eb: torch.Tensor, shape: list[int],
        code_mode: str, outlier_idx: Optional[torch.Tensor],
        outlier_val: Optional[torch.Tensor]) -> torch.Tensor:
    return _fd.fused_decompress(bitflags, payload, eb, shape=tuple(shape), code_mode=code_mode,
                                outlier_idx=outlier_idx, outlier_val=outlier_val)


@_k6.register_fake
def _k6_shape(bitflags, payload, eb, shape, code_mode, outlier_idx, outlier_val):
    return payload.new_empty(tuple(shape), dtype=torch.float32)


def fused_compress_stages(data: torch.Tensor, eb: torch.Tensor, *, code_mode: str,
                          capacity: int, outlier_capacity: int = 0):
    """-> (bitflags, payload, nnz, outlier_idx, outlier_val, n_over)."""
    backend = backend_label(data)
    if outlier_capacity > 0:
        with spans.leaf("fz.stage.fused_compress", backend=backend, outliers=outlier_capacity):
            return fused_compress_strict(data, eb, capacity=capacity,
                                         outlier_capacity=outlier_capacity, code_mode=code_mode)
    with spans.leaf("fz.stage.fused_compress", backend=backend):
        if data.is_meta:
            bitflags, payload, nnz = _k4(data, eb, capacity, code_mode)
        else:
            bitflags, payload, nnz = fused_compress(data, eb, capacity=capacity,
                                                    code_mode=code_mode)
        return (bitflags, payload, nnz, *_no_outliers(data.device))


def fused_decompress(bitflags: torch.Tensor, payload: torch.Tensor, eb: torch.Tensor, *,
                     shape: tuple[int, ...], code_mode: str,
                     outlier_idx: torch.Tensor | None = None,
                     outlier_val: torch.Tensor | None = None) -> torch.Tensor:
    """One-launch decompress (K6) mirroring :func:`fused_compress_stages`."""
    with spans.leaf("fz.stage.fused_decompress", backend=backend_label(payload)):
        if payload.is_meta:
            return _k6(bitflags, payload, eb, [int(n) for n in shape], code_mode,
                       outlier_idx, outlier_val)
        return _fd.fused_decompress(bitflags, payload, eb, shape=shape, code_mode=code_mode,
                                    outlier_idx=outlier_idx, outlier_val=outlier_val)


def lorenzo_quantize(data: torch.Tensor, eb: torch.Tensor, *, code_mode: str = "sign_mag",
                     outlier_capacity: int = 0):
    """Staged quantization -> (codes, outlier_idx, outlier_val, n_over).

    Paper mode is K1 (saturating uint16 codes, no outlier channel); strict
    mode routes to ``dual_quantize`` for the residuals, as the reference does.
    """
    with spans.leaf("fz.stage.quantize", backend=backend_label(data)):
        if outlier_capacity > 0:
            return quant.dual_quantize(data, eb, code_mode=code_mode,
                                       outlier_capacity=outlier_capacity)
        return (lorenzo_quant(data, eb, code_mode=code_mode), *_no_outliers(data.device))


def bitshuffle_flag_encode(codes_flat: torch.Tensor, *, capacity: int):
    """K2 + phase-2 compaction: equals ``encode(bitshuffle(codes_flat), capacity)``."""
    if codes_flat.numel() % TILE:
        raise ValueError(f"size {codes_flat.numel()} not a multiple of TILE={TILE}")
    with spans.leaf("fz.stage.shuffle_encode", backend=backend_label(codes_flat)):
        shuffled, byteflags = bitshuffle_flag(codes_flat.to(torch.uint16).reshape(-1, TILE))
        # int16 view: the same bits, and a type every device's gather takes
        out = enc.compact_blocks(byteflags.reshape(-1).to(torch.bool),
                                 shuffled.view(torch.int16).reshape(-1, enc.BLOCK_WORDS),
                                 capacity=capacity)
    spans.count("fz_host_syncs", COMPACT_SYNC_SITE)
    return out


def bitshuffle(codes_flat: torch.Tensor) -> torch.Tensor:
    """Shuffle only (K2, flags dropped), the signature of ``core.shuffle.bitshuffle``."""
    shuffled, _ = bitshuffle_flag(codes_flat.to(torch.uint16).reshape(-1, TILE))
    return shuffled.reshape(-1)


def bitunshuffle(words_flat: torch.Tensor) -> torch.Tensor:
    """K3 with the signature of ``core.shuffle.bitunshuffle``.

    The decoder's words are int32; they become uint16 here, one pass before K3.
    """
    with spans.leaf("fz.stage.unshuffle", backend=backend_label(words_flat)):
        return bitunshuffle_tiles(words_flat.to(torch.uint16).reshape(-1, TILE)).reshape(-1)
