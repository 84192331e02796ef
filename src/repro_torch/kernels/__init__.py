"""Hand-written CUDA kernels of the port (csrc/), their wrappers and plain versions.

    lorenzo_quant    -- K1 lorenzo_quant wrapper (staged route)
    bitshuffle_flag  -- K2 bitshuffle_flag and K3 bitunshuffle_tiles wrappers (staged)
    fused_compress   -- K4 fused_compress (paper) and fused_compress_strict (the
                        outlier channel too), K5 fused_shuffle_encode wrappers,
                        and range_eb (the relative bound in one read)
    fused_decode     -- K6 fused_decompress wrapper
    flash_decode     -- K7 flash-decode wrapper (decode attention partials) and its
                        entry points (contiguous and paged)
    ops              -- the fused and staged routes of the compressor (outlier routing)
    ref              -- plain PyTorch versions, used for CPU tensors and as oracles
    build            -- nvcc build at first use + ctypes binding

Nothing is compiled when this package is imported.
"""
from __future__ import annotations

import importlib

from .bitshuffle_flag import bitshuffle_flag, bitunshuffle_tiles
from .flash_decode import flash_decode_partials
from .fused_compress import (fused_compress, fused_compress_strict, fused_shuffle_encode,
                             range_eb)
from .fused_decode import fused_decompress
from .lorenzo_quant import lorenzo_quant
from . import flash_decode, fused_decode, ops, ref  # noqa: F401  (the reference's submodules)

WRAPPERS = {
    "lorenzo_quant": lorenzo_quant,
    "bitshuffle_flag": bitshuffle_flag,
    "bitunshuffle_tiles": bitunshuffle_tiles,
    "fused_compress": fused_compress,
    "fused_compress_strict": fused_compress_strict,
    "fused_shuffle_encode": fused_shuffle_encode,
    "range_eb": range_eb,
    "fused_decompress": fused_decompress,
    "flash_decode": flash_decode_partials,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def module(name: str):
    """A wrapper module by name, for its spec builders and plan helpers (the
    package's attribute of the same name is the wrapper function)."""
    return importlib.import_module(f"{__name__}.{name}")
