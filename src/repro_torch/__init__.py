"""PyTorch/CUDA port of the FZ-GPU compressor (the JAX package ``repro`` is the reference).

Entry points run on the CUDA card unless ``device="cpu"`` is given:

    from repro_torch import FZConfig, compress, decompress
    c = compress(x, FZConfig(eb=1e-3))          # x: 1-3D float32/bfloat16
    y = decompress(c, FZConfig(eb=1e-3))

Kernels (``kernels/``, CUDA C++ in ``csrc/``) are built with nvcc at first use.
"""
from .core.fz import (FZCompressed, FZConfig, compress, compress_with_eb,  # noqa: F401
                      decompress, resolve_eb, roundtrip)
from .device import ARCH, BUILD_DIR, resolve_device  # noqa: F401
