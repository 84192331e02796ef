"""PyTorch/CUDA port of the FZ-GPU compressor (the JAX package ``repro`` is the reference).

Entry points run on the CUDA card unless ``device="cpu"`` is given:

    from repro_torch import FZConfig, compress, decompress
    c = compress(x, FZConfig(eb=1e-3))          # x: 1-3D float32/bfloat16
    y = decompress(c, FZConfig(eb=1e-3))

Also: ``compress_with_eb``, the batch form (``compress_batch_with_eb`` /
``decompress_batch``), the tree form (``tree_compress`` / ``tree_decompress``)
and the byte container (``to_bytes`` / ``from_bytes`` / ``decompress_bytes``).
``FZConfig(kernel_mode="staged")`` takes the one-kernel-per-stage route.

Kernels (``kernels/``, CUDA C++ in ``csrc/``) are built with nvcc at first use.
"""
from .core.fz import (FZCompressed, FZConfig, FZFormatError, compress,  # noqa: F401
                      compress_batch_with_eb, compress_with_eb, decompress,
                      decompress_batch, decompress_bytes, from_bytes, resolve_eb, roundtrip,
                      to_bytes, tree_compress, tree_decompress)
from .device import ARCH, BUILD_DIR, resolve_device  # noqa: F401
