"""FZ core in PyTorch: the paper's compression pipeline and its container."""
from .fz import (FZCompressed, FZConfig, compress, compress_with_eb, decompress,  # noqa: F401
                 resolve_eb, roundtrip)
