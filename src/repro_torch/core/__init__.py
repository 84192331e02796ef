"""FZ core in PyTorch: the paper's compression pipeline and its containers."""
from .fz import (FZCompressed, FZConfig, FZFormatError, compress,  # noqa: F401
                 compress_batch_with_eb, compress_with_eb, decompress, decompress_batch,
                 decompress_bytes, from_bytes, resolve_eb, roundtrip, to_bytes,
                 tree_compress, tree_decompress)
