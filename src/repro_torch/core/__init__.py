"""FZ core in PyTorch: the paper's compression pipeline and its containers.

The package surface of ``repro.core``: the entry points of ``fz``, the stages'
functions (dual-quantization, the bitshuffle, the zero-block geometry) and the
stage modules under the reference's names."""
from . import baselines, metrics  # noqa: F401
from . import encode as encode_mod  # noqa: F401  (zero-block encoder stage)
from . import quant as quant_mod  # noqa: F401
from . import shuffle as shuffle_mod  # noqa: F401
from .encode import BLOCK_BYTES, BLOCK_WORDS  # noqa: F401
from .fz import (FZCompressed, FZConfig, FZFormatError, compress,  # noqa: F401
                 compress_batch_with_eb, compress_with_eb, decompress, decompress_batch,
                 decompress_bytes, from_bytes, resolve_eb, roundtrip, to_bytes,
                 tree_compress, tree_decompress)
from .quant import dual_dequantize, dual_quantize, lorenzo_delta, lorenzo_inverse  # noqa: F401
from .shuffle import TILE, bitshuffle, bitunshuffle, transpose16  # noqa: F401
