"""repro_torch.serve -- the serving stack over FZ in-memory compression.

  * ``engine.Engine`` -- prefill/decode steps plus two KV regimes: the
    whole-cache path (``park``/``resume``, the parity oracle) and the paged
    pool path (``Engine.serve``);
  * ``kvpool`` -- the paged, prefix-shared, FZ-compressed KV pool, its
    tiering policy and the continuous-batching scheduler.
"""
from . import kvpool  # noqa: F401
from .engine import (Engine, KVCompressionConfig, cache_bytes,  # noqa: F401
                     compress_cache, compressed_cache_bytes, decompress_cache)
from .kvpool import (ContinuousBatcher, PagePool, PoolConfig,  # noqa: F401
                     Request, TieredPolicy, TraceStats)
