"""repro_torch.serve.kvpool -- the paged, prefix-shared, FZ-compressed KV pool.

The port of ``repro.serve.kvpool``. KV state lives as fixed-size token pages
in a preallocated slab on the card; cold pages are FZ-compressed in place
(K4, read back through K6), pages of shared prompt prefixes are refcounted
and mapped into every reader, and decode attention reads the page view
through K7. Modules:

  * ``pool``      -- :class:`PagePool`: allocator, page table, CoW, dedup
                     reads, byte accounting;
  * ``radix``     -- the prefix tree (:class:`RadixIndex`), a copy;
  * ``policy``    -- tiering, reclaim, victim selection (:class:`TieredPolicy`);
  * ``scheduler`` -- :class:`ContinuousBatcher`: timed admission, suffix
                     prefill on prefix hits, preempt/resume, TTFT/ITL;
  * ``tracegen``  -- the seeded Poisson/template load generator, a copy;
  * ``attention`` -- page-native decode attention (plain, or K7).
"""
from .attention import paged_decode_attention, pages_from_cache  # noqa: F401
from .policy import TieredPolicy  # noqa: F401
from .pool import (COMPRESSED, FREE, RAW, Page, PagePool, PoolConfig,  # noqa: F401
                   PoolStats)
from .radix import PrefixMatch, RadixIndex  # noqa: F401
from .scheduler import ContinuousBatcher, Request, SeqRecord, TraceStats  # noqa: F401
from .tracegen import TraceGenConfig, generate, latency_summary  # noqa: F401
