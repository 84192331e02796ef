"""Paged KV-cache pool: refcounted block allocator, radix prefix sharing,
copy-on-write pages and FZ compression tiers. The port of
``repro/serve/kvpool/pool.py``.

A ``PagePool`` owns one preallocated slab of physical page slots on the card

    slots : (num_pages, 2, L, page_size, KVH, hd)     # [k|v] x layers x tokens

a host-side page table, and (when prefix sharing is on) a
:class:`~repro_torch.serve.kvpool.radix.RadixIndex` over prompt token IDs.
Every physical page is ``raw`` (backed by a slot: the hot tier) or
``compressed`` (no slot: an FZ container, or with ``cold_entropy`` its
serialized entropy-coded bytes). Compressing a page frees its slot, which is
the capacity mechanism; reads decompress transiently, writes promote back to
raw. Pages carry a refcount (sequence mappings + the radix tree's reference);
a shared page is immutable and any write to it forks a private copy first
(``_cow_page``). All pages compress against one shared absolute bound
(``compress_with_eb``), so park -> resume is bit-identical to the whole-cache
oracle at that bound. ``gather``/``gather_pages`` decode each distinct cold
page once per call and fan the reconstruction out to every reader lane.

Compression runs through the port's FZ entry points: paper mode
(``exact_outliers=False``) is K4 on the card, reads are K6.

Telemetry, as the reference's: the counters and high-water gauges live in the
:mod:`repro_torch.obs` registry, labeled ``pool=pool<n>`` per instance, and
``PoolStats`` is the view ``stats`` derives from them (``_POOL_METRICS``).
Parking, cold reads and gathers run under the ``kvpool.park`` /
``kvpool.cold_read`` / ``kvpool.gather`` spans. A sampled park (the first,
then every 16th) decompresses the stored form through
``fz.decompress_unmetered`` and holds it to the error bound
(``_sentinel_check``, tier ``kv_cold`` or ``kv_cold_entropy``); its reads of
the error are the one device sync telemetry adds.

Deliberate differences from the reference:

* ``PoolConfig.use_kernels`` defaults to True, as the port's ``FZConfig``
  does: FZ runs on the kernel routes (``kernel_mode="auto"`` resolved by the
  tuner, ``repro_torch.tune``: K4/K6 untuned) and the engine's decode
  attention on K7 unless the tuner measured the plain route faster.
* The slab is updated in place (the reference rebuilds its immutable
  array); ``page_data`` returns a copy, never a view of the slab.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from ... import obs
from ...core import fz
from ...device import resolve_device
from ...obs import sentinels
from .radix import EMPTY_MATCH, PrefixMatch, RadixIndex

FREE = "free"
RAW = "raw"
COMPRESSED = "compressed"

PREFIX_MODES = ("radix", "copy", "off")

# gap-array chunk size for entropy-coded page blobs: page payloads are small,
# and a small chunk keeps per-read host latency bounded (core/entropy.py)
_COLD_CHUNK = 512

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static pool configuration.

    ``num_pages`` bounds the raw (hot) tier only; live state can exceed it
    through the compressed tier. ``seq_capacity`` is the fixed gather width.
    """
    num_pages: int = 16
    page_size: int = 16            # tokens per page
    seq_capacity: int = 256        # max tokens per sequence (gather width)
    cold_after: int = 4            # steps without a write before a page tiers down
    eb: float = 1e-4               # error bound for parked pages
    eb_mode: str = "rel"           # "rel": resolved once from the first KV data; "abs"
    # the kernel route: FZ on K4/K6 and page-native decode attention on K7
    # (the engine's serve loop then decodes through gather_pages). Default
    # True, as the port's FZConfig; False is the plain route, the oracle.
    use_kernels: bool = True
    kernel_mode: str = "auto"      # "auto" (tuned, repro_torch.tune) | "fused" | "staged"
    exact_outliers: bool = False   # paper mode, as serve.KVCompressionConfig
    dtype: str = "bfloat16"
    # "radix" shares refcounted pages (CoW on write), "copy" matches but
    # duplicates pages, "off" disables matching
    prefix_mode: str = "radix"
    # matches shorter than this many tokens are ignored (None -> page_size)
    min_match_tokens: int | None = None
    # radix-cached pages kept past their readers (None = unbounded)
    max_cached_pages: int | None = None
    # parked containers held as entropy-coded bytes (docs/CONTAINER_FORMAT.md)
    cold_entropy: bool = False

    def __post_init__(self):
        if self.seq_capacity % self.page_size:
            raise ValueError("seq_capacity must be a multiple of page_size")
        if self.num_pages < 2:
            raise ValueError("need at least 2 physical pages")
        if self.prefix_mode not in PREFIX_MODES:
            raise ValueError(f"prefix_mode must be one of {PREFIX_MODES}")

    @property
    def max_pages_per_seq(self) -> int:
        return self.seq_capacity // self.page_size

    @property
    def min_match(self) -> int:
        return self.page_size if self.min_match_tokens is None else self.min_match_tokens

    def fz_config(self) -> fz.FZConfig:
        # eb/eb_mode are only a fallback identity; pages compress through
        # compress_with_eb at the pool's shared resolved bound
        return fz.FZConfig(eb=self.eb, eb_mode="abs", exact_outliers=self.exact_outliers,
                           use_kernels=self.use_kernels, kernel_mode=self.kernel_mode)


@dataclasses.dataclass
class Page:
    """Physical page (host-side table entry). ``refs`` counts sequence mappings
    plus the radix tree's reference; the page is released at zero."""
    page_id: int
    slot: int | None = None        # physical slot when raw
    comp: fz.FZCompressed | None = None
    blob: bytes | None = None      # entropy-coded serialized container
    refs: int = 1
    last_write: int = 0            # scheduler step of the last write

    @property
    def state(self) -> str:
        return RAW if self.slot is not None else COMPRESSED


@dataclasses.dataclass
class PoolStats:
    """Point-in-time view of one pool's counters, derived from the
    :mod:`repro_torch.obs` registry (metrics labeled ``pool=<instance>``) on
    every read of ``PagePool.stats``."""
    compressions: int = 0
    compress_dispatches: int = 0   # FZ calls issued for parking (batched)
    decompressions: int = 0        # containers actually decoded
    decompress_dispatches: int = 0  # batched decode calls issued
    cow_promotions: int = 0        # shared-page writes that forked a copy
    prefix_hit_pages: int = 0      # pages mapped from the radix cache
    prefix_hit_tokens: int = 0     # tokens those mappings covered
    shared_cold_reads_deduped: int = 0  # per-step cold decodes avoided by dedup
    high_water_slots: int = 0      # max physical slots simultaneously raw
    high_water_bytes: int = 0      # max raw-slab-in-use + compressed used_bytes
    high_water_demand_bytes: int = 0   # max live physical pages held fully raw
    high_water_logical_bytes: int = 0  # max per-seq mappings held raw + private


# maps PoolStats fields to registry metric names (all labeled pool=<id>);
# (kind, name): counters read .value, gauges read int(.value)
_POOL_METRICS = {
    "compressions": ("counter", "kvpool_compressions"),
    "compress_dispatches": ("counter", "kvpool_compress_dispatches"),
    "decompressions": ("counter", "kvpool_decompressions"),
    "decompress_dispatches": ("counter", "kvpool_decompress_dispatches"),
    "cow_promotions": ("counter", "kvpool_cow_promotions"),
    "prefix_hit_pages": ("counter", "kvpool_prefix_hit_pages"),
    "prefix_hit_tokens": ("counter", "kvpool_prefix_hit_tokens"),
    "shared_cold_reads_deduped": ("counter", "kvpool_shared_cold_reads_deduped"),
    "high_water_slots": ("gauge", "kvpool_high_water_slots"),
    "high_water_bytes": ("gauge", "kvpool_high_water_bytes"),
    "high_water_demand_bytes": ("gauge", "kvpool_high_water_demand_bytes"),
    "high_water_logical_bytes": ("gauge", "kvpool_high_water_logical_bytes"),
}

_pool_ids = itertools.count()


class PagePool:
    """Refcounted block allocator + page table + radix prefix index over one
    preallocated KV slab on ``device``."""

    def __init__(self, cfg: PoolConfig, *, n_layers: int, n_kv_heads: int, head_dim: int,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page_shape = (2, n_layers, cfg.page_size, n_kv_heads, head_dim)
        self.slots = torch.zeros((cfg.num_pages, *self.page_shape), dtype=_DTYPES[cfg.dtype],
                                 device=self.device)
        self._zero_page = torch.zeros(self.page_shape, dtype=self.slots.dtype,
                                      device=self.device)
        self.free_slots: list[int] = list(range(cfg.num_pages))
        self.pages: dict[int, Page] = {}
        self.seq_pages: dict[int, list[int]] = {}
        self.seq_len: dict[int, int] = {}
        self._next_page = 0
        self.eb_abs: torch.Tensor | None = None
        self._fzc = cfg.fz_config()
        # fixed container capacities: blob-backed pages deserialize to exactly these
        n_flat = math.prod(self.page_shape)
        self._page_capacity = self._fzc.payload_capacity(n_flat)
        self._page_ocap = self._fzc.outlier_capacity(n_flat)
        # a per-instance label, so pools in one process never cross-count
        self._obs_id = f"pool{next(_pool_ids)}"
        self.radix: RadixIndex | None = None
        if cfg.prefix_mode != "off":
            self.radix = RadixIndex(self._ref, self._unref, min_match=cfg.min_match,
                                    max_cached_pages=cfg.max_cached_pages)

    # -- telemetry ------------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        obs.counter(name, pool=self._obs_id).inc(n)

    def _water(self, name: str, v: float) -> None:
        obs.gauge(name, pool=self._obs_id).max(v)

    @property
    def stats(self) -> PoolStats:
        """Derived snapshot of this pool's registry metrics (see PoolStats)."""
        out = {}
        for field, (_, name) in _POOL_METRICS.items():
            m = obs.DEFAULT.find(name, pool=self._obs_id)
            out[field] = int(m.value) if m is not None else 0
        return PoolStats(**out)

    # -- geometry / accounting ------------------------------------------------

    @property
    def slot_bytes(self) -> int:
        return math.prod(self.page_shape) * self.slots.element_size()

    def n_free_slots(self) -> int:
        return len(self.free_slots)

    def slot_states(self) -> list[str]:
        """Per physical slot: free|raw (compressed pages hold no slot)."""
        out = [FREE] * self.cfg.num_pages
        for p in self.pages.values():
            if p.slot is not None:
                out[p.slot] = RAW
        return out

    def pages_of(self, seq: int) -> list[Page]:
        return [self.pages[i] for i in self.seq_pages.get(seq, [])]

    def raw_bytes_in_use(self) -> int:
        return (self.cfg.num_pages - len(self.free_slots)) * self.slot_bytes

    def compressed_used_bytes(self) -> int:
        """Each distinct container counted once, however many sequences map it;
        blob-backed pages cost their serialized length."""
        return sum(len(p.blob) if p.blob is not None else int(p.comp.used_bytes())
                   for p in self.pages.values() if p.comp is not None or p.blob is not None)

    def compressed_wire_bytes(self) -> int:
        """Capacity-sized footprint of the containers (a blob is its own wire form)."""
        return sum(len(p.blob) if p.blob is not None else p.comp.wire_bytes()
                   for p in self.pages.values() if p.comp is not None or p.blob is not None)

    def used_bytes(self) -> int:
        """Raw slab in use + compressed payload bytes (shared pages once)."""
        return self.raw_bytes_in_use() + self.compressed_used_bytes()

    def live_demand_bytes(self) -> int:
        """What the live physical pages would occupy held fully raw."""
        return len(self.pages) * self.slot_bytes

    def logical_page_refs(self) -> int:
        """Per-sequence page mappings (a page shared by 3 readers counts 3)."""
        return sum(len(pids) for pids in self.seq_pages.values())

    def logical_demand_bytes(self) -> int:
        """What the live mappings would cost raw and private."""
        return self.logical_page_refs() * self.slot_bytes

    def compression_ratio(self) -> float:
        """Effective capacity multiplier: logical demand / physical bytes."""
        return self.logical_demand_bytes() / max(1, self.used_bytes())

    def note_high_water(self) -> None:
        """Sample peaks at allocation/promotion time."""
        self._water("kvpool_high_water_slots", self.cfg.num_pages - len(self.free_slots))
        self._water("kvpool_high_water_bytes", self.used_bytes())
        self._water("kvpool_high_water_demand_bytes", self.live_demand_bytes())
        self._water("kvpool_high_water_logical_bytes", self.logical_demand_bytes())

    # -- error bound ----------------------------------------------------------

    def _ensure_eb(self, sample: torch.Tensor) -> None:
        if self.eb_abs is None:
            rcfg = fz.FZConfig(eb=self.cfg.eb, eb_mode=self.cfg.eb_mode,
                               use_kernels=self.cfg.use_kernels)
            self.eb_abs = fz.resolve_eb(sample.to(torch.float32).reshape(-1), rcfg)

    # -- allocator / refcounts ------------------------------------------------

    def _ref(self, pid: int) -> None:
        self.pages[pid].refs += 1

    def _unref(self, pid: int) -> None:
        page = self.pages[pid]
        page.refs -= 1
        if page.refs <= 0:
            if page.slot is not None:
                self.free_slots.append(page.slot)
            del self.pages[pid]

    def _new_page(self, slot: int, step: int) -> int:
        pid = self._next_page
        self._next_page += 1
        self.pages[pid] = Page(pid, slot=slot, last_write=step)
        return pid

    def alloc_page(self, seq: int, step: int) -> int | None:
        """Allocate (and zero) a fresh raw page for ``seq``; None if no slot."""
        if not self.free_slots:
            return None
        slot = self.free_slots.pop()
        self.slots[slot].zero_()
        pid = self._new_page(slot, step)
        self.seq_pages.setdefault(seq, []).append(pid)
        self.seq_len.setdefault(seq, 0)
        self.note_high_water()
        return pid

    def free_seq(self, seq: int) -> None:
        """Drop ``seq``'s mappings; pages survive while another reference holds them."""
        for pid in self.seq_pages.pop(seq, []):
            self._unref(pid)
        self.seq_len.pop(seq, None)

    def _cow_page(self, seq: int, idx: int, step: int) -> bool:
        """Copy-on-write: replace ``seq``'s page at ``idx`` with a private raw copy
        (decompressing a cold donor transiently). False if no free slot."""
        old_pid = self.seq_pages[seq][idx]
        old = self.pages[old_pid]
        if not self.free_slots:
            return False
        slot = self.free_slots.pop()
        if old.slot is not None:
            self.slots[slot].copy_(self.slots[old.slot])
        else:
            self.slots[slot].copy_(self._decompress(old))
        self.seq_pages[seq][idx] = self._new_page(slot, step)
        self._unref(old_pid)
        self._count("kvpool_cow_promotions")
        self.note_high_water()
        return True

    # -- prefix sharing -------------------------------------------------------

    def match_prefix(self, tokens) -> PrefixMatch:
        """Longest radix-cached prefix of ``tokens`` (no state change)."""
        if self.radix is None:
            return EMPTY_MATCH
        return self.radix.match(tokens)

    def admit_slot_demand(self, match: PrefixMatch, prompt_len: int) -> int:
        """Physical slots an admission with this match will consume."""
        ps = self.cfg.page_size
        matched = match.matched_tokens
        if matched == 0:
            return max(1, -(-prompt_len // ps))
        need = -(-prompt_len // ps) - len(match.pids)   # fresh suffix pages
        if matched % ps:
            need += 1                                   # CoW of the tail page
        if self.cfg.prefix_mode == "copy":
            need += len(match.pids)
        return need

    def map_prefix(self, seq: int, match: PrefixMatch, step: int) -> bool:
        """Attach a matched prefix to ``seq``: shared mappings in radix mode,
        private duplicates in copy mode; a partially matched tail is CoW'd."""
        if seq in self.seq_pages:
            raise ValueError(f"seq {seq} already has pages")
        matched = match.matched_tokens
        if matched == 0:
            return True
        if self.cfg.prefix_mode == "copy":
            datas = self._page_datas([self.pages[p] for p in match.pids])
            pids = []
            for data in datas:
                if not self.free_slots:
                    for p in pids:      # roll back partial allocation
                        self._unref(p)
                    self.seq_pages.pop(seq, None)
                    return False
                slot = self.free_slots.pop()
                self.slots[slot].copy_(data)
                pids.append(self._new_page(slot, step))
            self.seq_pages[seq] = pids
        else:
            for pid in match.pids:
                self._ref(pid)
            self.seq_pages[seq] = list(match.pids)
        self.seq_len[seq] = matched
        self.radix.touch(match, step)
        self._count("kvpool_prefix_hit_pages", len(match.pids))
        self._count("kvpool_prefix_hit_tokens", matched)
        self.note_high_water()
        if matched % self.cfg.page_size and self.cfg.prefix_mode != "copy":
            if not self._cow_page(seq, len(match.pids) - 1, step):
                self.free_seq(seq)
                return False
        return True

    def insert_prompt(self, seq: int, tokens, step: int) -> int:
        """Cache ``seq``'s prompt pages in the radix tree."""
        if self.radix is None:
            return 0
        tokens = [int(t) for t in tokens]
        ps = self.cfg.page_size
        n = -(-len(tokens) // ps)
        runs = [tuple(tokens[i * ps: min((i + 1) * ps, len(tokens))]) for i in range(n)]
        return self.radix.insert_runs(runs, self.seq_pages[seq][:n], step)

    def release_prefix_cache(self) -> int:
        """Drop every radix-cached page reference (end-of-trace drain)."""
        if self.radix is None:
            return 0
        return self.radix.release_all()

    # -- tiering --------------------------------------------------------------

    def compress_page(self, pid: int) -> None:
        """Raw -> compressed: FZ the page, release the slot. The container keeps
        the slab's dtype for its byte accounting."""
        self.compress_pages([pid])

    def compress_pages(self, pids: list[int]) -> None:
        """Raw -> compressed for a set of pages in one batched FZ call; a page
        is bit-identical to its single-page compression. Duplicate,
        already-compressed and freed pids are skipped."""
        pids = [pid for pid in dict.fromkeys(pids)
                if pid in self.pages and self.pages[pid].slot is not None]
        if not pids:
            return
        with obs.span("kvpool.park", pages=len(pids)):
            flats = torch.stack([self.slots[self.pages[pid].slot].reshape(-1)
                                 for pid in pids])
            self._ensure_eb(flats[0])
            if len(pids) == 1:
                comps = [fz.compress_with_eb(flats[0], self.eb_abs, self._fzc,
                                             device=self.device)]
            else:
                batch = fz.compress_batch_with_eb(flats, self.eb_abs, self._fzc,
                                                  device=self.device)
                comps = [dataclasses.replace(batch, **{f: getattr(batch, f)[i]
                                                       for f in fz.FZCompressed.FIELDS})
                         for i in range(len(pids))]
            for pid, comp in zip(pids, comps):
                page = self.pages[pid]
                self._park_store(page, comp)
                self.free_slots.append(page.slot)
                page.slot = None
                self._count("kvpool_compressions")
            self._count("kvpool_compress_dispatches")
            self._sentinel_check(flats[0], self.pages[pids[0]])

    def _park_store(self, page: Page, comp: fz.FZCompressed) -> None:
        """Hold a parked container in the configured cold form."""
        if self.cfg.cold_entropy:
            page.blob = fz.to_bytes(comp, self._fzc, entropy="auto", chunk_bytes=_COLD_CHUNK,
                                    tier="kv_cold_entropy")
            page.comp = None
        else:
            page.comp = comp

    def _container(self, page: Page) -> fz.FZCompressed:
        """A cold page's container (blobs deserialize at the pool's capacities)."""
        if page.comp is not None:
            return page.comp
        c, _ = fz.from_bytes(page.blob, capacity=self._page_capacity,
                             outlier_capacity=self._page_ocap, tier="kv_cold_entropy",
                             device=self.device)
        return c

    def _sentinel_check(self, flat: torch.Tensor, page: Page) -> None:
        """Sampled park-time health check: decompress the fresh container from
        its stored form (unpacking the blob when the cold tier is entropy-coded)
        through the unmetered path, so the dispatch accounting is untouched;
        hold it to the error bound and feed the achieved ratio to the tier's
        drift EWMA. The device reads below are paid only on sampled parks (the
        first, then every ``obs.sentinels.CONFIG.eb_sample_every``-th)."""
        tier = "kv_cold_entropy" if page.blob is not None else "kv_cold"
        if not sentinels.should_check_eb(tier):
            return
        comp = self._container(page)
        src = flat.to(torch.float32)
        rec = fz.decompress_unmetered(comp, self._fzc, device=self.device)
        max_err = float((src - rec).abs().max())
        max_abs = float(src.abs().max())
        sentinels.check_error_bound(tier, max_err, float(self.eb_abs), max_abs)
        stored = len(page.blob) if page.blob is not None else float(comp.used_bytes())
        sentinels.note_ratio(tier, comp.raw_bytes() / max(1.0, stored))

    def promote_page(self, pid: int, step: int) -> bool:
        """Compressed -> raw in place (before a write to a private page)."""
        page = self.pages[pid]
        if page.slot is not None:
            return True
        if not self.free_slots:
            return False
        data = self._decompress(page)
        slot = self.free_slots.pop()
        self.slots[slot].copy_(data)
        page.slot, page.comp, page.blob, page.last_write = slot, None, None, step
        self.note_high_water()
        return True

    def _decompress(self, page: Page) -> torch.Tensor:
        return self._decompress_many([page])[0]

    def _decompress_many(self, pages: list[Page]) -> list[torch.Tensor]:
        """Transient cold reads in one batched call, each in the slab's dtype."""
        if not pages:
            return []
        self._count("kvpool_decompressions", len(pages))
        self._count("kvpool_decompress_dispatches")
        with obs.span("kvpool.cold_read", pages=len(pages)):
            comps = [self._container(p) for p in pages]
            if len(pages) == 1:
                rec = fz.decompress(comps[0], self._fzc, device=self.device)[None]
            else:
                stacked = dataclasses.replace(
                    comps[0], **{f: torch.stack([getattr(c, f) for c in comps])
                                 for f in fz.FZCompressed.FIELDS})
                rec = fz.decompress_batch(stacked, self._fzc, device=self.device)
            return [rec[i].reshape(self.page_shape).to(self.slots.dtype)
                    for i in range(len(pages))]

    def _page_datas(self, pages: list[Page]) -> list[torch.Tensor]:
        """Contents of a mixed raw/cold page list (cold ones in one batched decode)."""
        cold = [p for p in pages if p.slot is None]
        cold_data = dict(zip((p.page_id for p in cold), self._decompress_many(cold)))
        return [self.slots[p.slot] if p.slot is not None else cold_data[p.page_id]
                for p in pages]

    def page_data(self, pid: int) -> torch.Tensor:
        """Page contents (2, L, ps, KVH, hd), a copy; cold pages decompress."""
        page = self.pages[pid]
        if page.slot is not None:
            return self.slots[page.slot].clone()
        return self._decompress(page)

    # -- writes ---------------------------------------------------------------

    def _paginate(self, k: torch.Tensor, v: torch.Tensor, n_pages: int) -> torch.Tensor:
        """Chop a prefill cache (L, 1, Smax, KVH, hd) into (P, 2, L, ps, KVH, hd)."""
        ps = self.cfg.page_size
        L, _, S, KVH, hd = k.shape
        pad = max(0, n_pages * ps - S)
        kp, vp = (torch.nn.functional.pad(t[:, 0], (0, 0, 0, 0, 0, pad))[:, :n_pages * ps]
                  .reshape(L, n_pages, ps, KVH, hd) for t in (k, v))
        return torch.stack([kp, vp], dim=2).permute(1, 2, 0, 3, 4, 5)

    def write_prefill(self, seq: int, k: torch.Tensor, v: torch.Tensor, length: int,
                      step: int) -> bool:
        """Ingest a prefill cache (L, 1, Smax, KVH, hd) as raw pages."""
        ps = self.cfg.page_size
        n_pages = max(1, -(-length // ps))
        if length > self.cfg.seq_capacity:
            raise ValueError(f"prompt of {length} tokens exceeds seq_capacity "
                             f"{self.cfg.seq_capacity}")
        if n_pages > len(self.free_slots):
            return False
        self._ensure_eb(k)
        pages = self._paginate(k, v, n_pages)
        for j in range(n_pages):
            pid = self.alloc_page(seq, step)
            self.slots[self.pages[pid].slot].copy_(pages[j])
        self.seq_len[seq] = length
        return True

    def write_suffix(self, seq: int, k: torch.Tensor, v: torch.Tensor, suffix_len: int,
                     step: int) -> bool:
        """Ingest a suffix prefill (L, 1, Ssuf_pad, KVH, hd) covering positions
        [seq_len, seq_len + suffix_len): the CoW'd tail first, then fresh pages."""
        ps = self.cfg.page_size
        start = self.seq_len.get(seq, 0)
        end = start + suffix_len
        if end > self.cfg.seq_capacity:
            raise ValueError(f"suffix overruns seq_capacity for seq {seq}")
        need_fresh = -(-end // ps) - len(self.seq_pages.get(seq, []))
        if need_fresh > len(self.free_slots):
            return False
        self._ensure_eb(k)
        kv = torch.stack([k[:, 0], v[:, 0]])        # (2, L, Ssuf_pad, KVH, hd)
        cursor = 0
        while cursor < suffix_len:
            pos = start + cursor
            idx, off = pos // ps, pos % ps
            n = min(ps - off, suffix_len - cursor)
            if idx >= len(self.seq_pages.get(seq, [])):
                pid = self.alloc_page(seq, step)
                if pid is None:
                    raise RuntimeError("reserved slots exhausted mid-suffix")
            else:
                pid = self.seq_pages[seq][idx]
            page = self.pages[pid]
            if page.slot is None or page.refs != 1:
                raise RuntimeError("suffix write target must be a private raw page")
            self.slots[page.slot, :, :, off:off + n] = kv[:, :, cursor:cursor + n]
            page.last_write = step
            cursor += n
        self.seq_len[seq] = end
        return True

    def append_token(self, seq: int, k_vec: torch.Tensor, v_vec: torch.Tensor,
                     step: int) -> bool:
        """Write one decode step's K/V (each (L, KVH, hd)) at the tail. A shared
        tail is CoW'd first, a private compressed tail promoted in place."""
        ps = self.cfg.page_size
        pos = self.seq_len[seq]
        if pos >= self.cfg.seq_capacity:
            raise ValueError(f"sequence {seq} exceeds seq_capacity")
        if pos % ps == 0:
            if self.alloc_page(seq, step) is None:
                return False
        idx = pos // ps
        pid = self.seq_pages[seq][idx]
        page = self.pages[pid]
        if page.refs > 1:
            if not self._cow_page(seq, idx, step):
                return False
            page = self.pages[self.seq_pages[seq][idx]]
        elif page.slot is None and not self.promote_page(pid, step):
            return False
        self.slots[page.slot, 0, :, pos % ps] = k_vec
        self.slots[page.slot, 1, :, pos % ps] = v_vec
        page.last_write = step
        self.seq_len[seq] = pos + 1
        return True

    def tail_slot_demand(self, seq: int) -> int:
        """Physical slots the next ``append_token`` for ``seq`` will consume."""
        pos = self.seq_len[seq]
        if pos % self.cfg.page_size == 0:       # next write opens a new page
            return 1
        page = self.pages[self.seq_pages[seq][pos // self.cfg.page_size]]
        if page.refs > 1:
            return 1                            # copy-on-write fork
        return 0 if page.slot is not None else 1

    def tail_writable(self, seq: int) -> bool:
        """Can the next ``append_token`` for ``seq`` proceed right now?"""
        return self.tail_slot_demand(seq) <= len(self.free_slots)

    # -- reads ----------------------------------------------------------------

    def _lane_pages(self, lane_seqs: list[int | None]):
        """Every lane's pages stacked: (B, P, 2, L, ps, KVH, hd) + (B,) lengths.

        Cold page IDs are deduplicated across all lanes before one batched
        decode, so a shared cold container is decoded once per call. Empty
        lanes are zero-filled at length 0.
        """
        obs.gauge("kvpool_lanes", pool=self._obs_id).set(
            sum(1 for s in lane_seqs if s is not None))
        with obs.span("kvpool.gather", lanes=len(lane_seqs)):
            P = self.cfg.max_pages_per_seq
            lane_pids = [self.seq_pages.get(seq, []) if seq is not None else []
                         for seq in lane_seqs]
            cold_occurrences = [pid for pids in lane_pids for pid in pids
                                if self.pages[pid].slot is None]
            cold = list(dict.fromkeys(cold_occurrences))
            self._count("kvpool_shared_cold_reads_deduped", len(cold_occurrences) - len(cold))
            cold_data = dict(zip(cold, self._decompress_many([self.pages[pid]
                                                              for pid in cold])))
            tensors, lengths = [], []
            for seq, pids in zip(lane_seqs, lane_pids):
                tensors += [self.slots[self.pages[pid].slot]
                            if self.pages[pid].slot is not None else cold_data[pid]
                            for pid in pids]
                tensors += [self._zero_page] * (P - len(pids))
                lengths.append(self.seq_len.get(seq, 0) if seq is not None else 0)
            arr = torch.stack(tensors).reshape(len(lane_seqs), P, *self.page_shape)
            return arr, torch.tensor(lengths, dtype=torch.int32, device=self.device)

    def gather(self, lane_seqs: list[int | None]):
        """The fixed-width contiguous decode cache for a set of lanes:
        ``{"k": (L, B, seq_capacity, KVH, hd), "v": ..., "length": (B,)}``."""
        arr, lengths = self._lane_pages(lane_seqs)
        B, P, _, L, ps, KVH, hd = arr.shape
        kv = arr.permute(2, 3, 0, 1, 4, 5, 6).reshape(2, L, B, P * ps, KVH, hd)
        return {"k": kv[0], "v": kv[1], "length": lengths}

    def gather_pages(self, lane_seqs: list[int | None]):
        """Page-native decode view ``{"k": (L, B, P, ps, KVH, hd), "v": ...,
        "length": (B,)}``: a permuted view of one stacked copy, so B and P are
        strided and each page's (ps, KVH, hd) block is contiguous, as K7 reads it."""
        arr, lengths = self._lane_pages(lane_seqs)
        kv = arr.permute(2, 3, 0, 1, 4, 5, 6)       # (2, L, B, P, ps, KVH, hd)
        return {"k": kv[0], "v": kv[1], "length": lengths}

    def materialize(self, seq: int):
        """One sequence's cache (L, 1, seq_capacity, KVH, hd) k/v + length."""
        cache = self.gather([seq])
        return cache["k"], cache["v"], self.seq_len[seq]
