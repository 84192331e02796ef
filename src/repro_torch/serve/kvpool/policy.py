"""Tiered compression + preemption policy for the paged KV pool.

The port's copy of ``repro/serve/kvpool/policy.py``: host-only Python, unchanged.

Three decisions live here, kept separate from the allocator (pool.py) and the
scheduler loop (scheduler.py) so they can be swapped/tuned independently:

  * ``tier``    — routine cooling: any raw page not written for
                  ``cold_after`` scheduler steps is FZ-compressed, releasing
                  its physical slot. Tail pages of running sequences are
                  protected (they take the next token write; compressing them
                  would just bounce).
  * ``reclaim`` — memory pressure: free at least ``n`` slots *now* by
                  compressing raw pages coldest-first regardless of age
                  (still honouring the protect set). Returns success.
  * ``victim``  — preemption: when reclaim cannot free enough (everything
                  cold is already compressed), the scheduler parks the
                  lowest-priority running sequence; ties break toward the
                  latest arrival so older work finishes first, then toward
                  the highest seq id so equal-priority equal-arrival traces
                  are deterministic run-to-run.

All tie-breaks here are total orders (priority, arrival/write recency, then
a stable id) — trace-driven benchmarks must reproduce exactly.

Parking a sequence (``park``) is compress-park, not drop-and-recompute: every
raw page it holds is compressed in place and its slots returned to the free
list; nothing about the sequence is lost, resume is a page promotion plus
(possibly) a fresh tail allocation.

The policy is agnostic to the parked representation: with
``PoolConfig.cold_entropy`` the pool stores tiered pages as entropy-coded
byte containers (docs/CONTAINER_FORMAT.md) instead of device-resident
pytrees, but tier/reclaim/park all flow through the same
``PagePool.compress_pages`` entry point and promotion is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from .pool import PagePool


@dataclasses.dataclass(frozen=True)
class TieredPolicy:
    cold_after: int = 4

    def tier(self, pool: PagePool, step: int, protect: set[int]) -> int:
        """Compress pages cold for >= cold_after steps; returns count.

        The whole cold set goes down in one batched FZ dispatch
        (``PagePool.compress_pages``), not one dispatch per page."""
        cold = [page.page_id for page in pool.pages.values()
                if (page.slot is not None and page.page_id not in protect
                    and step - page.last_write >= self.cold_after)]
        pool.compress_pages(cold)
        return len(cold)

    def reclaim(self, pool: PagePool, n: int, protect: set[int]) -> bool:
        """Force-free >= n slots by compressing coldest raw pages first.

        Each compression frees exactly one slot, so the shortfall picks how
        many of the coldest candidates go down — in one batched dispatch."""
        need = n - pool.n_free_slots()
        if need <= 0:
            return True
        candidates = sorted(
            (p for p in pool.pages.values()
             if p.slot is not None and p.page_id not in protect),
            key=lambda p: (p.last_write, p.page_id))
        pool.compress_pages([p.page_id for p in candidates[:need]])
        return pool.n_free_slots() >= n

    @staticmethod
    def victim(running: dict[int, tuple[int, int]]) -> int | None:
        """Pick the sequence to preempt: lowest priority, then latest
        arrival, then highest seq id (a total order — equal-priority
        equal-arrival traces preempt deterministically).

        ``running`` maps seq id -> (priority, arrival_step).
        """
        if not running:
            return None
        return min(running, key=lambda s: (running[s][0], -running[s][1], -s))

    @staticmethod
    def park(pool: PagePool, seq: int) -> int:
        """Compress-park: every raw page of ``seq`` tiers down (one batched
        dispatch); returns count."""
        raw = [page.page_id for page in pool.pages_of(seq)
               if page.slot is not None]
        pool.compress_pages(raw)
        return len(raw)

    @staticmethod
    def tail_pages(pool: PagePool, seqs: Iterable[int | None]) -> set[int]:
        """Protect set: the page each running sequence will write next."""
        out = set()
        for seq in seqs:
            if seq is None or seq not in pool.seq_pages:
                continue
            pos = pool.seq_len[seq]
            idx = pos // pool.cfg.page_size
            pids = pool.seq_pages[seq]
            if idx < len(pids):
                out.add(pids[idx])
            elif pids:               # next write opens a new page; protect the
                out.add(pids[-1])    # current tail anyway (freshest data)
        return out
