"""Radix (prefix) index over token-ID pages for the shared KV pool.

The port's copy of ``repro/serve/kvpool/radix.py``: host-only Python, unchanged.

A page-granular prefix tree: level ``i`` of the tree holds pages covering
token positions ``[i*ps, (i+1)*ps)``, and each node's ``key`` is the run of
prompt token IDs resident in its page (``ps`` tokens for interior pages, a
partial run for a prompt's tail page). Prefix sharing is valid because the
shared tokens occupy identical absolute positions in every reader — RoPE'd
K/V at position ``p`` is position-dependent, so only position-aligned
prefixes (system prompts, few-shot templates) can alias physical pages.

The index never owns page *data* — it holds page IDs plus one refcount on
each referenced page (taken via the ``ref``/``unref`` callbacks the pool
passes in), so a cached prefix outlives the sequence that produced it and
the pool's allocator remains the single owner of slots and containers.

Matching (:meth:`RadixIndex.match`) walks the levels picking, per level, the
child with the longest common prefix against the remaining prompt; a full
node match descends, a partial match stops (the reader maps that page with a
valid length < ``ps`` — reads are length-masked, so mapping a page beyond
its matched run is safe). The match is capped at ``len(tokens) - 1`` so
admission always has at least one token to prefill (the last prompt token
must be computed to produce the first output logits), and matches shorter
than ``min_match`` are discarded (accidental one-token collisions are not
worth a copy-on-write).

Siblings may share key prefixes (a partial template-tail node next to a
full page that diverged into user tokens); ties on common-prefix length
prefer the fully-matched node (it allows descent), then the older node —
everything here is deterministic for a deterministic trace.

Insertion (:meth:`insert`) adds one node per prompt page that is not already
cached, referencing the sequence's own (private) pages; pages already
reachable by exact key are never inserted twice, so each physical page has
at most one node. Eviction is LRU over leaf nodes (``evict_lru``), dropping
the tree's reference only — live readers of the page are unaffected.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable


def _lcp(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


@dataclasses.dataclass
class RadixNode:
    key: tuple[int, ...]            # prompt-token run resident in the page
    page_id: int
    parent: "RadixNode | None"
    node_id: int
    last_access: int = 0
    children: list["RadixNode"] = dataclasses.field(default_factory=list)

    def find_exact(self, run: tuple[int, ...]) -> "RadixNode | None":
        for c in self.children:
            if c.key == run:
                return c
        return None


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """One admission's resolved prefix: shared pages in order, per-page valid
    token counts (== page key length except possibly the capped last entry),
    and the nodes to touch for LRU."""
    pids: tuple[int, ...]
    valids: tuple[int, ...]
    nodes: tuple[RadixNode, ...]

    @property
    def matched_tokens(self) -> int:
        return sum(self.valids)


EMPTY_MATCH = PrefixMatch((), (), ())


class RadixIndex:
    """Prefix tree over pages; refcounts pages via pool callbacks."""

    def __init__(self, ref: Callable[[int], None], unref: Callable[[int], None],
                 *, min_match: int = 1, max_cached_pages: int | None = None):
        self.ref = ref
        self.unref = unref
        self.min_match = min_match
        self.max_cached_pages = max_cached_pages
        self.root = RadixNode(key=(), page_id=-1, parent=None, node_id=-1)
        self._ids = itertools.count()
        self.size = 0               # nodes (== cached pages)

    # -- lookup ---------------------------------------------------------------

    def match(self, tokens) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at ``len(tokens) - 1``
        and discarded entirely below ``min_match``. Pure: no refcounts or
        LRU stamps change until the pool applies the match."""
        tokens = tuple(int(t) for t in tokens)
        pids: list[int] = []
        valids: list[int] = []
        nodes: list[RadixNode] = []
        node, rem = self.root, tokens
        while rem:
            best, best_lcp = None, 0
            for c in node.children:
                l = _lcp(rem, c.key)
                if l > best_lcp or (l == best_lcp and l and best is not None
                                    and l == len(c.key) and l < len(best.key)):
                    best, best_lcp = c, l
            if best is None or best_lcp == 0:
                break
            pids.append(best.page_id)
            valids.append(best_lcp)
            nodes.append(best)
            if best_lcp < len(best.key):
                break               # diverged mid-page: partial map, stop
            node, rem = best, rem[best_lcp:]
        # always leave >= 1 token to prefill (logits come from computing it)
        overshoot = sum(valids) - (len(tokens) - 1)
        if overshoot > 0:
            valids[-1] -= overshoot
            if valids[-1] <= 0:
                pids.pop(), valids.pop(), nodes.pop()
        if sum(valids) < self.min_match:
            return EMPTY_MATCH
        return PrefixMatch(tuple(pids), tuple(valids), tuple(nodes))

    # -- insertion / eviction -------------------------------------------------

    def insert_runs(self, runs: list[tuple[int, ...]], pids: list[int],
                    step: int) -> int:
        """``runs[i]`` is the prompt-token run of page ``pids[i]``; create
        nodes for uncached runs, descend through cached ones."""
        node, created = self.root, 0
        for run, pid in zip(runs, pids):
            child = node.find_exact(run)
            if child is None:
                child = RadixNode(key=run, page_id=pid, parent=node,
                                  node_id=next(self._ids), last_access=step)
                node.children.append(child)
                self.ref(pid)
                self.size += 1
                created += 1
            else:
                child.last_access = step
            node = child
        if self.max_cached_pages is not None:
            self.evict_lru(keep=self.max_cached_pages)
        return created

    def touch(self, match: PrefixMatch, step: int) -> None:
        for n in match.nodes:
            n.last_access = step

    def _leaves(self) -> list[RadixNode]:
        out = []

        def walk(n):
            for c in n.children:
                walk(c)
            if n is not self.root and not n.children:
                out.append(n)

        walk(self.root)
        return out

    def _drop(self, node: RadixNode) -> None:
        node.parent.children.remove(node)
        self.unref(node.page_id)
        self.size -= 1

    def evict_lru(self, *, keep: int) -> int:
        """Drop least-recently-accessed leaves until ``size <= keep``;
        removing a leaf may expose its parent for the next round. Live
        readers keep their mappings — only the tree's ref is released."""
        evicted = 0
        while self.size > keep:
            leaves = self._leaves()
            if not leaves:
                break
            self._drop(min(leaves, key=lambda n: (n.last_access, n.node_id)))
            evicted += 1
        return evicted

    def release_all(self) -> int:
        """Drop every cached page (end-of-trace drain)."""
        n = self.evict_lru(keep=0)
        return n
