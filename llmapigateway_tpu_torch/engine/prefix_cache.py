"""Radix (trie) prefix index over the paged KV pool (counterpart of the JAX
package's ``engine/prefix_cache.py``; plain Python over the allocator, so
the port keeps its own copy).

Cross-request KV reuse: requests that share a system prompt or an earlier
turn of a conversation would otherwise each pay the full prefill. The cache
indexes resident KV at BLOCK granularity — one block = ``kv_page_size ×
kv_pages_per_block`` tokens, exactly one superpage run — so the multi-page
kernels' one table lookup per run applies to shared pages unchanged. A
request whose prompt prefix is resident maps the matched blocks' physical
pages straight into its page-table row (engine/paged.py
``allocate(shared_pages=...)``) and starts prefill at the match boundary:
the matched span's prefill is skipped, not overlapped.

Copy-on-write at the fork point: shared pages are never written.
:meth:`match` stops one token short of the prompt, so the block a request
writes into (the tail's prefill, the decode insert at its length) is always
a private block allocated fresh at admission; the "copy" is a recompute of
at most ``block_tokens - 1`` tail tokens. Partial blocks are never shared.

Eviction takes least-recently-used leaves with no pins: an interior node is
pinned by its children (the prefix property) and a matched node by every
running request that mapped it, so an admitted request never loses a page.
Page lifetime rides on the allocator's group refcounts: insertion
``retain``s, eviction ``drop``s, slot release derefs — a group frees only
when its last holder lets go.

Event-loop confined like the allocator and the engine's scheduler state:
every method runs from the engine's admission, release and stats paths.
"""
from __future__ import annotations

from typing import Any, Iterator, Sequence


class _Node:
    """One resident block: its token run (the edge key from the parent),
    the physical pages backing it, and the pin and LRU state."""

    __slots__ = ("key", "pages", "parent", "children", "refs", "stamp")

    def __init__(self, key: tuple[int, ...], pages: list[int],
                 parent: "_Node | None"):
        self.key = key
        self.pages = pages
        self.parent = parent
        self.children: dict[tuple[int, ...], "_Node"] = {}
        self.refs = 0               # in-flight requests mapping this block
        self.stamp = 0              # LRU clock at last touch


class RadixPrefixCache:
    """Block-granular radix prefix index over a :class:`PageAllocator`.

    The engine owns one per paged engine without a sliding window and
    drives it from the scheduler: :meth:`match` at admission,
    :meth:`insert` + :meth:`release_nodes` at slot release, :meth:`evict`
    under page pressure."""

    def __init__(self, allocator, block_tokens: int):
        if block_tokens <= 0 or block_tokens % allocator.page_size:
            raise ValueError(
                f"block_tokens {block_tokens} must be a positive multiple "
                f"of the page size ({allocator.page_size})")
        self.allocator = allocator
        self.block_tokens = block_tokens
        self.block_pages = block_tokens // allocator.page_size
        self._root = _Node((), [], None)
        self._clock = 0
        # Monotonic counters surfaced through engine.stats().
        self.hits = 0
        self.misses = 0
        self.cached_tokens_total = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self.resident_blocks = 0
        self.resident_pages = 0

    # -- lookup ---------------------------------------------------------------
    def _block_keys(self, ids: Sequence[int],
                    n_tokens: int) -> Iterator[tuple[int, ...]]:
        bt = self.block_tokens
        for b in range(n_tokens // bt):
            yield tuple(ids[b * bt:(b + 1) * bt])

    def match(self, prompt_ids: Sequence[int]
              ) -> tuple[int, list[int], list[_Node]]:
        """Longest resident prefix of ``prompt_ids`` at block granularity,
        capped ONE TOKEN short of the prompt: the engine must prefill at
        least one real token to sample the first output, and the cap is
        what keeps every block a request writes into private.

        Returns ``(matched_tokens, pages, nodes)``. Matched nodes are
        PINNED (``refs += 1``); the caller owes exactly one
        :meth:`release_nodes` per returned node list, whether the request
        admits, waits at the queue head, or is cancelled."""
        self._clock += 1
        node = self._root
        pages: list[int] = []
        nodes: list[_Node] = []
        for key in self._block_keys(prompt_ids, len(prompt_ids) - 1):
            child = node.children.get(key)
            if child is None:
                break
            child.refs += 1
            child.stamp = self._clock
            nodes.append(child)
            pages.extend(child.pages)
            node = child
        return len(nodes) * self.block_tokens, pages, nodes

    def release_nodes(self, nodes: list[_Node]) -> None:
        """Drop the pins taken by :meth:`match` (slot release, or an
        admission abandoned)."""
        for n in nodes:
            n.refs -= 1

    def record_lookup(self, matched_tokens: int) -> None:
        """Count one ADMITTED request's lookup (once per admission, not per
        re-probe of a waiting head, so the totals count requests)."""
        if matched_tokens > 0:
            self.hits += 1
            self.cached_tokens_total += matched_tokens
        else:
            self.misses += 1

    # -- insert-on-release ----------------------------------------------------
    def insert(self, token_ids: Sequence[int], n_tokens: int,
               table_row) -> int:
        """Index the first ``n_tokens // block_tokens`` blocks of a
        releasing slot's sequence (prompt + generated tokens whose KV
        writes have landed — the engine computes ``n_tokens``), adopting
        the slot's pages for blocks not yet resident. Runs BEFORE
        ``allocator.release(slot)`` so :meth:`PageAllocator.retain` sees
        live groups. Blocks already resident (the ones this request matched
        at admission among them) are skipped: the slot's duplicate pages
        free with the slot. Returns the number of blocks newly adopted."""
        bp = self.block_pages
        node = self._root
        added = 0
        for b, key in enumerate(self._block_keys(token_ids, n_tokens)):
            child = node.children.get(key)
            if child is None:
                pages = [int(table_row[b * bp + i]) for i in range(bp)]
                if 0 in pages:
                    break           # the row ends early (short reservation)
                self.allocator.retain(pages)
                self._clock += 1
                child = _Node(key, pages, node)
                child.stamp = self._clock
                node.children[key] = child
                added += 1
                self.resident_blocks += 1
                self.resident_pages += len(pages)
                self.inserted_blocks += 1
            node = child
        return added

    # -- eviction -------------------------------------------------------------
    def evict(self, pages_needed: int) -> int:
        """Free at least ``pages_needed`` pages by dropping LRU leaves with
        no in-flight pins. Called by the engine's admission when the pool
        cannot cover a reservation; only when eviction still falls short
        does the request wait at the queue head. Returns pages freed."""
        freed = 0
        while freed < pages_needed:
            victim: _Node | None = None
            for n in self._walk():
                if n.children or n.refs > 0:
                    continue
                if victim is None or n.stamp < victim.stamp:
                    victim = n
            if victim is None:
                break
            self.allocator.drop(victim.pages)
            victim.parent.children.pop(victim.key, None)
            victim.parent = None
            freed += len(victim.pages)
            self.resident_blocks -= 1
            self.resident_pages -= len(victim.pages)
            self.evicted_blocks += 1
        return freed

    # -- introspection --------------------------------------------------------
    def _walk(self) -> Iterator[_Node]:
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def resident_page_list(self) -> list[int]:
        """Every page the cache pins (one allocator reference per group):
        the ``pinned`` argument of ``PageAllocator.check_invariants``."""
        return [p for n in self._walk() for p in n.pages]

    def pinned_refs(self) -> int:
        """Total in-flight request pins across resident nodes."""
        return sum(n.refs for n in self._walk())

    def stats(self) -> dict[str, Any]:
        """Flat keys merged into engine.stats()."""
        return {
            "prefix_hits_total": self.hits,
            "prefix_misses_total": self.misses,
            "prefix_cached_tokens_total": self.cached_tokens_total,
            "prefix_resident_blocks": self.resident_blocks,
            "prefix_resident_pages": self.resident_pages,
            "prefix_pinned_refs": self.pinned_refs(),
            "prefix_inserted_blocks": self.inserted_blocks,
            "prefix_evicted_blocks": self.evicted_blocks,
            "prefix_block_tokens": self.block_tokens,
        }

    def check_invariants(self) -> None:
        """Test hook: tree and counters agree, pins are non-negative, and
        the allocator's refcounts hold with this cache's pins folded in."""
        pages: list[int] = []
        blocks = 0
        for n in self._walk():
            assert n.refs >= 0, "negative node pin"
            assert len(n.pages) == self.block_pages, "partial block node"
            assert n.parent is not None, "orphaned resident node"
            assert n.parent.children.get(n.key) is n, "tree link broken"
            pages.extend(n.pages)
            blocks += 1
        assert blocks == self.resident_blocks, "resident block drift"
        assert len(pages) == self.resident_pages, "resident page drift"
        self.allocator.check_invariants(pinned=pages)
