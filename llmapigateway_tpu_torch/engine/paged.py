"""Host-side page allocator for the paged KV cache (the JAX package's
``engine/paged.py`` reduced to one position band and one page per kernel
block — the multi-page, banded and shared-prefix forms wait for the features
that use them).

Reservation policy: a request is admitted only when every page it can ever
need — ``ceil(min(prompt + max_tokens, S_max) / page_size)`` — is available,
so a running request can never hit pool exhaustion mid-generation; admission
control is the backpressure. Physical page 0 is the trash page for masked
scatter writes (ops/paged_attention.py) and is never allocated.

Single-threaded by design: called only from the engine's event-loop thread
(admission/release).
"""
from __future__ import annotations

import numpy as np


class PageAllocator:

    def __init__(self, num_pages: int, page_size: int, batch: int,
                 max_seq: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the trash page)")
        self.page_size = page_size
        self.num_pages = num_pages
        self.pages_per_slot = (max_seq + page_size - 1) // page_size
        # LIFO free list without the trash page: recently-freed pages are
        # likely still warm.
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        # [B, NP] physical page per (slot, logical page); 0 = unallocated.
        self.table = np.zeros((batch, self.pages_per_slot), np.int32)
        self._held: dict[int, list[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, total_tokens: int) -> int:
        return (min(total_tokens, self.pages_per_slot * self.page_size)
                + self.page_size - 1) // self.page_size

    def can_admit(self, total_tokens: int) -> bool:
        return self.pages_needed(total_tokens) <= len(self._free)

    def allocate(self, slot: int, total_tokens: int) -> bool:
        """Reserve a slot's pages for its lifetime. False if insufficient."""
        if slot in self._held:
            raise ValueError(f"slot {slot} already holds pages")
        if not self.can_admit(total_tokens):
            return False
        need = self.pages_needed(total_tokens)
        pages = [self._free.pop() for _ in range(need)]
        self._held[slot] = pages
        self.table[slot, :] = 0
        self.table[slot, :need] = pages
        return True

    def release(self, slot: int) -> None:
        pages = self._held.pop(slot, None)
        if pages:
            self._free.extend(pages)
        self.table[slot, :] = 0

    def check_invariants(self) -> None:
        """Test hook: every non-trash page is either free or held by exactly
        one slot, and table rows agree with holdings."""
        held = [p for pages in self._held.values() for p in pages]
        assert 0 not in held and 0 not in self._free, "trash page leaked"
        assert len(set(held)) == len(held), "page held twice"
        assert not set(held) & set(self._free), "page both free and held"
        assert len(held) + len(self._free) == self.num_pages - 1, "page lost"
        for slot, pages in self._held.items():
            row = self.table[slot]
            assert list(row[:len(pages)]) == pages, "table/holding mismatch"
            assert (row[len(pages):] == 0).all()
