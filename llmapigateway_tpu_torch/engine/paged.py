"""Host-side page allocator for the paged KV cache (the JAX package's
``engine/paged.py`` reduced to one position band and no shared prefixes —
the banded and shared forms wait for the parallelism and prefix-cache
features that use them).

Reservation policy: a request is admitted only when every page it can ever
need — ``ceil(min(prompt + max_tokens, S_max) / page_size)`` — is available,
so a running request can never hit pool exhaustion mid-generation; admission
control is the backpressure. Physical page 0 is the trash page for masked
scatter writes (ops/paged_attention.py) and is never allocated.

Two forms of the reservation, as in the JAX package:

* **Superpage packing** (``pages_per_block > 1``): pages are handed out in
  aligned runs of ``pages_per_block`` contiguous physical pages, and every
  aligned group of a slot's logical pages maps onto one such run — the
  packed table the multi-page kernels read with one lookup per run. The
  trash superpage (the run holding page 0) is never allocated; a slot's
  reservation rounds up to whole runs.
* **The sliding-window ring** (``ring_pages``): a slot of a sliding-window
  model holds at most ``ring_pages`` pages, and :meth:`ensure_mapped`
  recycles its oldest pages, once they lie wholly below the attention
  window, onto the logical pages it advances into — an O(window) footprint
  for any context length. Ring rotation moves one page at a time, so a ring
  slot never uses superpage packing.

Single-threaded by design: called only from the engine's event-loop thread
(admission, release, ring rotation before each dispatch).
"""
from __future__ import annotations

import numpy as np


class PageAllocator:

    def __init__(self, num_pages: int, page_size: int, batch: int,
                 max_seq: int, pages_per_block: int = 1):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the trash page)")
        self.page_size = page_size
        self.num_pages = num_pages
        self.pages_per_slot = (max_seq + page_size - 1) // page_size
        self.pages_per_block = max(1, pages_per_block)
        ppb = self.pages_per_block
        if ppb > 1:
            if num_pages % ppb:
                raise ValueError(
                    f"num_pages {num_pages} not divisible by "
                    f"pages_per_block {ppb}")
            if self.pages_per_slot % ppb:
                raise ValueError(
                    f"pages_per_slot {self.pages_per_slot} not divisible "
                    f"by pages_per_block {ppb} (table rows must split into "
                    f"whole runs)")
        # LIFO free lists (recently-freed pages are likely still warm):
        # pages without the trash page, or for a packed pool the superpage
        # ids without the trash superpage 0.
        if ppb > 1:
            self._free: list[int] = []
            self._free_sp: list[int] = list(range(num_pages // ppb - 1, 0, -1))
        else:
            self._free = list(range(num_pages - 1, 0, -1))
            self._free_sp = []
        # [B, NP] physical page per (slot, logical page); 0 = unallocated.
        self.table = np.zeros((batch, self.pages_per_slot), np.int32)
        self._held: dict[int, list[int]] = {}
        # Slots running the sliding-window ring (their table rows rotate).
        self._ring_slots: set[int] = set()

    @property
    def free_pages(self) -> int:
        if self.pages_per_block > 1:
            return len(self._free_sp) * self.pages_per_block
        return len(self._free)

    def pages_needed(self, total_tokens: int, ring_pages: int = 0) -> int:
        need = (min(total_tokens, self.pages_per_slot * self.page_size)
                + self.page_size - 1) // self.page_size
        need = min(need, ring_pages) if ring_pages else need
        if self.pages_per_block > 1:
            # Whole superpage runs only — the packing invariant's price.
            b = self.pages_per_block
            need = -(-need // b) * b
        return need

    def can_admit(self, total_tokens: int, ring_pages: int = 0) -> bool:
        need = self.pages_needed(total_tokens, ring_pages)
        if self.pages_per_block > 1:
            return need // self.pages_per_block <= len(self._free_sp)
        return need <= len(self._free)

    def allocate(self, slot: int, total_tokens: int,
                 ring_pages: int = 0) -> bool:
        """Reserve a slot's pages for its lifetime. False if insufficient.

        ``ring_pages`` (sliding-window models): hold at most that many
        pages — the whole-lifetime guarantee still stands because
        :meth:`ensure_mapped` recycles the slot's own dead pages instead of
        allocating, so the holding never grows."""
        if slot in self._held:
            raise ValueError(f"slot {slot} already holds pages")
        if ring_pages and self.pages_per_block > 1:
            # Ring rotation remaps one page at a time, which would break the
            # aligned-run invariant; the engine disables packing on SWA-ring
            # builds, so this is a misuse guard.
            raise ValueError("ring reservation is incompatible with "
                             "superpage packing")
        if not self.can_admit(total_tokens, ring_pages):
            return False
        need = self.pages_needed(total_tokens, ring_pages)
        if self.pages_per_block > 1:
            ppb = self.pages_per_block
            sps = [self._free_sp.pop() for _ in range(need // ppb)]
            # Logical group g → superpage sps[g]: pt[slot, g·ppb + i] =
            # sps[g]·ppb + i, aligned and contiguous per run.
            pages = [sp * ppb + i for sp in sps for i in range(ppb)]
        else:
            pages = [self._free.pop() for _ in range(need)]
        self._held[slot] = pages
        self.table[slot, :] = 0
        self.table[slot, :need] = pages
        if ring_pages and need < self.pages_needed(total_tokens):
            self._ring_slots.add(slot)
        return True

    def ensure_mapped(self, slot: int, last_logical: int,
                      dead_before: int) -> bool:
        """Ring-mode slots: extend the mapping through ``last_logical`` by
        recycling the slot's OLDEST mapped pages, which must lie strictly
        below ``dead_before`` (logical pages wholly below the attention
        window's floor — the windowed kernels never read them again, and a
        recycled page's stale contents are overwritten as positions advance
        through it). Returns True when the table row changed (the caller
        marks the device table dirty). No-op for whole-lifetime slots."""
        if slot not in self._ring_slots:
            return False
        row = self.table[slot]
        last_logical = min(last_logical, self.pages_per_slot - 1)
        nz = np.nonzero(row)[0]
        hi = int(nz[-1])
        oldest_i = 0
        changed = False
        for j in range(hi + 1, last_logical + 1):
            old = int(nz[oldest_i])
            if old >= dead_before:
                raise RuntimeError(
                    f"SWA page ring exhausted for slot {slot}: need logical "
                    f"page {j} but the oldest mapping ({old}) is still "
                    f"inside the live window (< {dead_before} required) — "
                    f"ring sized too small for window + in-flight margin")
            row[j] = row[old]
            row[old] = 0
            oldest_i += 1
            changed = True
        return changed

    def release(self, slot: int) -> None:
        pages = self._held.pop(slot, None)
        if pages:
            # Back in the JAX allocator's order: each group (superpage, or
            # page) once, in the order the slot held them.
            gp = self.pages_per_block
            for g in dict.fromkeys(p // gp for p in pages):
                (self._free_sp if gp > 1 else self._free).append(g)
        self._ring_slots.discard(slot)
        self.table[slot, :] = 0

    def check_invariants(self) -> None:
        """Test hook: every non-trash page is either free or held by exactly
        one slot; packed holdings are aligned whole runs; table rows agree
        with holdings (a ring row holds the same SET of pages, at rotating
        positions); no page is lost."""
        held = [p for pages in self._held.values() for p in pages]
        ppb = self.pages_per_block
        if ppb > 1:
            free = [sp * ppb + i for sp in self._free_sp for i in range(ppb)]
            trash = set(range(ppb))          # the whole trash superpage
            assert 0 not in self._free_sp, "trash superpage leaked"
            for pages in self._held.values():
                assert len(pages) % ppb == 0, "partial superpage held"
                for g in range(0, len(pages), ppb):
                    run = pages[g:g + ppb]
                    assert run[0] % ppb == 0, "unaligned superpage run"
                    assert run == list(range(run[0], run[0] + ppb)), \
                        "non-contiguous superpage run"
        else:
            free = list(self._free)
            trash = {0}
        assert not trash & set(held + free), "trash page leaked"
        assert len(set(held)) == len(held), "page held twice"
        assert len(set(free)) == len(free), "page freed twice"
        assert not set(held) & set(free), "page both free and held"
        assert len(held) + len(free) == self.num_pages - len(trash), \
            "page lost"
        for slot, pages in self._held.items():
            row = self.table[slot]
            if slot in self._ring_slots:
                assert sorted(int(p) for p in row[row != 0]) == \
                    sorted(pages), "ring table/holding mismatch"
                continue
            assert list(row[:len(pages)]) == pages, "table/holding mismatch"
            assert (row[len(pages):] == 0).all()
