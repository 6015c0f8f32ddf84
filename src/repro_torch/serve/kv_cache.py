"""Paged KV cache bookkeeping — host-side page tables + free-list.

The device side is a per-layer page POOL ([n_pages, page, KV, hd];
models/model.py::paged_cache_specs shards the page dim over the cache
axes).  This module owns the host side: which pool pages belong to which
decode slot, in order.  Allocation is on-demand (a page is claimed the
first time a slot's position crosses a page boundary) and completed
sequences return their whole chain to the free list, so pool memory
tracks the tokens actually resident — the contiguous decode cache it
replaces reserved ``slots * max_seq`` up front regardless of occupancy.

Running out of pages is an OVERLOAD condition, not a programming error:
``ensure`` raises the typed ``PagePoolExhausted`` and the engine reacts
(preempt a victim, or stall the growing slot for a quantum) instead of
dying on an assert.  ``squeeze`` shrinks the usable pool at runtime (the
``pool_squeeze`` fault kind — a co-tenant claiming HBM), quarantining
free pages now and collecting the remainder as chains release.

Unused table entries keep page id 0: the attention engines mask every
position beyond ``lens`` (kernels/paged_attention.py), so a dangling id
only has to be in range for the gather, never correct.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


class PagePoolExhausted(RuntimeError):
    """The free list cannot cover a requested chain growth — an overload
    signal the engine handles (preemption / stall), never a crash."""

    def __init__(self, slot: int, need: int, free: int):
        super().__init__(
            f"page pool exhausted: slot {slot} needs {need} more "
            f"page(s), {free} free")
        self.slot = slot
        self.need = need
        self.free = free


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    slots: int                 # decode slots (batch rows)
    page_size: int             # tokens per page
    n_pages: int               # pool pages (global, across cache shards)
    max_pages_per_seq: int     # table width (= ceil(max_seq / page_size))

    def pages_needed(self, n_tokens: int) -> int:
        return max(0, math.ceil(n_tokens / self.page_size))


class PageTable:
    """Free-list page allocator + per-slot page chains."""

    def __init__(self, cfg: PagedCacheConfig):
        self.cfg = cfg
        # pop() hands out low page ids first (keeps early traffic on the
        # first cache shards — nice for eyeballing dumps, not load-bearing)
        self._free = list(range(cfg.n_pages - 1, -1, -1))
        self._owned: list[list[int]] = [[] for _ in range(cfg.slots)]
        self.table = np.zeros((cfg.slots, cfg.max_pages_per_seq), np.int32)
        self.high_water = 0
        self._quarantined: list[int] = []   # squeezed-out pages
        self._squeeze_debt = 0              # pages still owed to a squeeze

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def usable_pages(self) -> int:
        """Pool capacity after any squeeze (allocated + free)."""
        return self.cfg.n_pages - len(self._quarantined) \
            - self._squeeze_debt

    @property
    def pages_in_use(self) -> int:
        return self.cfg.n_pages - len(self._free) - len(self._quarantined)

    def pages_held(self, slot: int) -> int:
        return len(self._owned[slot])

    def chain(self, slot: int) -> tuple[int, ...]:
        """Slot's page chain, in position order (the swap path reads the
        pool rows through this)."""
        return tuple(self._owned[slot])

    def can_fit(self, n_tokens: int) -> bool:
        return self.cfg.pages_needed(n_tokens) <= len(self._free)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow slot's chain to cover ``n_tokens`` positions.  Raises
        ``PagePoolExhausted`` (typed, recoverable) when the free list
        cannot cover the growth — the engine's preemption trigger."""
        need = self.cfg.pages_needed(n_tokens)
        assert need <= self.cfg.max_pages_per_seq, (
            f"slot {slot}: {n_tokens} tokens exceed the "
            f"{self.cfg.max_pages_per_seq}-page table")
        chain = self._owned[slot]
        if need - len(chain) > len(self._free):
            raise PagePoolExhausted(slot, need - len(chain),
                                    len(self._free))
        while len(chain) < need:
            pid = self._free.pop()
            self.table[slot, len(chain)] = pid
            chain.append(pid)
        self.high_water = max(self.high_water, self.pages_in_use)

    def release(self, slot: int) -> int:
        """Return slot's whole chain to the free list (less any pages a
        pending squeeze is still owed)."""
        chain = self._owned[slot]
        n = len(chain)
        back = list(reversed(chain))
        if self._squeeze_debt:
            take = min(self._squeeze_debt, len(back))
            self._quarantined.extend(back[:take])
            self._squeeze_debt -= take
            back = back[take:]
        self._free.extend(back)
        self._owned[slot] = []
        self.table[slot, :] = 0
        return n

    def squeeze(self, keep_frac: float) -> int:
        """Shrink the usable pool to ``keep_frac`` of its configured size
        (the ``pool_squeeze`` fault kind).  Free pages are quarantined
        immediately; if the free list is short, the deficit is collected
        from future releases.  Returns the number of pages removed from
        service (immediately or as debt)."""
        keep = max(0, min(1.0, float(keep_frac)))
        target = int(math.floor(self.cfg.n_pages * keep))
        remove = self.usable_pages - target
        if remove <= 0:
            return 0
        take = min(remove, len(self._free))
        # quarantine the pages that would be handed out LAST (the front
        # of the pop()-from-the-end free list) so near-term allocation
        # order is unchanged — determinism for the fault tests
        self._quarantined.extend(self._free[:take])
        del self._free[:take]
        self._squeeze_debt += remove - take
        return remove
