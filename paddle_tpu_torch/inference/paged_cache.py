"""Page-pool KV cache bookkeeping (port of
``paddle_tpu/inference/paged_cache.py``, reserved-admission subset).

The KV cache is a SHARED pool of fixed-size pages plus a per-slot page
table (``ops/paged_attention.py`` reads both): HBM holds the tokens in
flight, rounded up to pages, not ``max_batch * max_len``, and any free page
serves any slot. Page ALLOCATION is host-side Python between decode
segments (:class:`PageAllocator`); token WRITES are tensor ops on the
device (:func:`write_tokens`).

Pools carry one extra SINK page as their last row: writes that the
reference drops (``mode="drop"`` on an out-of-range sentinel) are aimed at
it instead, so every write has a fixed shape. No page table ever maps the
sink.

Not ported yet: the prefix cache (content index, refcount sharing, LRU
parking, copy-on-write) and the int8 scale bookkeeping.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["PageAllocator", "write_tokens"]


def write_tokens(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 page_table: torch.Tensor, slots: torch.Tensor,
                 positions: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token per row into the pools, IN PLACE, and return them.

    k_pool/v_pool [num_pages + 1, page_size, H, D] (last page = sink);
    slots [N] page-table rows; positions [N] token index within each
    sequence; k_new/v_new [N, H, D]. A write whose position has NO mapped
    page (table entry -1) is dropped: it lands in the sink page, never on
    another sequence's page."""
    ps = k_pool.shape[1]
    col = (positions.long() // ps).clamp(max=page_table.shape[1] - 1)
    pages = page_table[slots.long(), col].long()
    pages = torch.where(pages >= 0, pages, k_pool.shape[0] - 1)
    offs = positions.long() % ps
    k_pool[pages, offs] = k_new.to(k_pool.dtype)
    v_pool[pages, offs] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


class PageAllocator:
    """Page-table + free-list bookkeeping, pool-agnostic: ONE allocator (one
    table) serves every layer's pools. ``num_pages * page_size`` bounds the
    tokens in flight across all slots; ``max_pages`` bounds one sequence.

    Every page is either FREE (on the ``_free`` heap) or OWNED by exactly
    one slot, and each slot's row of the host ``page_table`` lists its
    owned pages in order with a -1 tail; :meth:`check` validates that.
    ``debug=True`` runs it after every mutation."""

    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 max_pages: int, debug: bool = False):
        self.page_size = page_size
        self.num_pages = num_pages
        self.debug = bool(debug)
        # host-side numpy, mutated in place between segments; the engine
        # ships it to the device once per segment. -1 = unmapped
        self.page_table = np.full((max_batch, max_pages), -1, np.int32)
        self._free: List[int] = list(range(num_pages))   # a heap
        self._owned: Dict[int, List[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def covered_tokens(self, slot: int) -> int:
        """Token positions ``slot``'s mapped pages cover (writes past this
        are dropped by :func:`write_tokens`)."""
        return len(self._owned.get(slot, [])) * self.page_size

    def can_fit(self, slot: int, n_tokens: int) -> bool:
        have = len(self._owned.get(slot, []))
        return self.pages_for(n_tokens) - have <= len(self._free)

    def _claim_page(self) -> int:
        """One free page, lowest id first."""
        if not self._free:
            raise RuntimeError("page pool exhausted")
        return heapq.heappop(self._free)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s mapping to cover ``n_tokens`` positions. Raises
        RuntimeError when the pool cannot supply the pages (nothing is
        claimed then) and ValueError past ``max_pages``."""
        owned = self._owned.setdefault(slot, [])
        target = self.pages_for(n_tokens)
        if target > self.page_table.shape[1]:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens needs {target} pages > "
                f"max_pages={self.page_table.shape[1]} — grow max_pages "
                "(per-sequence length bound)")
        need = target - len(owned)
        if need <= 0:
            return
        if need > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: slot {slot} needs {need} pages, "
                f"{len(self._free)} free — drain finished requests or grow "
                "num_pages")
        for _ in range(need):
            pid = self._claim_page()
            self.page_table[slot, len(owned)] = pid
            owned.append(pid)
        if self.debug:
            self.check()

    def free_slot(self, slot: int) -> None:
        """Return the slot's pages to the pool (request retired)."""
        for pid in self._owned.pop(slot, []):
            heapq.heappush(self._free, pid)
        self.page_table[slot, :] = -1
        if self.debug:
            self.check()

    def check(self) -> None:
        """Invariant validator: free and owned pages partition the pool
        with no page twice, and every table row mirrors its slot's owned
        list (owned prefix in order, -1 tail). Raises RuntimeError on the
        first violation."""
        owner: Dict[int, str] = {}
        for pid in self._free:
            if pid in owner:
                raise RuntimeError(f"page {pid} appears twice in the free "
                                   f"list")
            owner[pid] = "free"
        for slot, pages in self._owned.items():
            for pid in pages:
                if pid in owner:
                    raise RuntimeError(f"page {pid} owned by slot {slot} is "
                                       f"also {owner[pid]}")
                owner[pid] = f"slot {slot}"
        if set(owner) != set(range(self.num_pages)):
            missing = sorted(set(range(self.num_pages)) - set(owner))
            foreign = sorted(set(owner) - set(range(self.num_pages)))
            raise RuntimeError(
                f"free and owned pages do not partition the pool: missing "
                f"{missing}, foreign {foreign}")
        for slot in range(self.page_table.shape[0]):
            owned = self._owned.get(slot, [])
            row = self.page_table[slot]
            if (list(row[:len(owned)]) != list(owned)
                    or not (row[len(owned):] == -1).all()):
                raise RuntimeError(
                    f"page_table row {slot} inconsistent with owned pages "
                    f"{owned}: {row.tolist()}")
