"""Page-pool KV cache bookkeeping (port of
``paddle_tpu/inference/paged_cache.py``, reserved-admission subset).

The KV cache is a SHARED pool of fixed-size pages plus a per-slot page
table (``ops/paged_attention.py`` reads both): HBM holds the tokens in
flight, rounded up to pages, not ``max_batch * max_len``, and any free page
serves any slot. Page ALLOCATION is host-side Python between decode
segments (:class:`PageAllocator`); token WRITES are tensor ops on the
device (:func:`write_tokens`, and :func:`write_tokens_q` into int8 pools
with per-(page, kv head) running-absmax scales, ``quantization/kv.py``).

Pools carry one extra SINK page as their last row: writes that the
reference drops (``mode="drop"`` on an out-of-range sentinel) are aimed at
it instead, so every write has a fixed shape. No page table ever maps the
sink. int8 scales are ``[num_pages + 1, Hkv]`` fp32 for the same reason;
the sink's scale row takes the dropped rows' absmax and is never read.

Not ported yet: the prefix cache (content index, refcount sharing, LRU
parking, copy-on-write, and with it the int8 scale copies of a
copy-on-write) and the byte-savings counter of the int8 pools.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..quantization.kv import KV_DTYPES, quant_store_rows

__all__ = ["PageAllocator", "write_tokens", "write_tokens_q"]


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


def write_tokens_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor,
                   page_table: torch.Tensor, slots: torch.Tensor,
                   positions: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, limit=None):
    """Quantizing :func:`write_tokens`: one token per row into int8 pools,
    scales updated by running absmax (``quant_store_rows``), IN PLACE.
    k_scale/v_scale [num_pages + 1, Hkv] fp32. A write whose position has
    no mapped page goes to the sink, absmax and all, so it cannot inflate
    another page's scale. Rows at ``positions >= limit`` (an int or a 0-d
    tensor) go to the sink too: an install's pad tail past the prompt would
    otherwise ratchet the headroom pages' scales up and cost precision.
    Returns ``(k_pool, v_pool, k_scale, v_scale)``."""
    ps = k_pool.shape[1]
    col = (positions.long() // ps).clamp(max=page_table.shape[1] - 1)
    pages = page_table[slots.long(), col].long()
    ok = pages >= 0
    if limit is not None:
        ok = ok & (positions < limit)
    pages = torch.where(ok, pages, k_pool.shape[0] - 1)
    offs = positions.long() % ps
    quant_store_rows(k_pool, k_scale, pages, offs, k_new)
    quant_store_rows(v_pool, v_scale, pages, offs, v_new)
    return k_pool, v_pool, k_scale, v_scale


class PageAllocator:
    """Page-table + free-list bookkeeping, pool-agnostic: ONE allocator (one
    table) serves every layer's pools. ``num_pages * page_size`` bounds the
    tokens in flight across all slots; ``max_pages`` bounds one sequence.

    Every page is either FREE (on the ``_free`` heap) or OWNED by exactly
    one slot, and each slot's row of the host ``page_table`` lists its
    owned pages in order with a -1 tail; :meth:`check` validates that.
    ``debug=True`` runs it after every mutation.

    ``kv_dtype="int8"`` adds the bookkeeping of the pools' scales (the
    scale tensors themselves live on the device beside the pools): a
    claimed page's scale rows are a previous owner's leftovers, so the
    claim queues the page for the engine's reset flush
    (:meth:`take_fresh_scales`); ``_scaled`` holds the pages whose scale
    rows are established (owned, and reset by that flush before any
    write), and :meth:`check` holds that every owned page is in it and no
    free page is."""

    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 max_pages: int, debug: bool = False,
                 kv_dtype: str = "bf16"):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.page_size = page_size
        self.num_pages = num_pages
        self.debug = bool(debug)
        self.kv_dtype = kv_dtype
        self._scaled: set = set()
        self._fresh_scales: List[int] = []
        # host-side numpy, mutated in place between segments; the engine
        # copies it to its device table before every install and segment.
        # -1 = unmapped
        self.page_table = np.full((max_batch, max_pages), -1, np.int32)
        self._free: List[int] = list(range(num_pages))   # a heap
        self._owned: Dict[int, List[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        """Fraction of the pool owned by slots right now (0.0 on an empty
        pool): what ``load()`` and the serving ``pressure`` surface
        report."""
        if not self.num_pages:
            return 0.0
        return self.used_pages / self.num_pages

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
        pid = heapq.heappop(self._free)
        if self.kv_dtype == "int8":
            # its scale rows are a previous owner's: queue the reset
            self._fresh_scales.append(pid)
        return pid

    def take_fresh_scales(self) -> List[int]:
        """Drain the queue of claimed pages whose scale rows the engine
        must reset to the floor before any quantized write lands in them
        (int8; empty otherwise)."""
        out, self._fresh_scales = self._fresh_scales, []
        return out

    def set_kv_dtype(self, kv_dtype: str) -> None:
        """Swap the storage dtype's bookkeeping. The engine owns rebuilding
        the pools (its idle-only ``set_kv_dtype``); fresh pools start at
        floor scales, so nothing is established or pending."""
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self._scaled.clear()
        self._fresh_scales.clear()

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
            if self.kv_dtype == "int8":
                # established by protocol: the claim sits on the fresh
                # queue, and the engine's flush resets its scale rows
                # before any write lands in it
                self._scaled.add(pid)
            self.page_table[slot, len(owned)] = pid
            owned.append(pid)
        if self.debug:
            self.check()

    def free_slot(self, slot: int) -> None:
        """Return the slot's pages to the pool (request retired)."""
        for pid in self._owned.pop(slot, []):
            # a freed page's scale rows belong to a dead owner; a claim
            # freed before the engine's flush ran leaves the queue too
            self._scaled.discard(pid)
            if pid in self._fresh_scales:
                self._fresh_scales.remove(pid)
            heapq.heappush(self._free, pid)
        self.page_table[slot, :] = -1
        if self.debug:
            self.check()

    def check(self) -> None:
        """Invariant validator: free and owned pages partition the pool
        with no page twice, every table row mirrors its slot's owned list
        (owned prefix in order, -1 tail), and under int8 every owned page
        has established scales, no free page does, and the fresh-scale
        queue holds owned pages only. Raises RuntimeError on the first
        violation."""
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
        if self.kv_dtype == "int8":
            for pid, state in owner.items():
                if state == "free" and pid in self._scaled:
                    raise RuntimeError(
                        f"free page {pid} still marked scale-established "
                        f"(freed pages must reset scale bookkeeping)")
                if state != "free" and pid not in self._scaled:
                    raise RuntimeError(
                        f"{state} page {pid} has no established scales")
            for pid in self._fresh_scales:
                if owner.get(pid, "free") == "free":
                    raise RuntimeError(
                        f"fresh-scale queue holds page {pid}, which is "
                        f"{owner.get(pid, 'foreign')}: the reset queue is "
                        f"out of sync with the claims")
