"""Page-pool KV cache bookkeeping (port of
``paddle_tpu/inference/paged_cache.py``).

The KV cache is a SHARED pool of fixed-size pages plus a per-slot page
table (``ops/paged_attention.py`` reads both): HBM holds the tokens in
flight, rounded up to pages, not ``max_batch * max_len``, and any free page
serves any slot. Page ALLOCATION is host-side Python between decode
segments (:class:`PageAllocator`); token WRITES, page copies and gathers
are tensor ops on the device, IN PLACE (a captured decode graph holds the
pools' addresses, so they are never rebound): :func:`write_tokens`,
:func:`scatter_rows`, :func:`copy_page`, :func:`gather_pages`, and their
``_q`` twins over int8 pools with per-(page, kv head) running-absmax
scales (``quantization/kv.py``).

With ``prefix_cache=True`` full pages of prompt KV become
CONTENT-ADDRESSABLE and shareable (automatic prefix caching): every page
carries a REFCOUNT, full prompt blocks are indexed by a chain hash (the
block's tokens and the previous block's hash, token-verified on a match,
so a collision can never alias KV), a new request maps resident blocks
read-only instead of prefilling them again, and the first write into a
shared page goes through copy-on-write (:meth:`PageAllocator.cow`, then
:func:`copy_page`). Released cached pages PARK in an LRU, still a cache
hit, and the pool reclaims them on demand.

Pools carry one extra SINK page as their last row: writes that the
reference drops (``mode="drop"`` on an out-of-range sentinel) are aimed at
it instead, so every write has a fixed shape, and a ``-1`` entry of a
gathered page vector reads it. No page table ever maps the sink. int8
scales are ``[num_pages + 1, Hkv]`` fp32 for the same reason; the sink's
scale row takes the dropped rows' absmax and is never read as a real page.

The KV-page handoff between engines (disaggregated prefill and decode)
lands here too: :meth:`PageAllocator.adopt_block` indexes an imported full
block as a parked page, and :func:`install_page` / :func:`install_page_q`
copy its rows (and int8 scales) onto that page, in place.
"""
from __future__ import annotations

import hashlib
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import monitor
from .. import tracing as trace
from ..quantization.kv import KV_DTYPES, dequantize_page, quant_store_rows

__all__ = ["PageAllocator", "write_tokens", "write_tokens_q",
           "scatter_rows", "scatter_rows_q", "copy_page", "copy_page_q",
           "install_page", "install_page_q", "gather_pages",
           "gather_pages_q", "gather_dense", "gather_dense_q"]

# chain-hash root: the "parent" of a prompt's first block
_ROOT = b"\x00" * 16


def _chain_root(salt: bytes) -> bytes:
    """Chain root of a (possibly salted) prefix namespace: the reference's
    LoRA path salts with the adapter id, so one adapter's blocks never
    parent-match another's. Byte-identical to the reference's: prefix keys
    (and shipped KV pages) depend on it."""
    if not salt:
        return _ROOT
    return hashlib.blake2b(salt, digest_size=16).digest()


def _block_hash(parent: bytes, tokens) -> bytes:
    """Chain hash of one page_size-token prompt block: 128-bit blake2b of
    the parent hash and the block's int32 token bytes, so equal blocks at
    different prefixes never alias. Byte-identical to the reference's."""
    return hashlib.blake2b(
        parent + np.ascontiguousarray(tokens, np.int32).tobytes(),
        digest_size=16).digest()


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


def _masked_rows(page_table: torch.Tensor, slot: int, start: int,
                 limit: int, L: int, width: int, ps: int, sink: int):
    """The rows ``[base, base + width)`` of a ``L``-row mini cache that a
    one-slot install writes, with their target pages and offsets: ``base``
    is ``start`` clamped so the window stays inside the mini, and a row
    below ``start``, at or past ``limit``, or on an unmapped position is
    aimed at the sink page."""
    base = min(max(int(start), 0), L - width)
    dev = page_table.device
    pos = base + torch.arange(width, device=dev)
    valid = (pos >= int(start)) & (pos < int(limit))
    col = (pos // ps).clamp(max=page_table.shape[1] - 1)
    pages = page_table[int(slot), col].long()
    pages = torch.where(valid & (pages >= 0), pages, sink)
    return base, pages, pos % ps


def scatter_rows(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 page_table: torch.Tensor, slot: int, start: int, limit: int,
                 mini_k: torch.Tensor, mini_v: torch.Tensor, *, width: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked :func:`write_tokens` for ONE slot, IN PLACE: write ``width``
    consecutive rows of the mini cache [1, L, H, D] from ``start`` into the
    slot's pages, dropping (into the sink) every row outside ``[start,
    limit)``. A warm admission installs exactly its uncached suffix this
    way: positions below the cached coverage sit in shared read-only
    pages, and the bucket's pad tail past the prompt must not land in one
    either. ``start``/``limit`` are host ints (the install runs in the
    gap). Returns the pools."""
    L, ps = mini_k.shape[1], k_pool.shape[1]
    base, pages, offs = _masked_rows(page_table, slot, start, limit, L,
                                     width, ps, k_pool.shape[0] - 1)
    k_pool[pages, offs] = mini_k[0, base:base + width].to(k_pool.dtype)
    v_pool[pages, offs] = mini_v[0, base:base + width].to(v_pool.dtype)
    return k_pool, v_pool


def scatter_rows_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor,
                   page_table: torch.Tensor, slot: int, start: int,
                   limit: int, mini_k: torch.Tensor, mini_v: torch.Tensor,
                   *, width: int):
    """Quantizing :func:`scatter_rows`: masked-out rows go to the sink,
    absmax and all, so shared read-only pages keep both their rows AND
    their scales. Returns ``(k_pool, v_pool, k_scale, v_scale)``."""
    L, ps = mini_k.shape[1], k_pool.shape[1]
    base, pages, offs = _masked_rows(page_table, slot, start, limit, L,
                                     width, ps, k_pool.shape[0] - 1)
    quant_store_rows(k_pool, k_scale, pages, offs,
                     mini_k[0, base:base + width])
    quant_store_rows(v_pool, v_scale, pages, offs,
                     mini_v[0, base:base + width])
    return k_pool, v_pool, k_scale, v_scale


def copy_page(k_pool: torch.Tensor, v_pool: torch.Tensor, src: int,
              dst: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy page ``src``'s rows onto page ``dst``, IN PLACE (the device
    half of copy-on-write). Returns the pools."""
    k_pool[dst].copy_(k_pool[src])
    v_pool[dst].copy_(v_pool[src])
    return k_pool, v_pool


def copy_page_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
                k_scale: torch.Tensor, v_scale: torch.Tensor, src: int,
                dst: int):
    """Quantizing :func:`copy_page`: the copy carries the page's SCALE
    rows with its int8 rows (int8 rows mean nothing under another page's
    scale). Returns ``(k_pool, v_pool, k_scale, v_scale)``."""
    copy_page(k_pool, v_pool, src, dst)
    k_scale[dst].copy_(k_scale[src])
    v_scale[dst].copy_(v_scale[src])
    return k_pool, v_pool, k_scale, v_scale


def install_page(k_pool: torch.Tensor, v_pool: torch.Tensor, dst: int,
                 k_rows, v_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one imported page's host or device rows onto page ``dst`` of
    the pools, IN PLACE (the device half of a KV-page import, the mirror
    of :func:`copy_page`: a pure copy in the pool dtype). Returns the
    pools."""
    k_pool[dst].copy_(torch.as_tensor(k_rows))
    v_pool[dst].copy_(torch.as_tensor(v_rows))
    return k_pool, v_pool


def install_page_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor, dst: int,
                   k_rows, v_rows, k_s, v_s):
    """Quantizing :func:`install_page`: an imported int8 page carries its
    per-(page, kv head) scale rows, which land with its rows (never a
    re-quantization: the handoff is a page copy, not a format conversion).
    Returns ``(k_pool, v_pool, k_scale, v_scale)``."""
    install_page(k_pool, v_pool, dst, k_rows, v_rows)
    k_scale[dst].copy_(torch.as_tensor(k_s))
    v_scale[dst].copy_(torch.as_tensor(v_s))
    return k_pool, v_pool, k_scale, v_scale


def _page_index(pages, pool: torch.Tensor) -> torch.Tensor:
    """A page vector (``-1`` padded) as pool row indices; ``-1`` reads the
    sink (the pool's last row)."""
    idx = torch.as_tensor(pages, dtype=torch.long).to(pool.device)
    return torch.where(idx >= 0, idx, pool.shape[0] - 1)


def gather_pages(k_pool: torch.Tensor, v_pool: torch.Tensor, pages,
                 mini_k: torch.Tensor, mini_v: torch.Tensor):
    """Copy whole pages into the head of a dense mini cache [1, L, H, D],
    IN PLACE: ``mini[:, :len(pages) * page_size] = pool[pages]``. A warm
    admission materializes its cached prefix this way, a pure copy of what
    the original prefill wrote, so its uncached tail can prefill against
    it at an offset. ``pages`` is a full page-table row, ``-1`` padded; a
    ``-1`` reads the sink, whose rows sit past the cached coverage, where
    the tail prefill overwrites them or the causal mask hides them.
    Returns the minis."""
    idx = _page_index(pages, k_pool)
    n = idx.shape[0] * k_pool.shape[1]
    mini_k[0, :n] = k_pool[idx].reshape(n, *k_pool.shape[2:]).to(
        mini_k.dtype)
    mini_v[0, :n] = v_pool[idx].reshape(n, *v_pool.shape[2:]).to(
        mini_v.dtype)
    return mini_k, mini_v


def gather_pages_q(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor, pages,
                   mini_k: torch.Tensor, mini_v: torch.Tensor):
    """Quantizing :func:`gather_pages`: dequantize whole pages into the
    head of the float mini cache, so the tail prefill attends over the
    values the decode kernel's fused dequant reads too. Returns the
    minis."""
    idx = _page_index(pages, k_pool)
    n = idx.shape[0] * k_pool.shape[1]
    for pool, sc, mini in ((k_pool, k_scale, mini_k),
                           (v_pool, v_scale, mini_v)):
        rows = dequantize_page(pool[idx], sc[idx][:, None, :])
        mini[0, :n] = rows.reshape(n, *pool.shape[2:]).to(mini.dtype)
    return mini_k, mini_v


def gather_dense(pool: torch.Tensor, page_table: torch.Tensor,
                 row: int) -> torch.Tensor:
    """Row ``row``'s cache as a dense [max_pages * page_size, H, D] (tests
    and debugging; the attention kernel never materializes it). Unmapped
    entries read the sink."""
    idx = _page_index(page_table[row], pool)
    return pool[idx].reshape(-1, *pool.shape[2:])


def gather_dense_q(pool: torch.Tensor, scales: torch.Tensor,
                   page_table: torch.Tensor, row: int) -> torch.Tensor:
    """Dequantized :func:`gather_dense` (fp32)."""
    idx = _page_index(page_table[row], pool)
    return dequantize_page(pool[idx], scales[idx][:, None, :]).reshape(
        -1, *pool.shape[2:])


class PageAllocator:
    """Page-table + free-list bookkeeping, pool-agnostic: ONE allocator (one
    table) serves every layer's pools. ``num_pages * page_size`` bounds the
    tokens in flight across all slots; ``max_pages`` bounds one sequence.

    Every page carries a REFCOUNT (the number of slot rows that map it).
    Without ``prefix_cache`` every refcount is 0 or 1: a page is FREE (on
    the ``_free`` heap) or owned by one slot. With ``prefix_cache=True`` a
    page is in exactly one of three states: FREE, PARKED (refcount 0 but
    still indexed: an LRU of reclaimable cache hits) or REFERENCED
    (refcount >= 1, in that many slot rows). Each slot's row of the host
    ``page_table`` lists its pages in order with a -1 tail; :meth:`check`
    validates all of it, and ``debug=True`` runs it after every mutation.

    ``kv_dtype="int8"`` adds the bookkeeping of the pools' scales (the
    scale tensors live on the device beside the pools): a claimed page's
    scale rows are a previous owner's leftovers, so the claim queues the
    page for the engine's reset flush (:meth:`take_fresh_scales`);
    ``_scaled`` holds the pages whose scale rows are established (reset by
    that flush, or copied by a copy-on-write: :meth:`note_scale_copied`).

    The mutable state is owned by the thread driving the engine; the
    serving front's readers (``load()``, ``pressure()``) take single
    int/len snapshots only. Counters and gauges carry the reference's
    series names, labelled by this pool's ``monitor_pool``; :meth:`close`
    retires them."""

    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 max_pages: int, debug: bool = False,
                 prefix_cache: bool = False, kv_dtype: str = "bf16"):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.page_size = page_size
        self.num_pages = num_pages
        self.debug = bool(debug)
        self.prefix_cache = bool(prefix_cache)
        self.kv_dtype = kv_dtype
        self._scaled: set = set()
        self._fresh_scales: List[int] = []
        # device bytes the int8 pools avoided for the pages claimed so far
        # (the engine sets bytes_saved_per_page from its real pools)
        self.bytes_saved_per_page = 0
        self.quant_bytes_saved = 0
        self.preemptions = 0
        # host-side numpy, mutated in place between segments; the engine
        # copies it to its device table before every install and segment.
        # -1 = unmapped
        self.page_table = np.full((max_batch, max_pages), -1, np.int32)
        self._free: List[int] = list(range(num_pages))   # a heap
        self._owned: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}         # pid -> refcount (>= 1)
        self._shared = 0                       # pages with refcount > 1
        # prefix index: chain hash <-> resident page
        self._index: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}
        self._tok_of: Dict[int, np.ndarray] = {}
        self._parent_of: Dict[int, bytes] = {}
        self._next: Dict[bytes, set] = {}      # parent hash -> {pid}
        # refcount-0 indexed pages, LRU order (oldest reclaimed first)
        self._parked: "OrderedDict[int, bytes]" = OrderedDict()
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.cow_copies = 0
        self.monitor_pool = monitor.instance_label("pool")
        self._publish_occupancy()

    # -- capacity ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Strictly free pages; parked cache pages are not counted (see
        :attr:`available_pages`)."""
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Refcount-0 pages parked in the prefix LRU."""
        return len(self._parked)

    @property
    def available_pages(self) -> int:
        """Pages a claim can take right now: free plus parked."""
        return len(self._free) + len(self._parked)

    @property
    def shared_pages(self) -> int:
        """Pages mapped by MORE than one slot row right now (kept on the
        1 <-> 2 refcount crossings; :meth:`check` recounts it)."""
        return self._shared

    @property
    def used_pages(self) -> int:
        """Pages referenced by at least one slot (parked pages are
        reclaimable, so they count as capacity, not use)."""
        return self.num_pages - len(self._free) - len(self._parked)

    @property
    def occupancy(self) -> float:
        """Fraction of the pool referenced right now (0.0 on an empty
        pool): what admission watermarks, ``load()`` and the serving
        ``pressure`` surface read."""
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
        return (self.pages_for(n_tokens) - have
                <= len(self._free) + len(self._parked))

    # -- monitor series (the reference's names and labels) -------------------
    @staticmethod
    def _pages_gauge():
        return monitor.gauge("paddle_tpu_kv_pages",
                             "KV-cache page pool occupancy by state "
                             "and storage dtype",
                             ("pool", "state", "kv_dtype"))

    @staticmethod
    def _occupancy_gauge():
        return monitor.gauge("paddle_tpu_kv_page_occupancy_ratio",
                             "fraction of the KV page pool in use",
                             ("pool",))

    @staticmethod
    def _shared_gauge():
        return monitor.gauge(
            "paddle_tpu_kv_shared_pages",
            "pages referenced by more than one slot (prefix-cache "
            "sharing)", ("pool",))

    @staticmethod
    def _preempt_counter():
        return monitor.counter(
            "paddle_tpu_kv_preemptions_total",
            "requests preempted to relieve KV page-pool memory "
            "pressure, by reason (pressure = growth needed the pages; "
            "unsatisfiable = could not fit even alone)",
            ("pool", "reason"))

    @staticmethod
    def _prefix_hits_counter():
        return monitor.counter(
            "paddle_tpu_kv_prefix_hits_total",
            "admissions that mapped at least one cached prompt-prefix "
            "page instead of re-prefilling it", ("pool",))

    @staticmethod
    def _prefix_saved_counter():
        return monitor.counter(
            "paddle_tpu_kv_prefix_tokens_saved_total",
            "prompt tokens whose prefill compute was skipped because "
            "their KV was already resident (prefix-cache hits)",
            ("pool",))

    @staticmethod
    def _quant_saved_counter():
        return monitor.counter(
            "paddle_tpu_kv_quant_bytes_saved_total",
            "HBM bytes avoided by storing claimed KV pages int8 "
            "instead of the model cache dtype (per-page scale "
            "overhead already subtracted)", ("pool",))

    def _publish_occupancy(self) -> None:
        """Push the pool's occupancy into the monitor (host-side mutations
        happen only in ensure/free_slot/map_shared/cow/clear, so pushing
        there keeps the gauges exact at no per-token cost)."""
        if not monitor.enabled():
            return
        pages = self._pages_gauge()
        pages.labels(pool=self.monitor_pool, state="free",
                     kv_dtype=self.kv_dtype).set(len(self._free))
        pages.labels(pool=self.monitor_pool, state="used",
                     kv_dtype=self.kv_dtype).set(self.used_pages)
        if self.prefix_cache:
            pages.labels(pool=self.monitor_pool, state="cached",
                         kv_dtype=self.kv_dtype).set(len(self._parked))
            self._shared_gauge().labels(pool=self.monitor_pool).set(
                self.shared_pages)
        self._occupancy_gauge().labels(pool=self.monitor_pool).set(
            self.occupancy)

    def count_preemption(self, reason: str = "pressure") -> None:
        """Record one preemption against this pool (the engine's
        ``preempt_request`` and the scheduler's admission-abort path both
        land here)."""
        self.preemptions += 1
        if monitor.enabled():
            self._preempt_counter().labels(
                pool=self.monitor_pool, reason=reason).inc()

    def _count_quant_claim(self) -> None:
        """One page claimed under int8 storage: add the device bytes the
        int8 layout avoided for it."""
        if self.kv_dtype != "int8" or not self.bytes_saved_per_page:
            return
        self.quant_bytes_saved += self.bytes_saved_per_page
        if monitor.enabled():
            self._quant_saved_counter().labels(
                pool=self.monitor_pool).inc(self.bytes_saved_per_page)

    def count_prefix_hit(self, tokens_saved: int) -> None:
        """Record one prefix-cache hit and the prompt tokens whose prefill
        it skipped (the engine calls this once per warm admission, after
        the shared mapping succeeded)."""
        self.prefix_hits += 1
        self.prefix_tokens_saved += int(tokens_saved)
        if trace.enabled():
            trace.event("prefix.hit", pool=self.monitor_pool,
                        tokens_saved=int(tokens_saved))
        if monitor.enabled():
            self._prefix_hits_counter().labels(pool=self.monitor_pool).inc()
            if tokens_saved:
                self._prefix_saved_counter().labels(
                    pool=self.monitor_pool).inc(int(tokens_saved))

    # -- invariant validators ------------------------------------------------
    def check(self) -> None:
        """Every page is in exactly ONE of free / parked / referenced, by
        REFCOUNT ACCOUNTING (a page may appear in several slot rows iff its
        refcount equals the appearance count); parked pages are indexed
        and in no row; every ``page_table`` row mirrors its slot's pages
        (in order, -1 tail); the prefix index is consistent; and under
        int8 every referenced or parked page has established scales, no
        free page does, and the fresh-scale queue holds no free page.
        Raises RuntimeError on the first violation."""
        owner: Dict[int, str] = {}
        for pid in self._free:
            if pid in owner:
                raise RuntimeError(
                    f"page {pid} appears twice in the free list")
            owner[pid] = "free"
        for pid in self._parked:
            if pid in owner:
                raise RuntimeError(
                    f"page {pid} parked in the prefix LRU is also "
                    f"{owner[pid]}")
            if pid not in self._hash_of:
                raise RuntimeError(
                    f"page {pid} parked in the prefix LRU but not indexed")
            if self._ref.get(pid, 0):
                raise RuntimeError(
                    f"page {pid} parked with refcount {self._ref[pid]} "
                    f"(must be 0)")
            owner[pid] = "parked"
        appear: Dict[int, int] = {}
        for pages in self._owned.values():
            for pid in pages:
                appear[pid] = appear.get(pid, 0) + 1
        for pid, n in appear.items():
            if pid in owner:
                raise RuntimeError(
                    f"page {pid} referenced by a slot is also {owner[pid]}")
            r = self._ref.get(pid, 0)
            if r != n:
                raise RuntimeError(
                    f"page {pid} appears in {n} slot row(s) but its "
                    f"refcount is {r} — sharing is legal only with a "
                    f"matching refcount (double-own / refcount leak)")
            owner[pid] = f"referenced(x{n})"
        for pid, r in self._ref.items():
            if appear.get(pid, 0) != r:
                raise RuntimeError(
                    f"page {pid} has refcount {r} but appears in "
                    f"{appear.get(pid, 0)} slot row(s) (refcount leak)")
        shared = sum(1 for r in self._ref.values() if r > 1)
        if shared != self._shared:
            raise RuntimeError(
                f"incremental shared-page counter {self._shared} disagrees "
                f"with the pool ({shared} pages with refcount > 1)")
        if set(owner) != set(range(self.num_pages)):
            missing = sorted(set(range(self.num_pages)) - set(owner))
            foreign = sorted(set(owner) - set(range(self.num_pages)))
            raise RuntimeError(
                f"free ∪ parked ∪ referenced does not partition the pool: "
                f"missing {missing}, foreign {foreign}")
        for h, pid in self._index.items():
            if self._hash_of.get(pid) != h:
                raise RuntimeError(
                    f"prefix index maps {h.hex()} -> page {pid} but the "
                    f"page's hash differs")
        for pid, h in self._hash_of.items():
            if self._index.get(h) != pid:
                raise RuntimeError(
                    f"page {pid} hashed but not (or differently) indexed")
            if pid not in self._tok_of or pid not in self._parent_of:
                raise RuntimeError(
                    f"indexed page {pid} missing token/parent records")
            if self._ref.get(pid, 0) == 0 and pid not in self._parked:
                raise RuntimeError(
                    f"page {pid} indexed with refcount 0 but not parked "
                    f"(index leak)")
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
                if state == "free":
                    if pid in self._scaled:
                        raise RuntimeError(
                            f"free page {pid} still marked "
                            f"scale-established (freed pages must reset "
                            f"scale bookkeeping)")
                elif pid not in self._scaled:
                    raise RuntimeError(
                        f"{state} page {pid} has no established scales — a "
                        f"copy-on-write forgot to carry the per-page scale "
                        f"rows")
            for pid in self._fresh_scales:
                if owner.get(pid, "free") == "free":
                    raise RuntimeError(
                        f"fresh-scale queue holds page {pid}, which is "
                        f"{owner.get(pid, 'foreign')}: the reset queue is "
                        f"out of sync with the claims")

    def check_coverage(self, slot: int, live_len: int,
                       write_ahead: int = 1) -> None:
        """Per-gap net under :func:`write_tokens`' silent drop and a
        forgotten copy-on-write: ``slot``'s live length must lie inside its
        mapped pages, and the page the next decode write lands in must be
        PRIVATE (refcount 1, unindexed) with (int8) established scales.
        The paged engine calls it for every live slot per gap under
        ``debug_pages``."""
        owned = self._owned.get(slot, [])
        if self.pages_for(live_len) > len(owned):
            raise RuntimeError(
                f"slot {slot}: live length {live_len} extends past its "
                f"{len(owned)} mapped page(s) — a KV write was (or would "
                f"be) silently dropped (forgot ensure()/CoW?)")
        max_len = self.page_size * self.page_table.shape[1]
        for pos in range(live_len, min(live_len + write_ahead, max_len)):
            # unmapped growth is the optimistic grow path's business
            if self.needs_cow(slot, pos):
                raise RuntimeError(
                    f"slot {slot}: next decode write at position {pos} "
                    f"lands in shared/indexed page "
                    f"{owned[pos // self.page_size]} — missing "
                    f"copy-on-write")
            if (self.kv_dtype == "int8"
                    and pos // self.page_size < len(owned)
                    and owned[pos // self.page_size] not in self._scaled):
                raise RuntimeError(
                    f"slot {slot}: imminent int8 write at position {pos} "
                    f"lands in page {owned[pos // self.page_size]} whose "
                    f"scales were never established (missing CoW scale "
                    f"copy or claim reset)")

    def check_scales(self, k_scale: torch.Tensor,
                     v_scale: torch.Tensor) -> None:
        """Device half of the int8 scale invariants (one layer's scale
        tensors, read back under ``debug_pages``): every referenced or
        parked page's scales are finite and positive."""
        ks = k_scale.detach().float().cpu().numpy()
        vs = v_scale.detach().float().cpu().numpy()
        live = sorted(set().union(
            *(set(p) for p in self._owned.values())) | set(self._parked))
        for pid in live:
            for name, arr in (("k", ks), ("v", vs)):
                row = arr[pid]
                if not np.all(np.isfinite(row)) or np.any(row <= 0):
                    raise RuntimeError(
                        f"page {pid}: non-finite/non-positive {name} scale "
                        f"row {row.tolist()} — quantized store fed "
                        f"garbage, dequant poisoned")

    def needs_cow(self, slot: int, pos: int) -> bool:
        """True when the page mapped at token position ``pos`` of ``slot``
        is shared (refcount > 1) or indexed: a write there must go through
        :meth:`cow` first. False for private pages and unmapped
        positions."""
        owned = self._owned.get(slot, [])
        idx = pos // self.page_size
        if idx >= len(owned):
            return False
        pid = owned[idx]
        return self._ref.get(pid, 0) > 1 or pid in self._hash_of

    # -- claims and releases -------------------------------------------------
    def _claim_page(self) -> int:
        """One fresh private page: from the free heap (lowest id first),
        else by evicting the LRU-oldest parked page (its index entries
        drop: a later lookup simply misses)."""
        if self._free:
            return self._note_claim(heapq.heappop(self._free))
        if self._parked:
            pid, _h = self._parked.popitem(last=False)
            self._unindex(pid)
            if trace.enabled():
                trace.event("prefix.evict", pool=self.monitor_pool, page=pid)
            return self._note_claim(pid)
        raise RuntimeError("page pool exhausted")

    def _note_claim(self, pid: int) -> int:
        """Scale bookkeeping of a fresh claim (int8): its scale rows are a
        previous owner's, so it leaves ``_scaled`` and queues for the
        engine's reset flush; :meth:`cow` pulls it off the queue again and
        waits for :meth:`note_scale_copied`."""
        if self.kv_dtype == "int8":
            self._scaled.discard(pid)
            self._fresh_scales.append(pid)
            self._count_quant_claim()
        return pid

    def note_scale_copied(self, pid: int) -> None:
        """The engine copied scale rows onto ``pid`` (copy-on-write's
        second half, or an import's): its scales are established. Under
        ``debug`` the post-copy check runs here (:meth:`cow` and
        :meth:`adopt_block` cannot check themselves: their return value is
        the copy instruction)."""
        if self.kv_dtype != "int8":
            return
        self._scaled.add(pid)
        if self.debug:
            self.check()

    def take_fresh_scales(self) -> List[int]:
        """Drain the queue of claimed pages whose scale rows the engine
        must reset to the floor before any quantized write lands in them
        (int8; empty otherwise)."""
        out, self._fresh_scales = self._fresh_scales, []
        return out

    def _unindex(self, pid: int) -> None:
        h = self._hash_of.pop(pid, None)
        if h is not None and self._index.get(h) == pid:
            del self._index[h]
        self._tok_of.pop(pid, None)
        parent = self._parent_of.pop(pid, None)
        if parent is not None:
            kids = self._next.get(parent)
            if kids is not None:
                kids.discard(pid)
                if not kids:
                    del self._next[parent]

    def _release_ref(self, pid: int) -> None:
        """Drop one reference; at zero the page parks (still indexed) or
        returns to the free heap."""
        n = self._ref.get(pid, 0) - 1
        if n == 1:
            self._shared -= 1
        if n > 0:
            self._ref[pid] = n
            return
        self._ref.pop(pid, None)
        if pid in self._hash_of:
            self._parked[pid] = self._hash_of[pid]
            self._parked.move_to_end(pid)
            if trace.enabled():
                trace.event("prefix.park", pool=self.monitor_pool, page=pid)
        else:
            # a freed page's scale rows belong to a dead owner; a claim
            # freed before the engine's flush ran leaves the queue too
            self._scaled.discard(pid)
            if pid in self._fresh_scales:
                self._fresh_scales.remove(pid)
            heapq.heappush(self._free, pid)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s mapping to cover ``n_tokens`` positions with
        PRIVATE pages (already-mapped pages, shared ones included, count
        toward coverage). Raises RuntimeError when the pool cannot supply
        the pages (nothing is claimed then) and ValueError past
        ``max_pages``."""
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
        if need > len(self._free) + len(self._parked):
            raise RuntimeError(
                f"page pool exhausted: slot {slot} needs {need} pages, "
                f"{len(self._free) + len(self._parked)} reclaimable — "
                "drain finished requests or grow num_pages")
        for _ in range(need):
            pid = self._claim_page()
            self._ref[pid] = 1
            if self.kv_dtype == "int8":
                # established by protocol: the claim sits on the fresh
                # queue, and the engine's flush resets its scale rows
                # before any write lands in it
                self._scaled.add(pid)
            self.page_table[slot, len(owned)] = pid
            owned.append(pid)
        self._publish_occupancy()
        if self.debug:
            self.check()

    def free_slot(self, slot: int) -> None:
        """Release the slot's references (request retired): private pages
        return to the pool, shared pages survive for their other
        referents, and indexed pages left with no referent park in the
        LRU."""
        for pid in self._owned.pop(slot, []):
            self._release_ref(pid)
        self.page_table[slot, :] = -1
        self._publish_occupancy()
        if self.debug:
            self.check()

    # -- the prefix cache ----------------------------------------------------
    def lookup_prefix(self, tokens, salt: bytes = b""
                      ) -> Tuple[List[int], int, List[bytes]]:
        """Longest resident cached prefix of ``tokens`` (1-D int ids).

        Walks the full-block chain hash (token-verified per block), then
        tries ONE partial block: an indexed child of the last matched chain
        point whose leading tokens extend the match (the page the caller
        must copy-on-write before its first write). Returns ``(pids,
        coverage, hashes)``: the resident pages to map read-only in order,
        the token coverage they give (``<= len(tokens)``), and the
        full-block chain hashes (for registering the blocks the caller
        prefills). Refreshes the LRU order of parked hits and claims no
        reference (:meth:`map_shared` does). ``salt`` replaces the chain
        root, so differently salted chains never match."""
        self.prefix_lookups += 1
        toks = np.ascontiguousarray(np.asarray(tokens).reshape(-1), np.int32)
        ps = self.page_size
        nfull = len(toks) // ps
        root = _chain_root(salt)
        hashes: List[bytes] = []
        h = root
        for b in range(nfull):
            h = _block_hash(h, toks[b * ps:(b + 1) * ps])
            hashes.append(h)
        pids: List[int] = []
        matched = 0
        while matched < nfull:
            pid = self._index.get(hashes[matched])
            if pid is None or not np.array_equal(
                    self._tok_of[pid], toks[matched * ps:(matched + 1) * ps]):
                break
            pids.append(pid)
            matched += 1
        cov = matched * ps
        rem = toks[cov:]
        if len(rem):
            parent = hashes[matched - 1] if matched else root
            best, best_m = None, 0
            # the set is walked in its own order, as the reference walks
            # it: the same adds and discards give the same order, so a tie
            # between two children resolves the same way
            for pid in self._next.get(parent, ()):
                bt = self._tok_of.get(pid)
                if bt is None:
                    continue
                lim = min(len(rem), ps)
                m = 0
                while m < lim and int(bt[m]) == int(rem[m]):
                    m += 1
                if m > best_m:
                    best, best_m = pid, m
            if best is not None and best_m > 0:
                pids.append(best)
                cov += best_m
        for pid in pids:
            if pid in self._parked:
                self._parked.move_to_end(pid)
        return pids, cov, hashes

    def map_shared(self, slot: int, pids: List[int]) -> None:
        """Map resident cached pages read-only into an EMPTY slot's row
        (refcount + 1 each; parked pages leave the LRU but stay indexed).
        The first write into any of them must go through :meth:`cow`."""
        if self._owned.get(slot):
            raise RuntimeError(
                f"map_shared needs an empty slot, slot {slot} already owns "
                f"{len(self._owned[slot])} page(s)")
        if not pids:
            return
        owned = self._owned.setdefault(slot, [])
        for pid in pids:
            self._parked.pop(pid, None)
            n = self._ref.get(pid, 0) + 1
            if n == 2:
                self._shared += 1
            self._ref[pid] = n
            self.page_table[slot, len(owned)] = pid
            owned.append(pid)
        self._publish_occupancy()
        if self.debug:
            self.check()

    def cow(self, slot: int, page_idx: int) -> Tuple[int, int]:
        """Copy-on-write bookkeeping of ``slot``'s page at ``page_idx``:
        claim a fresh private page, swap the table entry, release the old
        reference (the original survives for its other referents or stays
        parked). Returns ``(old_pid, new_pid)``; the caller copies the
        rows (:func:`copy_page`) BEFORE any write to the new page, and
        under int8 copies the scales too and calls
        :meth:`note_scale_copied`."""
        owned = self._owned[slot]
        old = owned[page_idx]
        new = self._claim_page()
        if self.kv_dtype == "int8":
            # NOT a fresh-reset page: the device copy brings the source's
            # scales, so it leaves the reset queue (a flush would floor
            # the copied scales) and stays un-established until
            # note_scale_copied
            self._fresh_scales.remove(new)
        self._ref[new] = 1
        owned[page_idx] = new
        self.page_table[slot, page_idx] = new
        self._release_ref(old)
        self.cow_copies += 1
        if trace.enabled():
            trace.event("prefix.cow", pool=self.monitor_pool, slot=slot,
                        old=old, new=new)
        self._publish_occupancy()
        if self.debug and self.kv_dtype != "int8":
            self.check()
        return old, new

    def register_blocks(self, slot: int, hashes: List[bytes], tokens,
                        start_block: int, end_block: int,
                        salt: bytes = b"") -> None:
        """Index ``slot``'s fully written prompt blocks ``[start_block,
        end_block)`` under their chain hashes so later admissions can map
        them read-only. Only PRIVATE pages (refcount 1, unindexed)
        register; a hash already taken keeps its first page. ``salt``
        must be the one ``hashes`` were made with."""
        if not self.prefix_cache:
            return
        owned = self._owned.get(slot, [])
        toks = np.ascontiguousarray(np.asarray(tokens).reshape(-1), np.int32)
        ps = self.page_size
        for b in range(start_block, end_block):
            if b >= len(owned) or b >= len(hashes):
                break
            pid = owned[b]
            h = hashes[b]
            if (h in self._index or pid in self._hash_of
                    or self._ref.get(pid, 0) != 1):
                continue
            self._index[h] = pid
            self._hash_of[pid] = h
            self._tok_of[pid] = toks[b * ps:(b + 1) * ps].copy()
            parent = hashes[b - 1] if b else _chain_root(salt)
            self._parent_of[pid] = parent
            self._next.setdefault(parent, set()).add(pid)
        if self.debug:
            self.check()

    def adopt_block(self, h: bytes, parent: bytes, tokens) -> Optional[int]:
        """Adopt one IMPORTED full block into the prefix index as a PARKED
        page (refcount 0, LRU-reclaimable): the bookkeeping half of a KV-page
        import. The caller copies the rows onto the returned page
        (:func:`install_page` / :func:`install_page_q`, then, int8,
        :meth:`note_scale_copied`).

        Idempotent by content address: a hash already resident returns
        ``None`` and claims nothing, so a replayed handoff is a no-op.
        ``parent`` is the previous block's chain hash (or the salted chain
        root for block 0): recording it lets the partial-block child walk
        find imported blocks as it finds local ones. Raises RuntimeError
        when no page can be reclaimed."""
        if not self.prefix_cache:
            raise RuntimeError(
                "adopt_block needs the prefix cache (an unindexed import "
                "could never be found again: build the importing engine "
                "with prefix_cache=True)")
        toks = np.ascontiguousarray(np.asarray(tokens).reshape(-1), np.int32)
        if len(toks) != self.page_size:
            raise ValueError(
                f"adopt_block takes exactly one FULL block "
                f"({self.page_size} tokens), got {len(toks)}")
        if h in self._index:
            return None
        pid = self._claim_page()
        if self.kv_dtype == "int8":
            # not a fresh-reset page: the import lands the source page's
            # scale rows, so the engine's flush must not floor them; until
            # note_scale_copied the page is deliberately un-established
            self._fresh_scales.remove(pid)
        self._index[h] = pid
        self._hash_of[pid] = h
        self._tok_of[pid] = toks.copy()
        self._parent_of[pid] = parent
        self._next.setdefault(parent, set()).add(pid)
        self._parked[pid] = h
        self._parked.move_to_end(pid)
        self._publish_occupancy()
        if self.debug and self.kv_dtype != "int8":
            self.check()
        return pid

    def clear_prefix_index(self) -> None:
        """Drop the whole content index and return parked pages to the
        free heap (the engine's ``reset_state``: the pools are zeroed, so
        every cached block's KV is gone)."""
        for pid in list(self._parked):
            self._scaled.discard(pid)
            heapq.heappush(self._free, pid)
        self._parked.clear()
        self._index.clear()
        self._hash_of.clear()
        self._tok_of.clear()
        self._parent_of.clear()
        self._next.clear()
        self._publish_occupancy()
        if self.debug:
            self.check()

    # -- storage dtype and teardown ------------------------------------------
    def set_kv_dtype(self, kv_dtype: str) -> None:
        """Swap the storage dtype's bookkeeping. The engine owns rebuilding
        the pools (its idle-only ``set_kv_dtype``); fresh pools start at
        floor scales, so nothing is established or pending, and the old
        dtype's pages gauge is retired."""
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        if kv_dtype == self.kv_dtype:
            return
        self._retire_pages_gauge()
        self.kv_dtype = kv_dtype
        self._scaled.clear()
        self._fresh_scales.clear()
        self._publish_occupancy()

    def _retire_pages_gauge(self) -> None:
        monitor.remove_series("paddle_tpu_kv_pages", pool=self.monitor_pool)

    def close(self) -> None:
        """Retire this pool's monitor series (idempotent): a dropped
        engine's gauges must not export their last values forever."""
        self._retire_pages_gauge()
        self._occupancy_gauge().remove(pool=self.monitor_pool)
        for name in ("paddle_tpu_kv_preemptions_total",
                     "paddle_tpu_kv_prefix_hits_total",
                     "paddle_tpu_kv_prefix_tokens_saved_total",
                     "paddle_tpu_kv_shared_pages",
                     "paddle_tpu_kv_quant_bytes_saved_total"):
            monitor.remove_series(name, pool=self.monitor_pool)
