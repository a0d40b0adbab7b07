"""One captured CUDA graph per program key: the engines' decode steps.

The port's counterpart of the reference's ``monitor.monitored_jit`` cache.
The JAX engines compile a decode segment (a ``lax.scan``) once per key and
count the cache misses; here :meth:`GraphCache.run` captures a key's
function into a ``torch.cuda.CUDAGraph`` once and replays the graph on
every later call, and :attr:`GraphCache.captures` counts the captures per
key. An engine's ``warmup()`` captures its keys ahead of the requests, so
a serve after it captures nothing.

What a captured function must be: it takes no arguments and is a function
of the contents of tensors that outlive the graph (the engine's caches,
slot state and output buffers, all allocated once and written in place);
it allocates only scratch, and syncs nothing with the host. A replay reruns
the same kernels on the same addresses.

On a CUDA device the first call of a key runs the function eagerly on a side
stream (the call's real work, and the warm-up a capture needs: cuBLAS's
workspace, kernel builds, tables built at first use), then captures it
without running it; every later call replays. A failed capture raises:
nothing retries eagerly. The capture runs in ``thread_local`` error mode, so
another thread's CUDA calls (a metrics scrape beside a serving scheduler's
warmup) cannot invalidate it; the calling thread owns the engine and makes
no other CUDA call meanwhile. Python's cyclic garbage collector is run
before the capture and held off during it: an engine dropped in a
reference cycle would otherwise have its graphs destroyed mid-capture by a
collection the capture's own allocations set off, and a graph's
destruction is a CUDA call that invalidates the capture. A CPU device is the caller asking for the CPU: the
function runs eagerly on every call, and a key's first run counts as its
capture, so the bookkeeping is the same on both devices.

Launch counts: each kernel wrapper adds one to its ``launches`` in Python
where it launches, so a replay would count nothing. The capture records how
many launches of each kernel the graph holds (and takes them back off the
counters: a capture runs nothing), and every replay credits them.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from ..ops import KERNELS, launch_counts

__all__ = ["GraphCache"]


class GraphCache:
    """The captured graphs of one engine, keyed by program.

    ``captures[key]``: how many times the key was captured (the CPU: run
    for the first time); ``capture_s[key]``: seconds of its last capture
    (the CPU: of its first run); ``pool_bytes[key]``: device memory the
    capture reserved for the graph's private pool (0 on the CPU).
    ``capture = False`` runs every call eagerly on the card as well: the
    uncaptured twin that ``chip_smoke.py`` holds the graphs' streams
    against."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = True
        self.captures: Dict[Hashable, int] = {}
        self.capture_s: Dict[Hashable, float] = {}
        self.pool_bytes: Dict[Hashable, int] = {}
        # key -> (graph, launches per replay); None for a key run eagerly
        self._graphs: Dict[Hashable, Optional[Tuple[torch.cuda.CUDAGraph,
                                                    Dict[str, int]]]] = {}

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Run ``fn`` as the program ``key``: replay its graph, or run it
        and capture it on the key's first call."""
        if self.device.type != "cuda" or not self.capture:
            if key in self._graphs:
                fn()
                return
            t0 = time.perf_counter()
            fn()
            self._graphs[key] = None
            self._built(key, t0, 0)
            return
        entry = self._graphs.get(key)
        if entry is None:
            self._first_run(key, fn)
            return
        graph, credit = entry
        graph.replay()
        for name, n in credit.items():
            KERNELS[name].launches += n

    def _built(self, key: Hashable, t0: float, pool_bytes: int) -> None:
        self.captures[key] = self.captures.get(key, 0) + 1
        self.capture_s[key] = time.perf_counter() - t0
        self.pool_bytes[key] = pool_bytes

    def _first_run(self, key: Hashable, fn: Callable[[], None]) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            # thread_local: only this thread's CUDA calls can invalidate
            # the capture; the serving front's HTTP threads (a /metrics
            # scrape during a Server's warmup) do not
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                fn()
        finally:
            if gc_on:
                gc.enable()
            after = launch_counts()
            for name, n in before.items():
                KERNELS[name].launches = n
        self._graphs[key] = (graph, {name: after[name] - n
                                     for name, n in before.items()
                                     if after[name] != n})
        self._built(key, t0, torch.cuda.memory_reserved(dev) - mem0)

    def clear(self) -> None:
        """Drop every graph (the tensors they hold were replaced); the next
        call of each key captures it again and counts once more."""
        self._graphs.clear()

    def drop(self, which: Callable[[Hashable], bool]) -> None:
        """Drop the graphs of the keys ``which`` selects (an engine knob
        they depend on changed); the others are kept."""
        for key in [k for k in self._graphs if which(k)]:
            del self._graphs[key]
