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
warmup, another replica's replays and read-backs) cannot invalidate it; the
calling thread owns the engine and makes no other CUDA call meanwhile.
Captures are serialized process-wide (PyTorch supports one capture at a
time: they share its capture stream), so replicas of a fleet in one process
that warm up at once capture in turns; the device-wide synchronize and the
cache release before a capture run under the same lock, where no capture of
another thread can be under way. Python's cyclic garbage collector is run
before the capture and held off during it: an engine dropped in a
reference cycle would otherwise have its graphs destroyed mid-capture by a
collection the capture's own allocations set off, and a graph's
destruction is a CUDA call that invalidates the capture. A CPU device is the caller asking for the CPU: the
function runs eagerly on every call, and a key's first run counts as its
capture, so the bookkeeping is the same on both devices.

Launch counts: each kernel wrapper adds one to its ``launches`` in Python
where it launches, so a replay would count nothing. The capture tallies the
launches of each kernel the graph holds apart from the counters (a capture
runs nothing, and another thread's launches meanwhile are not the graph's:
``ops/_launches.py``), and every replay credits them.

The program ledger: an engine names its keys' programs (``names``: the
key's first element to the reference's program name, such as
``"segment"`` to ``"cb_segment"``) and gives its owner label and static
signature; its eager programs run through :meth:`GraphCache.eager` under
the same owner and signature. With ``FLAGS_enable_ledger`` or
``FLAGS_enable_monitor`` on, :meth:`GraphCache.run` goes through
``monitor/_programs.py``: a key's first run is counted (its eager run,
before the capture, never the capture) and charged to the program's
compiles and to the monitor's per-program compile series, and every later
run is timed by two CUDA events around the replay (the host clock on the
CPU) into the program's digest, without a sync. With both off, a call pays
one bool branch.
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from .. import monitor
from ..monitor import ledger as _ledger
from ..ops import KERNELS
from ..ops._launches import capture_tally, credit

__all__ = ["GraphCache"]

# one capture at a time in the process (see the module docstring)
_CAPTURE_LOCK = threading.Lock()


def _eager(fn: Callable[[], None], count: bool) -> Optional[dict]:
    """Run ``fn`` eagerly; with ``count``, under the program ledger's cost
    counter, returning the cost."""
    if not count:
        fn()
        return None
    from ..monitor import _programs

    return _programs.count_cost(fn)[1]


class GraphCache:
    """The captured graphs of one engine, keyed by program.

    ``captures[key]``: how many times the key was captured (the CPU: run
    for the first time); ``capture_s[key]``: seconds of its last capture
    (the CPU: of its first run); ``pool_bytes[key]``: device memory the
    capture reserved for the graph's private pool (0 on the CPU).
    ``capture = False`` runs every call eagerly on the card as well: the
    uncaptured twin that ``chip_smoke.py`` holds the graphs' streams
    against.

    ``names``, ``owner`` and ``signature`` place the keys' programs in the
    program ledger (``monitor/ledger.py``): a key whose first element is not
    in ``names`` is not recorded."""

    def __init__(self, device, names: Optional[Dict[str, str]] = None,
                 owner: Optional[str] = None, signature: str = ""):
        self.device = torch.device(device)
        self.names = dict(names or {})
        self.owner = owner
        self.signature = signature
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
        if monitor._enabled or _ledger._enabled:
            from ..monitor import _programs

            _programs.graph_dispatch(self, key, fn)
        else:
            self._dispatch(key, fn)

    def eager(self, name: str, key: Hashable, fn: Callable, *args,
              **kwargs):
        """Run ``fn(*args, **kwargs)`` as a dispatch of the engine's eager
        program ``name`` at ``key`` (``monitor.monitored_eager``, under this
        cache's owner, signature and device); returns its result."""
        return monitor.monitored_eager(name, fn, *args, owner=self.owner,
                                       signature=self.signature,
                                       device=self.device, key=key,
                                       **kwargs)

    def program_name(self, key: Hashable) -> Optional[str]:
        """The ledger's name of the key's program (None: not recorded)."""
        return self.names.get(key[0] if isinstance(key, tuple) else key)

    def built(self, key: Hashable) -> bool:
        """Whether the key ran (the CPU) or was captured already."""
        return key in self._graphs

    def _dispatch(self, key: Hashable, fn: Callable[[], None],
                  count: bool = False) -> Optional[dict]:
        """:meth:`run` itself. On the key's first call with ``count``, its
        eager run is counted and its cost returned."""
        if self.device.type != "cuda" or not self.capture:
            if key in self._graphs:
                fn()
                return None
            t0 = time.perf_counter()
            cost = _eager(fn, count)
            self._graphs[key] = None
            self._built(key, t0, 0)
            return cost
        entry = self._graphs.get(key)
        if entry is None:
            return self._first_run(key, fn, count)
        graph, launches = entry
        graph.replay()
        for name, n in launches.items():
            credit(KERNELS[name], n)
        return None

    def _built(self, key: Hashable, t0: float, pool_bytes: int) -> None:
        self.captures[key] = self.captures.get(key, 0) + 1
        self.capture_s[key] = time.perf_counter() - t0
        self.pool_bytes[key] = pool_bytes

    def _first_run(self, key: Hashable, fn: Callable[[], None],
                   count: bool = False) -> Optional[dict]:
        with _CAPTURE_LOCK:
            return self._capture(key, fn, count)

    def _capture(self, key: Hashable, fn: Callable[[], None],
                 count: bool = False) -> Optional[dict]:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            cost = _eager(fn, count)
        torch.cuda.current_stream(dev).wait_stream(side)
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            # thread_local: only this thread's CUDA calls can invalidate
            # the capture; the serving front's HTTP threads (a /metrics
            # scrape during a Server's warmup) do not
            with capture_tally() as tally, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                fn()
        finally:
            if gc_on:
                gc.enable()
        self._graphs[key] = (graph, {name: tally[k]
                                     for name, k in KERNELS.items()
                                     if k in tally})
        self._built(key, t0, torch.cuda.memory_reserved(dev) - mem0)
        return cost

    def clear(self) -> None:
        """Drop every graph (the tensors they hold were replaced); the next
        call of each key captures it again and counts once more."""
        self._graphs.clear()

    def drop(self, which: Callable[[Hashable], bool]) -> None:
        """Drop the graphs of the keys ``which`` selects (an engine knob
        they depend on changed); the others are kept."""
        for key in [k for k in self._graphs if which(k)]:
            del self._graphs[key]
