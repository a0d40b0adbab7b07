"""How the program ledger counts and times the engines' programs.

Private to ``paddle_tpu_torch.monitor``: the cost counter, the device timer
and the two dispatch paths (:func:`run_eager` for code that is not
captured, :func:`graph_dispatch` for ``GraphCache`` programs) that feed
:mod:`paddle_tpu_torch.monitor.ledger`.

**Cost** (the port's counterpart of XLA's ``cost_analysis()``): one run of
the program under a ``TorchDispatchMode`` that sees every aten op.

- ``flops``: each op's FLOPs by ``torch.utils.flop_counter``'s registered
  formulas (matmuls, convolutions, attention), plus the analytic FLOPs each
  hand-written kernel's wrapper reports (``ops/_launches.py``). Elementwise
  ops count no FLOPs, as in the flop counter.
- ``bytes_accessed``: the input and output bytes of every op that is not a
  view, plus each kernel's reported bytes. Ops that read or write through
  an index (``embedding``, ``index_select``, ``gather``, indexing,
  ``index_put_``, ``index_copy_``, ``scatter_``) count the elements they
  touch, not the whole tensor they index into; ``copy_`` and ``fill_``
  count their destination once; allocations and aliases (``_unsafe_view``)
  count nothing. Each op counts
  its own traffic, unfused, so a program's bytes are more than XLA's count
  of the same program would be, where fusion keeps intermediates on chip.
- A kernel wrapper's body runs inside its kernel scope, which the counter
  skips: on the CPU the plain version's ops add nothing, so both devices
  count the same numbers.

A program's cost is counted once, on its first run while the ledger is on:
a captured program's eager first run, before the capture (the counter is
off during the capture itself), an eager program's first ledger-seen
dispatch. Wrappers of data-dependent kernels read their lengths back during
that run (a host sync, in that run only).

**Seconds.** On the card a dispatch is bracketed by two CUDA events on the
current stream, taken from a pool; a completed pair is resolved
(``query()``, then ``elapsed_time``) at the next record or profile read,
so a dispatch never waits for an event and nothing is synchronized. These
are device seconds: for a captured program the replay's time on the
stream; for an eager program the time from its first kernel's start to its
last one's end, which includes the stream's idle gaps while the host
launches, where the reference's ledger records the host-observed dispatch
wall. On the CPU, where ops are synchronous, a dispatch's seconds are its
host wall time. The first (counted, capturing) run goes to ``compiles`` and
``compile_seconds``, never to the digest.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..ops import _launches
from . import ledger as _ledger

__all__ = ["count_cost", "run_eager", "graph_dispatch", "resolve"]

aten = torch.ops.aten

_FLOP_FORMULAS = None


def _formulas():
    global _FLOP_FORMULAS
    if _FLOP_FORMULAS is None:
        from torch.utils.flop_counter import flop_registry

        _FLOP_FORMULAS = flop_registry
    return _FLOP_FORMULAS


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(_nbytes(x) for x in leaves)


# ops that read through an index: (the gathered elements read, the output
# written) and the indices read; ops that write through one: the source
# read, the same number of elements written and the indices read
_INDEX_READS = {aten.embedding, aten.index_select, aten.gather, aten.index,
                aten.take, aten.take_along_dim}
_INDEX_WRITES = {aten.index_put_, aten.index_put, aten._index_put_impl_,
                 aten.index_copy_, aten.index_copy, aten.scatter_,
                 aten.scatter, aten.scatter_add_, aten.scatter_add,
                 aten.index_add_, aten.index_add}
# allocations, and ops that alias their input without the view tag, move
# no data
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.set_,
               aten.resize_, aten.detach, aten.lift_fresh,
               aten._unsafe_view, aten._local_scalar_dense}
_OVERWRITES = {aten.fill_, aten.zero_}


_PUTS = {aten.index_put_, aten.index_put, aten._index_put_impl_}
_SCATTERS = {aten.scatter_, aten.scatter, aten.scatter_add_,
             aten.scatter_add}


def _index_write_bytes(packet, args) -> int:
    """An op writing through an index: its source read and as many bytes
    written, and its indices read."""
    if packet in _PUTS:                 # (self, indices, values, ...)
        return 2 * _nbytes(args[2]) + _tensors_bytes(args[1])
    index = args[2]                     # (self, dim, index, src, ...)
    if packet in _SCATTERS and not isinstance(args[3], torch.Tensor):
        src = index.numel() * args[0].element_size()
    else:
        src = _nbytes(args[3])
    return 2 * src + _nbytes(index)


def _op_bytes(func, args, kwargs, out) -> int:
    packet = func.overloadpacket
    if packet in _NO_TRAFFIC or func.is_view:
        return 0
    if packet in _INDEX_READS:
        idx = sum(_nbytes(x) for x in tree_flatten((args[1:], kwargs))[0]
                  if isinstance(x, torch.Tensor))
        return 2 * _tensors_bytes(out) + idx
    if packet in _INDEX_WRITES:
        return _index_write_bytes(packet, args)
    if packet is aten.copy_:
        return _nbytes(args[0]) + _nbytes(args[1])
    if packet in _OVERWRITES:
        return _nbytes(args[0])
    ins = {k: v for k, v in kwargs.items() if k != "out"}
    return _tensors_bytes((args, ins)) + _tensors_bytes(out)


class _CostMode(TorchDispatchMode):
    """FLOPs and bytes of every aten op outside the kernels' scopes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # a paddle_tpu:: library op is a kernel: its wrapper reports it
        if not _launches.in_kernel() and func.namespace != "paddle_tpu":
            formula = _formulas().get(func.overloadpacket)
            if formula is not None:
                try:
                    self.flops += int(formula(*args, **kwargs, out_val=out))
                except Exception:
                    pass
            self.bytes += _op_bytes(func, args, kwargs, out)
        return out


def count_cost(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn()`` once, counted; returns ``(its result, cost)``: ``flops``
    and ``bytes_accessed``, the ops' and the kernels' reports."""
    with _launches.cost_tally() as tally, _CostMode() as mode:
        out = fn()
    return out, {"flops": float(mode.flops + tally.flops),
                 "bytes_accessed": float(mode.bytes + tally.bytes)}


# -- device seconds ----------------------------------------------------------

_local = threading.local()          # .busy: inside a program on this thread
_pending_lock = threading.Lock()
_pending: List[tuple] = []          # (device, pid, start, end event)
_pool: Dict[Any, List] = {}         # device -> free timing events
_POOL_CHUNK = 32


def _event(device):
    with _pending_lock:
        free = _pool.setdefault(device, [])
        if not free:
            free.extend(torch.cuda.Event(enable_timing=True)
                        for _ in range(_POOL_CHUNK))
        return free.pop()


def _start(device):
    """A dispatch's start: an event recorded on the current stream (the
    card), or the host clock (the CPU)."""
    if device.type == "cuda":
        ev = _event(device)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def _stop(device, start, pid: str) -> Optional[float]:
    """A dispatch's end: the host seconds on the CPU; on the card an end
    event queued with its start for :func:`resolve` (None)."""
    if device.type != "cuda":
        return time.perf_counter() - start
    end = _event(device)
    end.record(torch.cuda.current_stream(device))
    with _pending_lock:
        _pending.append((device, pid, start, end))
    return None


def resolve() -> None:
    """Hand the ledger the seconds of every completed event pair; pairs
    still in flight stay queued. Never waits."""
    done = []
    with _pending_lock:
        if not _pending:
            return
        keep = []
        for item in _pending:
            device, pid, start, end = item
            if end.query():
                done.append((pid, start.elapsed_time(end) / 1e3))
                _pool[device].extend((start, end))
            else:
                keep.append(item)
        _pending[:] = keep
    for pid, dt in done:
        _ledger._observe(pid, dt)


def _busy() -> bool:
    return getattr(_local, "busy", False)


def _capturing(device) -> bool:
    return (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


# -- the two dispatch paths --------------------------------------------------


def run_eager(name: str, owner: Optional[str], signature: str, key: Hashable,
              device, fn: Callable, args, kwargs):
    """One dispatch of an eager program with the ledger on: its first
    ledger-seen dispatch is counted (cost, arg and output bytes) and goes to
    ``compiles``; later ones are timed into the digest. A program called
    inside another one, or while this thread captures a graph, runs
    untouched."""
    device = torch.device(device)
    if _busy() or _capturing(device):
        return fn(*args, **kwargs)
    pid = _ledger.program_id(name, key, signature)
    _local.busy = True
    try:
        if not _ledger._has_record(pid):
            t0 = time.perf_counter()
            out, cost = count_cost(lambda: fn(*args, **kwargs))
            cost["arg_bytes"] = _tensors_bytes((args, kwargs))
            cost["output_bytes"] = float(_tensors_bytes(out))
            _ledger.record(pid, name, owner, time.perf_counter() - t0, True,
                           cost, repr(key))
            return out
        t = _start(device)
        out = fn(*args, **kwargs)
        _ledger.record(pid, name, owner, _stop(device, t, pid), False,
                       None, repr(key))
        return out
    finally:
        _local.busy = False


def graph_dispatch(cache, key: Hashable, fn: Callable[[], None]) -> None:
    """One ``GraphCache.run`` with the monitor or the ledger on. A key's
    first run (run, or run and captured) is counted while the ledger is on
    and the program has no cost yet, feeds the monitor's per-program
    compile series, and goes to ``compiles``; a later run is timed."""
    name = cache.program_name(key)
    if name is None or _busy():
        cache._dispatch(key, fn)
        return
    from .. import monitor

    led = _ledger._enabled
    pid = _ledger.program_id(name, key, cache.signature)
    _local.busy = True
    try:
        if not cache.built(key):
            count = led and not _ledger._has_cost(pid)
            t0 = time.perf_counter()
            cost = cache._dispatch(key, fn, count)
            dt = time.perf_counter() - t0
            if monitor.enabled():
                monitor.counter(
                    "paddle_tpu_jit_cache_miss_total",
                    "jit traces+compiles (cache misses) per entry point "
                    "and program", ("fn", "program")).labels(
                        fn=name, program=pid).inc()
                monitor.counter(
                    "paddle_tpu_jit_compile_seconds_total",
                    "wall seconds spent tracing+compiling per entry point "
                    "and program", ("fn", "program")).labels(
                        fn=name, program=pid).inc(dt)
            if led:
                _ledger.record(pid, name, cache.owner, dt, True, cost,
                               repr(key))
            return
        if not led:
            cache._dispatch(key, fn)
            return
        t = _start(cache.device)
        cache._dispatch(key, fn)
        _ledger.record(pid, name, cache.owner, _stop(cache.device, t, pid),
                       False, None, repr(key))
    finally:
        _local.busy = False
