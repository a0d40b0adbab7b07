"""Launch counting and launch costs. Each kernel wrapper calls :func:`count`
where it launches its kernel, and nowhere else. The counts are shared by every
thread (replicas of a fleet in one process launch side by side), so they
change under a lock; and a thread that is capturing a CUDA graph tallies its
launches apart (:func:`capture_tally`), so a graph's replay credit holds its
own launches only, whatever other threads launch during the capture.

Beside the count, each kernel wrapper reports its launch's analytic cost
(:func:`costed`): the FLOPs and the bytes that the kernel must move, computed
from the launch's shapes (and, where the work depends on the data, from its
lengths, offsets or group sizes) by the formulas that ``chip_smoke.py``'s
bounds use. A thread that is counting a program's cost (:func:`cost_tally`)
takes the reports; everywhere else a wrapper pays one thread-local read. The
report is made on both devices, before the wrapper picks its kernel or its
plain version, and the wrapper's body (the plain version's PyTorch ops on the
CPU, the output allocation and padding on the card) runs inside the kernel's
scope (:func:`in_kernel`), which the program cost counter skips: a kernel
costs its analytic count on both devices."""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Tuple

__all__ = ["count", "credit", "capture_tally", "cost_tally", "costed",
           "in_kernel", "CostTally"]

_lock = threading.Lock()
_local = threading.local()


def count(fn) -> None:
    """One launch of ``fn``'s kernel: onto its ``launches``, or into the
    calling thread's capture tally while it captures a graph."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[fn] = tally.get(fn, 0) + 1
        return
    with _lock:
        fn.launches += 1


def credit(fn, n: int) -> None:
    """``n`` launches of ``fn``'s kernel at once (a graph replay)."""
    with _lock:
        fn.launches += n


@contextlib.contextmanager
def capture_tally():
    """Tally the calling thread's launches apart from the counts while the
    block runs (a graph capture runs nothing); yields the tally, a dict of
    kernel wrapper to launches."""
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = None


class CostTally:
    """The kernel costs one thread reported while it counted: ``flops`` and
    ``bytes`` in all; ``depth`` is how many kernel scopes the thread is
    in."""

    __slots__ = ("flops", "bytes", "depth")

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.depth = 0


@contextlib.contextmanager
def cost_tally():
    """Take the calling thread's kernel cost reports while the block runs;
    yields the :class:`CostTally`. Tallies nest: an inner one takes the
    reports made inside it, the outer one none of them."""
    prev = getattr(_local, "cost", None)
    _local.cost = tally = CostTally()
    try:
        yield tally
    finally:
        _local.cost = prev


def in_kernel() -> bool:
    """True while the calling thread counts costs and runs a kernel
    wrapper's body (whose PyTorch ops are the kernel's, not the
    program's)."""
    tally = getattr(_local, "cost", None)
    return tally is not None and tally.depth > 0


def costed(cost: Callable[..., Tuple[int, int]]):
    """Decorate a kernel wrapper: while the calling thread counts costs, the
    call reports ``cost(*args, **kwargs)`` (``(flops, bytes)``) and runs
    inside the kernel's scope; a wrapper called inside another kernel's
    scope reports nothing (the outer one's report covers it). Otherwise the
    call costs one thread-local read."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            tally = getattr(_local, "cost", None)
            if tally is None or tally.depth:
                return fn(*args, **kwargs)
            tally.depth += 1
            try:
                flops, nbytes = cost(*args, **kwargs)
                tally.flops += int(flops)
                tally.bytes += int(nbytes)
                return fn(*args, **kwargs)
            finally:
                tally.depth -= 1
        return call
    return deco
