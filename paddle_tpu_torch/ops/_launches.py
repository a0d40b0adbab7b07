"""Launch counting. Each kernel wrapper calls :func:`count` where it
launches its kernel, and nowhere else. The counts are shared by every
thread (replicas of a fleet in one process launch side by side), so they
change under a lock; and a thread that is capturing a CUDA graph tallies its
launches apart (:func:`capture_tally`), so a graph's replay credit holds its
own launches only, whatever other threads launch during the capture."""
from __future__ import annotations

import contextlib
import threading

__all__ = ["count", "credit", "capture_tally"]

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
