"""paddle_tpu_torch.testing: deterministic test harnesses.

Port of ``paddle_tpu/testing``. Production robustness features need
reproducible misbehavior to test against; this package holds the
harnesses that create it: :mod:`~paddle_tpu_torch.testing.faults`,
deterministic, site-named fault injection at the serving-path seams
(admission, prefill, chunked prefill, decode segment, collect, and the
replica-kill ``FaultPlan.kill`` seam), which the port's chaos suite
(``tests/test_torch_serving_faults.py``) and ``chip_smoke.py``'s fault leg
drive. :func:`retry_under_load` is the reference's wrapper for
WALL-CLOCK-sensitive tests that are correct alone but flaky when the whole
suite has every core busy.
"""
import functools
import os
import time as _time

from .faults import SITES, FaultPlan, FaultyEngine, InjectedFault

__all__ = ["SITES", "FaultPlan", "FaultyEngine", "InjectedFault",
           "retry_under_load"]


def retry_under_load(fn=None, attempts=3):
    """Decorator for LOAD-flaky tests: ones that pass alone but can
    time out or miss a wall-clock bound when the full tier-1 run has
    every core busy (multiprocess workers starving behind the suite,
    watchdog/backoff timing asserted under a multi-replica router's
    thread load). Retry a couple of times with backoff; if the
    failure persists WHILE the box is demonstrably overloaded, xfail
    with the evidence instead of polluting the tier-1 signal — on an
    idle box the failure still fails loudly (a real regression must
    not hide behind the load excuse)."""
    if fn is None:
        return functools.partial(retry_under_load, attempts=attempts)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        last = None
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:   # noqa: BLE001 - rethrown below
                last = e
                if attempt < attempts - 1:
                    _time.sleep(0.5 * (attempt + 1))
        load = os.getloadavg()[0] if hasattr(os, "getloadavg") else 0.0
        ncpu = os.cpu_count() or 1
        if load > ncpu:
            # imported only on the overloaded-box escape hatch: the
            # happy path (and a real failure on an idle box) must not
            # make pytest a runtime dependency of this shipped package
            import pytest

            pytest.xfail(
                f"load-flaky test failed {attempts}x under load "
                f"(loadavg {load:.1f} > {ncpu} cpus): {last!r}")
        raise last

    return wrapper
