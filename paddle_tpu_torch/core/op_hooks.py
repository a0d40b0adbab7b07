"""Op-dispatch instrumentation point (port of ``paddle_tpu/core/op_hooks.py``).

The reference emits RecordEvent spans inside every generated ad_func
(eager_gen.py:1097-1098); the JAX package's single choke point is
``apply_op``, the port's is the record point (``core/dispatch.py``), which
calls ``op_span_hook(name, start_ns, end_ns)`` when one is installed.
None = zero overhead. Two consumers exist, the profiler (trace spans) and
the monitor (latency histograms), and both install by saving the previous
hook and chaining to it, so they compose in either order.

Assigning the slot also tells the record point (``dispatch.sync``), which
puts its mode on torch's stack of the assigning thread while a hook is
installed and takes it off when the slot goes back to None.
"""
from __future__ import annotations

import sys
import types
from typing import Callable, Optional

op_span_hook: Optional[Callable[[str, int, int], None]] = None

# Chain protocol shared by the consumers: a hook that saves the previous
# slot value and forwards to it exposes it as ``hook.prev_hook``; a hook
# that can go permanently dead (a stopped profiler window stranded under
# another consumer) flags itself with ``hook.armed = False``. Installers
# and restorers prune dead links with skip_dead so chains never regrow
# across profile/monitor interleaves.


def skip_dead(hook):
    """Follow ``prev_hook`` links past hooks whose ``armed`` flag is
    False; returns the first live hook (or None)."""
    while hook is not None and not getattr(hook, "armed", True):
        hook = getattr(hook, "prev_hook", None)
    return hook


class _Slot(types.ModuleType):
    """This module, with ``op_span_hook`` assignments passed on to the
    record point."""

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name == "op_span_hook":
            from . import dispatch

            dispatch.sync()


sys.modules[__name__].__class__ = _Slot
