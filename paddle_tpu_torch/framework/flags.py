"""Flag registry: port of ``paddle_tpu/framework/flags.py``.

A typed registry whose defaults a ``FLAGS_*`` environment variable
overrides, parsed by the type of the default as the JAX package does.
Only the flags the port reads are defined: ``FLAGS_flash_head_batched``
(the head-batched flash route), ``FLAGS_enable_monitor`` (the metrics
registry, ``paddle_tpu_torch.monitor``), ``FLAGS_enable_trace`` (the
request trace ring, ``paddle_tpu_torch.tracing``), ``FLAGS_enable_ledger``
(the program ledger, ``paddle_tpu_torch.monitor.ledger``) and
``FLAGS_check_nan_inf`` (the ops' post-op nan/inf check,
``framework/amp_state.py``); :func:`set_flags` pushes the last four to
their modules, as the reference's does (the check to the calling thread's
amp state). Unknown flags are accepted and stored, so scripts written
against the reference's ``set_flags`` keep working, but nothing reads them:
the reference's other flags (``FLAGS_use_pallas_kernels`` and the rest)
have no effect here.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Union

__all__ = ["get_flags", "set_flags", "define_flag"]

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default, help_: str = ""):
    """Register ``name`` with ``default``, or with the value of the
    environment variable of that name parsed as the default's type
    (bool: "1", "true" or "yes" in any case is True)."""
    env = os.environ.get(name)
    if env is not None:
        if isinstance(default, bool):
            default = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            default = int(env)
        elif isinstance(default, float):
            default = float(env)
        else:
            default = env
    _REGISTRY[name] = default
    return default


# the flags the port reads, with the reference's defaults; the reference's
# other flags are defined by the slices that come to read them
define_flag("FLAGS_flash_head_batched", False)    # ops/attention.py
define_flag("FLAGS_enable_monitor", False)        # monitor/__init__.py
define_flag("FLAGS_enable_trace", False)          # tracing/__init__.py
define_flag("FLAGS_check_nan_inf", False)         # framework/amp_state.py
define_flag("FLAGS_enable_ledger", False)         # monitor/ledger.py


def get_flags(flags: Union[str, List[str]]) -> Dict[str, Any]:
    """``{name: value}`` for one name or a list of names (None where a
    name was never set)."""
    if isinstance(flags, str):
        flags = [flags]
    return {f: _REGISTRY.get(f) for f in flags}


def set_flags(flags: Dict[str, Any]) -> None:
    """Store every ``name: value`` of ``flags``, and push
    ``FLAGS_enable_monitor`` / ``FLAGS_enable_trace`` /
    ``FLAGS_enable_ledger`` to the monitor, the trace ring and the program
    ledger (their fast-path bools) and ``FLAGS_check_nan_inf`` to this
    thread's amp state."""
    for k, v in flags.items():
        _REGISTRY[k] = v
    if "FLAGS_enable_monitor" in flags:
        from ..monitor import _sync_enabled

        _sync_enabled(bool(flags["FLAGS_enable_monitor"]))
    if "FLAGS_enable_trace" in flags:
        from ..tracing import _sync_enabled as _sync_trace

        _sync_trace(bool(flags["FLAGS_enable_trace"]))
    if "FLAGS_check_nan_inf" in flags:
        from .amp_state import amp_state

        amp_state.check_nan_inf = bool(flags["FLAGS_check_nan_inf"])
    if "FLAGS_enable_ledger" in flags:
        from ..monitor.ledger import _sync_enabled as _sync_ledger

        _sync_ledger(bool(flags["FLAGS_enable_ledger"]))
