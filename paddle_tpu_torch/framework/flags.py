"""Flag registry: port of ``paddle_tpu/framework/flags.py``.

A typed registry whose defaults a ``FLAGS_*`` environment variable
overrides, parsed by the type of the default as the JAX package does.
Only the flags the port reads are defined (``FLAGS_flash_head_batched``,
the head-batched flash route). Unknown flags are accepted and stored, so
scripts written against the reference's ``set_flags`` keep working, but
nothing reads them: the reference's other flags (``FLAGS_use_pallas_kernels``,
``FLAGS_check_nan_inf`` and the rest) have no effect here yet, and neither
have the side effects of its ``set_flags`` on the amp state, the monitor,
tracing and the ledger, modules the port does not have.
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


def get_flags(flags: Union[str, List[str]]) -> Dict[str, Any]:
    """``{name: value}`` for one name or a list of names (None where a
    name was never set)."""
    if isinstance(flags, str):
        flags = [flags]
    return {f: _REGISTRY.get(f) for f in flags}


def set_flags(flags: Dict[str, Any]) -> None:
    """Store every ``name: value`` of ``flags``."""
    for k, v in flags.items():
        _REGISTRY[k] = v
