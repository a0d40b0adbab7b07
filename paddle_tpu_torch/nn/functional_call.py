"""``functional_call``: run a layer's forward with other parameter values
(port of ``paddle_tpu/nn/functional_call.py``).

:func:`substituted_state` swaps the tensors in the layer's (and its
sublayers') ``_parameters`` / ``_buffers`` for the given ones for the
length of a ``with`` block, then restores them. Gradients flow to the
substituted tensors through torch's autograd, so a layer becomes a function
of ``(params, buffers, inputs)``; the reference runs the forward without
its tape and returns raw arrays because JAX differentiates from outside,
here the outputs are tensors in the caller's graph.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

__all__ = ["functional_call", "substituted_state"]


def _slots(layer, names, store):
    """{name: (sublayer's store dict, key)} for dotted ``names``; a name
    that is not among the layer's raises ``KeyError``."""
    known = dict(layer.named_parameters() if store == "_parameters"
                 else layer.named_buffers())
    unknown = set(names) - set(known)
    if unknown:
        kind = "parameters" if store == "_parameters" else "buffers"
        raise KeyError(f"{kind} keys not found in layer.named_{kind}(): "
                       f"{sorted(unknown)[:5]}")
    out = {}
    for name in names:
        mod_path, _, key = name.rpartition(".")
        mod = layer.get_submodule(mod_path) if mod_path else layer
        out[name] = (getattr(mod, store), key)
    return out


@contextlib.contextmanager
def substituted_state(layer, params: Optional[Dict[str, Any]] = None,
                      buffers: Optional[Dict[str, Any]] = None):
    swaps = []
    for values, store in ((params, "_parameters"), (buffers, "_buffers")):
        if values:
            for name, (d, key) in _slots(layer, values, store).items():
                swaps.append((d, key, d[key]))
                d[key] = values[name]
    try:
        yield layer
    finally:
        for d, key, old in reversed(swaps):
            d[key] = old


def functional_call(layer, params: Optional[Dict[str, Any]], *args,
                    buffers: Optional[Dict[str, Any]] = None, **kwargs):
    """``layer(*args, **kwargs)`` with parameter values from ``params``
    (keyed as ``named_parameters``) and buffers from ``buffers``."""
    with substituted_state(layer, params, buffers):
        return layer(*args, **kwargs)
