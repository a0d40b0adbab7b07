"""Carry a ``paddle_tpu`` (JAX) model's weights into the port.

The JAX side exports them as plain numpy arrays::

    named = {k: np.asarray(p.value) for k, p in model.named_parameters()}

and because the port keeps the reference's parameter names and layouts
(linear weights ``[in, out]``), loading is an identity up to the dtype.
Weights of the reference's scan-over-layers training
(``paddle_tpu/models/llama_functional.py::stack_params``: per-layer
parameters stacked into leading-[L] arrays, the rest by name) load through
:func:`load_stacked_params`.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_paddle_params", "load_stacked_params"]

# the reference's per-layer parameter names (llama_functional._LAYER_RE)
_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")


@torch.no_grad()
def load_paddle_params(model: nn.Module, named: Dict[str, np.ndarray]) -> None:
    """Fill ``model``'s parameters from ``named`` (name -> array), cast to
    each parameter's dtype and device. Raises on a missing, unexpected or
    mis-shaped name; nothing is written unless every name matches."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named))
    unexpected = sorted(set(named) - set(params))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    bad = [f"{k}: {tuple(np.shape(a))} != {tuple(params[k].shape)}"
           for k, a in named.items() if tuple(np.shape(a)) != tuple(params[k].shape)]
    if bad:
        raise ValueError("parameter shapes differ: " + "; ".join(bad))
    for k, a in named.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":      # numpy has no bf16 of its own
            a = a.astype(np.float32)
        p = params[k]
        p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))  # a writable copy


def load_stacked_params(model: nn.Module, stacked: Dict[str, np.ndarray],
                        rest: Dict[str, np.ndarray]) -> None:
    """Fill ``model`` from the reference's stacked training parameters:
    ``stacked[K]`` holds layer i's ``model.layers.i.K`` at index i of its
    leading dim, ``rest`` every other parameter by name. Raises as
    :func:`load_paddle_params` does on a missing, unexpected or mis-shaped
    name (a stack of the wrong depth gives missing or unexpected layer
    names), and on a per-layer name in ``rest``."""
    strays = sorted(k for k in rest if _LAYER_RE.match(k))
    if strays:
        raise KeyError(f"per-layer names belong in the stacked dict, found "
                       f"in rest: {strays}")
    named = dict(rest)
    for k, a in stacked.items():
        a = np.asarray(a)
        if a.ndim == 0:
            raise ValueError(f"stacked parameter {k} has no layer dim")
        for i in range(a.shape[0]):
            named[f"model.layers.{i}.{k}"] = a[i]
    load_paddle_params(model, named)
