"""Carry a ``paddle_tpu`` (JAX) model's weights into the port.

The JAX side exports them as plain numpy arrays::

    named = {k: np.asarray(p.value) for k, p in model.named_parameters()}

and because the port keeps the reference's parameter names and layouts
(linear weights ``[in, out]``), loading is an identity up to the dtype.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_paddle_params"]


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
