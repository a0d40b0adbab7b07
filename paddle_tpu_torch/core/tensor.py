"""``Tensor``, ``to_tensor`` and ``is_tensor``.

Port of ``paddle_tpu/core/tensor.py``. The port's tensor is
``torch.Tensor`` itself: its methods are torch's, its autograd is torch's,
and nothing is attached to or rebound on it. Paddle's ``stop_gradient`` is
``not requires_grad``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtypes
from .place import resolve_device

__all__ = ["Tensor", "to_tensor", "is_tensor"]

Tensor = torch.Tensor


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> torch.Tensor:
    """paddle.to_tensor parity: a new tensor (never a view of ``data``) on
    ``place`` (default: the current place). Python floats take the default
    dtype and python ints ``int64``; arrays and tensors keep theirs unless
    ``dtype`` is given."""
    d = dtypes.convert_dtype(dtype)
    dev = resolve_device(place)
    if isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        arr = np.asarray(data)
        if d is None and not hasattr(data, "dtype"):
            if arr.dtype == np.float64:
                d = dtypes.get_default_dtype()
            elif arr.dtype == np.int64:
                d = dtypes.int64
        t = torch.from_numpy(np.array(arr, copy=True))
    out = t.to(device=dev, dtype=d, copy=True)
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)
