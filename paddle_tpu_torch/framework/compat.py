"""Small top-level APIs of paddle (port of
``paddle_tpu/framework/compat.py``): ``batch``, ``LazyGuard``,
``check_shape``, ``set_printoptions``, ``tolist``, ``dtype`` and the
function forms of the in-place ops, which act in place on the torch tensor
(on a leaf that needs a gradient outside the graph, as the reference)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import manipulation as _manip
from ..ops._helpers import axis_arg, inplace_guard, tensor

__all__ = ["batch", "LazyGuard", "check_shape", "disable_signal_handler",
           "set_printoptions", "tolist", "dtype", "pow_", "scatter_",
           "index_add_", "index_put_", "squeeze_", "tanh_", "unsqueeze_"]

# paddle.dtype is the type of dtype objects
dtype = torch.dtype


def batch(reader, batch_size, drop_last=False):
    """Legacy batched-reader decorator (python/paddle/batch.py)."""

    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


class LazyGuard:
    """Paddle defers parameter initialization inside this scope; the port
    initializes eagerly, so the guard changes nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def check_shape(shape):
    """Validate a shape argument (static-graph helper)."""
    for s in list(shape):
        if not isinstance(s, (int, np.integer)) and not hasattr(s, "dtype"):
            raise TypeError(f"shape entries must be int, got {type(s)}")


def disable_signal_handler():
    """Paddle unhooks its C++ signal handlers; the port installs none."""
    return None


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor print formatting, torch's."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def tolist(x):
    return tensor(x).tolist()


def pow_(x, y):
    with inplace_guard(x):
        x.pow_(y)
    return x


def tanh_(x):
    with inplace_guard(x):
        x.tanh_()
    return x


def scatter_(x, index, updates, overwrite=True):
    """paddle.scatter (rows of ``x`` at ``index`` overwritten or summed),
    in place."""
    with inplace_guard(x):
        x.copy_(_manip.scatter(x, index, updates, overwrite))
    return x


def index_add_(x, index, axis, value):
    with inplace_guard(x):
        x.index_add_(axis, tensor(index).long(), tensor(value))
    return x


def index_put_(x, indices, value, accumulate=False):
    with inplace_guard(x):
        x.copy_(_manip.index_put(x, indices, value, accumulate))
    return x


def squeeze_(x, axis=None):
    with inplace_guard(x):
        x.squeeze_(_manip._squeeze_dims(x, axis))
    return x


def unsqueeze_(x, axis):
    with inplace_guard(x):
        for a in _manip._unsqueeze_dims(x, axis_arg(axis)):
            x.unsqueeze_(a)
    return x
