"""Creation ops (port of ``paddle_tpu/ops/creation.py``): new tensors on
the current place (``set_device``), in the default dtype unless a dtype is
given."""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from ..core import dtype as dtypes
from ..core.place import resolve_device
from ..core.tensor import to_tensor
from ._helpers import dtype_or_default, shape_arg, tensor

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
           "diag", "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
           "to_tensor", "tril_indices", "triu_indices", "one_hot", "complex",
           "polar", "create_tensor"]


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None):
    return torch.zeros(shape_arg(shape), dtype=dtype_or_default(dtype),
                       device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(shape_arg(shape), dtype=dtype_or_default(dtype),
                      device=resolve_device())


def _fill_dtype(fill_value):
    """The dtype a fill value takes where none is named: bool, int64, the
    default float dtype or complex64."""
    if isinstance(fill_value, torch.Tensor):
        return fill_value.dtype
    if isinstance(fill_value, builtins.bool):
        return torch.bool
    if isinstance(fill_value, int):
        return torch.int64
    if isinstance(fill_value, builtins.complex):
        return torch.complex64
    return dtypes.get_default_dtype()


def full(shape, fill_value, dtype=None, name=None):
    d = dtypes.convert_dtype(dtype) or _fill_dtype(fill_value)
    return torch.full(shape_arg(shape), _scalar(fill_value), dtype=d,
                      device=resolve_device())


def empty(shape, dtype=None, name=None):
    return torch.empty(shape_arg(shape), dtype=dtype_or_default(dtype),
                       device=resolve_device())


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(tensor(x), dtype=dtypes.convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(tensor(x), dtype=dtypes.convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(tensor(x), _scalar(fill_value),
                           dtype=dtypes.convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return torch.empty_like(tensor(x), dtype=dtypes.convert_dtype(dtype))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    d = dtypes.convert_dtype(dtype)
    if d is None:
        d = (torch.int64 if builtins.all(isinstance(v, int)
                                         for v in (start, end, step))
             else dtypes.get_default_dtype())
    return torch.arange(start, end, step, dtype=d, device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=dtype_or_default(dtype),
                          device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          base=base, dtype=dtype_or_default(dtype),
                          device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=dtype_or_default(dtype),
                     device=resolve_device())


def diag(x, offset=0, padding_value=0, name=None):
    x = tensor(x)
    if x.dim() == 1 and padding_value != 0:
        n = x.shape[0] + abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        return base + torch.diag(x - padding_value, offset)
    return torch.diag(x, offset)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(tensor(x), offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(tensor(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(tensor(x), diagonal)


def meshgrid(*args, **kwargs):
    arrs = (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
            else args)
    return list(torch.meshgrid(*[tensor(a) for a in arrs], indexing="ij"))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, an array or a number); with ``output``,
    ``x`` is written into it and ``output`` returned."""
    if output is not None:
        with torch.no_grad():
            output.copy_(tensor(x, like=output))
        return output
    return x.clone() if isinstance(x, torch.Tensor) else to_tensor(x)


def clone(x, name=None):
    return tensor(x).clone()


def tril_indices(row, col, offset=0, dtype=dtypes.int64):
    return torch.tril_indices(row, col, offset,
                              dtype=dtypes.convert_dtype(dtype),
                              device=resolve_device())


def triu_indices(row, col=None, offset=0, dtype=dtypes.int64):
    return torch.triu_indices(row, row if col is None else col, offset,
                              dtype=dtypes.convert_dtype(dtype),
                              device=resolve_device())


def one_hot(x, num_classes, name=None):
    return F.one_hot(tensor(x).long(), num_classes).to(
        dtypes.get_default_dtype())


def complex(real, imag, name=None):
    return torch.complex(tensor(real), tensor(imag))


def polar(abs, angle, name=None):
    """abs * e^(i angle)."""
    return torch.polar(tensor(abs), tensor(angle))


def create_tensor(dtype, name=None, persistable=False):
    return torch.zeros((0,), dtype=dtypes.convert_dtype(dtype),
                       device=resolve_device())
