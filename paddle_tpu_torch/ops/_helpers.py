"""Argument normalization of the tensor surface's ops: shapes, axes,
dtypes, devices and operands that are not tensors (the port's own copy of
what ``paddle_tpu/ops/_helpers.py`` and the reference op modules do
inline)."""
from __future__ import annotations

import builtins
import contextlib

import torch

from ..core import dtype as dtypes
from ..core.place import resolve_device
from ..core.tensor import to_tensor


def shape_arg(shape) -> tuple:
    """A shape given as an int, a list of ints or 0-d tensors, or a 1-D
    tensor, as a tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def axis_arg(axis):
    """An axis given as None, an int, a list or a tensor: None, an int or a
    tuple of ints."""
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return None if axis is None else int(axis)


def dims(x: torch.Tensor, axis) -> tuple:
    """``axis_arg(axis)`` as a tuple of dims, every dim for None."""
    ax = axis_arg(axis)
    if ax is None:
        return tuple(range(x.dim()))
    return ax if isinstance(ax, tuple) else (ax,)


def dtype_or_default(dtype):
    d = dtypes.convert_dtype(dtype)
    return dtypes.get_default_dtype() if d is None else d


def device_of(*xs) -> torch.device:
    """The device of the first tensor among ``xs``, else the current
    place."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device()


def tensor(x, like=None) -> torch.Tensor:
    """``x`` as a tensor: tensors as they are; a python scalar as a 0-d
    tensor on ``like``'s device (numbers keep torch's scalar rules when
    they meet a tensor); anything else through ``to_tensor``."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (builtins.bool, int, float, complex)) and \
            isinstance(like, torch.Tensor):
        return torch.tensor(x, device=like.device).to(
            torch.result_type(like, x))
    return to_tensor(x, place=device_of(like))


def both(x, y):
    """The two operands of a binary op as tensors on one device."""
    if not isinstance(x, torch.Tensor):
        y = tensor(y)
        return tensor(x, like=y), y
    return x, tensor(y, like=x)


def moved_last(x: torch.Tensor, axis) -> tuple:
    """``x`` with ``axis`` (an int or a tuple, None for all) flattened into
    one last dim, and the shape the kept dims have."""
    ds = tuple(sorted(d % max(x.dim(), 1) for d in dims(x, axis)))
    keep = [d for d in range(x.dim()) if d not in ds]
    moved = x.permute(*keep, *ds) if x.dim() else x.reshape(1)
    kept_shape = tuple(x.shape[d] for d in keep)
    return moved.reshape(*kept_shape, -1), kept_shape, ds


def inplace_guard(x: torch.Tensor):
    """The context of an in-place op on ``x``. On a leaf that needs a
    gradient the op replaces the value outside the graph, as the
    reference's in-place ops do (torch would refuse it); elsewhere torch
    records the op in the graph."""
    if x.is_leaf and x.requires_grad:
        return torch.no_grad()
    return contextlib.nullcontext()
