"""Shape and layout manipulation (port of ``paddle_tpu/ops/manipulation.py``).

Paddle's meanings win over torch functions of the same name:
``gather(x, index, axis)`` selects along ``axis`` (``index_select``, not
``torch.gather``), ``split`` takes a number of sections or a list of sizes
with one ``-1``, ``pad`` with a list covering every dim pads the first dim
first (else the spatial dims by ``data_format``, last dim first), and
``transpose`` takes a whole permutation.
"""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from ..core import dtype as dtypes
from ._helpers import axis_arg, inplace_guard, shape_arg, tensor

__all__ = ["reshape", "reshape_", "flatten", "unflatten", "squeeze",
           "unsqueeze", "transpose", "moveaxis", "swapaxes", "concat",
           "stack", "unstack", "split", "chunk", "tensor_split", "tile",
           "expand", "expand_as", "broadcast_to", "broadcast_tensors",
           "flip", "rot90", "roll", "gather", "gather_nd", "scatter",
           "scatter_nd_add", "scatter_nd", "index_select", "index_sample",
           "index_add", "index_put", "take_along_axis", "put_along_axis",
           "slice", "strided_slice", "crop", "pad", "unbind",
           "repeat_interleave", "as_strided", "view", "view_as", "unfold",
           "masked_fill", "where", "numel", "shard_index", "cast", "take",
           "diagonal", "reverse", "vsplit", "as_complex", "as_real",
           "broadcast_shape", "rank", "shape", "index_fill", "index_fill_"]


def _long(i):
    return tensor(i).long()


def _index(i):
    """An index of index_put: bool masks as they are, others as int64."""
    i = tensor(i)
    return i if i.dtype == torch.bool else i.long()


def reshape(x, shape, name=None):
    return torch.reshape(tensor(x), shape_arg(shape))


def reshape_(x, shape, name=None):
    """Reshape the contiguous tensor ``x`` in place (its view changes);
    returns ``x``."""
    if not x.is_contiguous():
        raise ValueError("reshape_ needs a contiguous tensor")
    new = x.detach().reshape(shape_arg(shape))
    with inplace_guard(x):
        x.as_strided_(new.shape, new.stride(), x.storage_offset())
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return torch.flatten(tensor(x), start_axis, stop_axis)


def unflatten(x, axis, shape, name=None):
    return torch.unflatten(tensor(x), axis, shape_arg(shape))


def _squeeze_dims(v, axis):
    ax = axis_arg(axis)
    if ax is None:
        return tuple(d for d in range(v.dim()) if v.shape[d] == 1)
    ax = ax if isinstance(ax, tuple) else (ax,)
    return tuple(a % v.dim() for a in ax if v.shape[a] == 1)


def squeeze(x, axis=None, name=None):
    v = tensor(x)
    return torch.squeeze(v, _squeeze_dims(v, axis))


def _unsqueeze_dims(v, axis):
    ax = axis_arg(axis)
    ax = ax if isinstance(ax, tuple) else (ax,)
    nd = v.dim() + len(ax)
    return sorted(a % nd for a in ax)


def unsqueeze(x, axis, name=None):
    v = tensor(x)
    for a in _unsqueeze_dims(v, axis):
        v = torch.unsqueeze(v, a)
    return v


def transpose(x, perm=None, name=None):
    v = tensor(x)
    p = tuple(range(v.dim() - 1, -1, -1)) if perm is None else tuple(
        int(a) for a in perm)
    return torch.permute(v, p)


def moveaxis(x, source, destination, name=None):
    return torch.movedim(tensor(x), source, destination)


def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(tensor(x), int(axis1), int(axis2))


def concat(x, axis=0, name=None):
    return torch.cat([tensor(t) for t in x], int(axis))


def stack(x, axis=0, name=None):
    return torch.stack([tensor(t) for t in x], int(axis))


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(tensor(x), axis))


def split(x, num_or_sections, axis=0, name=None):
    """Split along ``axis`` into ``num_or_sections`` equal parts (the dim
    must divide), or into parts of the listed sizes, one of which may be
    -1 (the rest)."""
    v = tensor(x)
    ax = int(axis)
    dim = v.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dimension {dim} along axis {ax} is not evenly "
                f"divisible by {num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = [int(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sections) if s < 0]
        if neg:
            sections[neg[0]] = dim - builtins.sum(s for s in sections
                                                  if s >= 0)
    return list(torch.split(v, sections, ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    return list(torch.tensor_split(tensor(x), num_or_indices, int(axis)))


def tile(x, repeat_times, name=None):
    return torch.tile(tensor(x), shape_arg(repeat_times))


def expand(x, shape, name=None):
    v = tensor(x)
    s = shape_arg(shape)
    lead = len(s) - v.dim()
    tgt = tuple(v.shape[i - lead] if d == -1 else d for i, d in enumerate(s))
    return v.expand(tgt)


def expand_as(x, y, name=None):
    return torch.broadcast_to(tensor(x), tensor(y).shape)


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(tensor(x), shape_arg(shape))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*[tensor(t) for t in inputs]))


def flip(x, axis, name=None):
    ax = axis_arg(axis)
    return torch.flip(tensor(x), ax if isinstance(ax, tuple) else (ax,))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(tensor(x), k, list(axes))


def roll(x, shifts, axis=None, name=None):
    return torch.roll(tensor(x), shifts, axis)


def gather(x, index, axis=0, name=None):
    """Rows of ``x`` along ``axis`` at ``index`` (``index_select``); a
    0-d index drops the dim, an index of rank > 1 is flattened."""
    v, i = tensor(x), _long(index)
    ax = int(axis)
    if i.dim() == 0:
        return torch.select(v, ax, int(i))
    return torch.index_select(v, ax, i.reshape(-1))


def _nd(index):
    """An index of shape [..., k] as the tuple of its k coordinate
    tensors."""
    return tuple(torch.movedim(_long(index), -1, 0))


def gather_nd(x, index, name=None):
    return tensor(x)[_nd(index)]


def scatter(x, index, updates, overwrite=True, name=None):
    v, i, u = tensor(x), _long(index).reshape(-1), tensor(updates)
    if overwrite:
        return v.index_put((i,), u)
    zeroed = v.index_put((i,), torch.zeros_like(u))
    return zeroed.index_put((i,), u, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return tensor(x).index_put(_nd(index), tensor(updates), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    u = tensor(updates)
    z = torch.zeros(shape_arg(shape), dtype=u.dtype, device=u.device)
    return z.index_put(_nd(index), u, accumulate=True)


def index_select(x, index, axis=0, name=None):
    return torch.index_select(tensor(x), int(axis), _long(index))


def index_sample(x, index, name=None):
    return torch.gather(tensor(x), 1, _long(index))


def index_add(x, index, axis, value, name=None):
    return tensor(x).index_add(axis, _long(index), tensor(value))


def index_put(x, indices, value, accumulate=False, name=None):
    v = tensor(x)
    return v.index_put(tuple(_index(i) for i in indices),
                       tensor(value, like=v).to(v.dtype), accumulate)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return torch.take_along_dim(tensor(arr), _long(indices), int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    v, i = tensor(arr), _long(indices)
    ax = int(axis) % v.dim()
    u = tensor(values, like=v).to(v.dtype)
    u = torch.broadcast_to(u, i.shape).contiguous()
    if reduce == "add":
        return v.scatter_add(ax, i, u)
    if reduce in ("multiply", "mul"):
        return v.scatter_reduce(ax, i, u, "prod")
    return v.scatter(ax, i, u)


def slice(input, axes, starts, ends, name=None):
    v = tensor(input)
    idx = [builtins.slice(None)] * v.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[int(a)] = builtins.slice(int(s), int(e))
    return v[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis, negative strides included."""
    v = tensor(x)
    for a, s, e, st in zip(axes, starts, ends, strides):
        a = int(a)
        picked = range(v.shape[a])[builtins.slice(int(s), int(e), int(st))]
        v = torch.index_select(v, a, torch.tensor(list(picked),
                                                  dtype=torch.long,
                                                  device=v.device))
    return v


def crop(x, shape=None, offsets=None, name=None):
    v = tensor(x)
    s = shape_arg(shape)
    offs = [0] * len(s) if offsets is None else [int(o) for o in offsets]
    return v[tuple(builtins.slice(o, o + (d if d != -1 else v.shape[i] - o))
                   for i, (o, d) in enumerate(zip(offs, s)))]


def _pad_index(n, lo, hi, mode, device):
    """The source positions of a dim of size n padded by (lo, hi)."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return pos.clamp(0, n - 1)
    if mode == "circular":
        return pos.remainder(n)
    period = 2 * (n - 1)                      # reflect, the edge not repeated
    r = pos.abs().remainder(period) if period else torch.zeros_like(pos)
    return torch.where(r >= n, period - r, r)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's pad. A list of 2 * ndim pads gives (before, after) for every
    dim, the first dim first; a shorter one pads the spatial dims of
    ``data_format`` (after the batch dim for the channels-last formats,
    else the last ones), in its order."""
    v = tensor(x)
    p = [int(a) for a in pad]
    nd = v.dim()
    if len(p) == 2 * nd:
        width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        width = [(0, 0)] * nd
        npairs = len(p) // 2
        if data_format.endswith("HWC") or data_format in ("NLC", "NDHWC",
                                                           "NHWC"):
            spatial = list(range(1, 1 + npairs))
        else:
            spatial = list(range(nd - npairs, nd))
        for k, axis_i in enumerate(spatial):
            width[axis_i] = (p[2 * k], p[2 * k + 1])
    if mode == "constant":
        flat = [w for lo_hi in reversed(width) for w in lo_hi]
        return F.pad(v, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            v = torch.index_select(v, d, _pad_index(v.shape[d], lo, hi, mode,
                                                    v.device))
    return v


def unbind(input, axis=0, name=None):
    return unstack(input, axis=axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(tensor(x), repeats, axis)


def as_strided(x, shape, stride, offset=0, name=None):
    """The reference has no strided views (XLA has none) and raises; the
    port keeps its behaviour."""
    raise NotImplementedError(
        "as_strided has no XLA equivalent; use reshape/slice/unfold")


def view(x, shape_or_dtype, name=None):
    """A reshape for a shape; for a dtype, the bits reinterpreted (a
    narrower dtype adds a last dim of the size ratio, a wider one drops a
    last dim of that size), as ``lax.bitcast_convert_type``."""
    v = tensor(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(v, shape_or_dtype)
    d = dtypes.convert_dtype(shape_or_dtype)
    old, new = v.element_size(), torch.empty((), dtype=d).element_size()
    if old == new:
        return v.view(d)
    if old > new:
        return v.view(d).reshape(*v.shape, old // new)
    return v.contiguous().view(d).reshape(v.shape[:-1])


def view_as(x, other, name=None):
    return reshape(x, tensor(other).shape)


def unfold(x, axis, size, step, name=None):
    return tensor(x).unfold(axis, size, step)


def masked_fill(x, mask, value, name=None):
    v = tensor(x)
    val = tensor(value, like=v).to(v.dtype)
    return torch.where(tensor(mask), val, v)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        from .search import nonzero

        return nonzero(condition, as_tuple=True)
    return torch.where(tensor(condition), x, y)


def numel(x, name=None):
    v = tensor(x)
    return torch.tensor(v.numel(), dtype=torch.int64, device=v.device)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Remap vocabulary indices to shard ``shard_id``'s local range;
    others become ``ignore_value``."""
    i = tensor(input)
    shard_size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * shard_size, (shard_id + 1) * shard_size
    return torch.where((i >= lo) & (i < hi), i - lo,
                       torch.full_like(i, ignore_value))


def cast(x, dtype):
    return tensor(x).to(dtypes.convert_dtype(dtype))


def take(x, index, mode="raise", name=None):
    """Flat-index gather: ``x`` read as 1-D."""
    v, i = tensor(x), _long(index)
    n = v.numel()
    if mode == "wrap":
        i = ((i % n) + n) % n
    elif mode == "clip":
        i = torch.clamp(i, 0, n - 1)
    return torch.take(v, i)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(tensor(x), offset, axis1, axis2)


def reverse(x, axis, name=None):
    return flip(x, axis)


def vsplit(x, num_or_sections, name=None):
    return split(x, num_or_sections, axis=0)


def as_complex(x, name=None):
    """[..., 2] real as complex."""
    v = tensor(x)
    return torch.complex(v[..., 0], v[..., 1])


def as_real(x, name=None):
    """complex as [..., 2] real."""
    v = tensor(x)
    imag = torch.imag(v) if v.is_complex() else torch.zeros_like(v)
    return torch.stack([torch.real(v), imag], -1)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def rank(input, name=None):
    v = tensor(input)
    return torch.tensor(v.dim(), dtype=torch.int64, device=v.device)


def shape(input, name=None):
    v = tensor(input)
    return torch.tensor(list(v.shape), dtype=torch.int64, device=v.device)


def index_fill(x, index, axis, value, name=None):
    """Fill the entries at ``index`` along ``axis`` with ``value``."""
    v = tensor(x)
    val = value if isinstance(value, torch.Tensor) else torch.tensor(
        value, dtype=v.dtype, device=v.device)
    return torch.index_fill(v, int(axis), _long(index), val.to(v.dtype))


def index_fill_(x, index, axis, value, name=None):
    with inplace_guard(x):
        x.copy_(index_fill(x, index, axis, value))
    return x
