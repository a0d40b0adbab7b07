"""Search and sort (port of ``paddle_tpu/ops/search.py``).

Index outputs are ``int64`` (``argmax``, ``argsort``, ``topk``,
``nonzero``, ...). Ties follow the reference: sorts are stable (equal
values keep their order, descending too), ``topk`` and ``kthvalue`` pick
among equal values by position, ``mode`` returns the smallest of the most
frequent values and the index of its first occurrence, and ``unique``
returns (values, index, inverse, counts) as ``jnp.unique`` orders them.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ._helpers import tensor

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "nonzero",
           "masked_select", "searchsorted", "kthvalue", "mode", "unique",
           "unique_consecutive", "bucketize"]


def _arg(fn, x, axis, keepdim, dtype):
    v = tensor(x)
    if axis is None:
        out = fn(v.reshape(-1), 0)
    else:
        out = fn(v, int(axis), keepdim=keepdim)
    return out.to(dtypes.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(tensor(x), dim=axis, descending=descending,
                      stable=True).indices


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(tensor(x), dim=axis, descending=descending,
                      stable=True).values


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """The k largest (smallest) values along ``axis`` and their indices;
    among equal values the lower index first."""
    s = torch.sort(tensor(x), dim=int(axis), descending=largest, stable=True)
    k = int(k)
    return s.values.narrow(int(axis), 0, k), s.indices.narrow(int(axis), 0, k)


def nonzero(x, as_tuple=False, name=None):
    v = tensor(x)
    if as_tuple:
        return tuple(torch.nonzero(v, as_tuple=True))
    return torch.nonzero(v)


def masked_select(x, mask, name=None):
    return torch.masked_select(tensor(x), tensor(mask))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(tensor(sorted_sequence), tensor(values),
                              out_int32=out_int32, right=right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The k-th smallest value along ``axis`` and its index (stable order
    among equal values)."""
    ax = int(axis)
    s = torch.sort(tensor(x), dim=ax, stable=True)
    vals = s.values.select(ax, k - 1)
    idx = s.indices.select(ax, k - 1)
    if keepdim:
        return vals.unsqueeze(ax), idx.unsqueeze(ax)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of several) and
    the index of its first occurrence."""
    v = tensor(x)
    ax = int(axis)
    u = torch.movedim(v, ax, -1).contiguous()
    s = torch.sort(u, dim=-1).values
    counts = (torch.searchsorted(s, s, right=True)
              - torch.searchsorted(s, s, right=False))
    best = torch.argmax(counts, -1, keepdim=True)
    out = torch.gather(s, -1, best)
    idx = torch.argmax((u == out).to(torch.uint8), -1)
    out = out.squeeze(-1)
    if keepdim:
        return out.unsqueeze(ax), idx.unsqueeze(ax)
    return out, idx


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values; with the flags also the index of each
    one's first occurrence, the inverse and the counts, in that order."""
    v = tensor(x)
    u, inv, counts = torch.unique(v, sorted=True, return_inverse=True,
                                  return_counts=True, dim=axis)
    outs = [u]
    if return_index:
        n = v.shape[axis] if axis is not None else v.numel()
        flat_inv = inv.reshape(-1)
        pos = torch.arange(n, device=v.device)
        first = torch.full((u.shape[0] if axis is None else u.shape[axis],),
                           n, dtype=torch.int64, device=v.device)
        outs.append(first.scatter_reduce(0, flat_inv, pos, "amin"))
    if return_inverse:
        outs.append(inv)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    v = tensor(x)
    return torch.unique_consecutive(
        v.reshape(-1) if axis is None else v, return_inverse=return_inverse,
        return_counts=return_counts, dim=axis)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    """The bucket of each value in the 1-D ``sorted_sequence``
    (``searchsorted`` with the sides swapped in argument order)."""
    return torch.searchsorted(tensor(sorted_sequence), tensor(x),
                              out_int32=out_int32, right=right)
