"""Comparisons and logical ops (port of ``paddle_tpu/ops/logic.py``). No
output carries a gradient."""
from __future__ import annotations

import torch

from ._helpers import both, tensor

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "equal_all", "allclose", "isclose",
           "logical_and", "logical_or", "logical_xor", "logical_not",
           "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
           "isnan", "isinf", "isfinite", "is_empty", "isin", "is_complex",
           "is_floating_point", "is_integer"]


def _binary(fn):
    def op(x, y, name=None):
        return fn(*both(x, y))
    return op


def _unary(fn):
    return lambda x, name=None: fn(tensor(x))


_BINARY = dict(
    equal=torch.eq, not_equal=torch.ne, greater_than=torch.gt,
    greater_equal=torch.ge, less_than=torch.lt, less_equal=torch.le,
    logical_and=torch.logical_and, logical_or=torch.logical_or,
    logical_xor=torch.logical_xor, bitwise_and=torch.bitwise_and,
    bitwise_or=torch.bitwise_or, bitwise_xor=torch.bitwise_xor)
for _n, _f in _BINARY.items():
    globals()[_n] = _binary(_f)
    globals()[_n].__name__ = _n

_UNARY = dict(logical_not=torch.logical_not, bitwise_not=torch.bitwise_not,
              isnan=torch.isnan, isinf=torch.isinf, isfinite=torch.isfinite)
for _n, _f in _UNARY.items():
    globals()[_n] = _unary(_f)
    globals()[_n].__name__ = _n


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, device=like.device)


def equal_all(x, y, name=None):
    """A 0-d bool tensor: same shape and every element equal."""
    x, y = both(x, y)
    return _flag(x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype))),
                 x)


def _same(x, y):
    x, y = both(x, y)
    d = torch.promote_types(x.dtype, y.dtype)
    return x.to(d), y.to(d)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _same(x, y)
    return _flag(torch.allclose(x, y, rtol, atol, equal_nan), x)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _same(x, y)
    return torch.isclose(x, y, rtol, atol, equal_nan)


def is_empty(x, name=None):
    v = tensor(x)
    return _flag(v.numel() == 0, v)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(tensor(x), tensor(test_x), assume_unique=assume_unique,
                      invert=invert)


def is_complex(x, name=None):
    return tensor(x).is_complex()


def is_floating_point(x, name=None):
    return tensor(x).is_floating_point()


def is_integer(x, name=None):
    v = tensor(x)
    return not (v.is_floating_point() or v.is_complex()
                or v.dtype == torch.bool)
