"""Datatype registry of the tensor surface.

Port of ``paddle_tpu/core/dtype.py``: paddle's dtype names and aliases are
``torch.dtype`` objects. The 64-bit names stay 64-bit here: ``int64`` is
torch's index type and ``float64`` computes in double precision (the JAX
package narrows them to 32 bits because XLA:TPU computes in 32 bits).

The default dtype (:func:`set_default_dtype`) is this package's own and
never calls ``torch.set_default_dtype``, so the engines' tensors do not
follow a user's default.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["float16", "bfloat16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "uint16", "uint32", "bool_",
           "complex64", "complex128", "FLOATING_DTYPES", "INTEGER_DTYPES",
           "convert_dtype", "dtype_name", "is_floating_point", "is_integer",
           "set_default_dtype", "get_default_dtype", "promote",
           "to_numpy_dtype", "finfo", "iinfo"]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int": int32,
    "int64": int64, "long": int64,
    "uint8": uint8, "uint16": uint16, "uint32": uint32,
    "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}
# python scalar types, as numpy reads them
_PY_TYPES = {float: float64, int: int64, bool: bool_, complex: complex128}

FLOATING_DTYPES = (float16, bfloat16, float32, float64)
INTEGER_DTYPES = (int8, int16, int32, int64, uint8, uint16, uint32)


def convert_dtype(dtype):
    """A dtype given as a name, a torch dtype, a numpy dtype or a python
    scalar type, as a ``torch.dtype`` (``None`` stays ``None``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise ValueError(f"Unknown dtype name: {dtype!r}") from None
    if dtype in _PY_TYPES:
        return _PY_TYPES[dtype]
    try:
        return _NAME_TO_DTYPE[np.dtype(dtype).name]
    except (TypeError, KeyError):
        raise ValueError(f"Unknown dtype: {dtype!r}") from None


def dtype_name(dtype) -> str:
    return str(convert_dtype(dtype)).removeprefix("torch.")


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in FLOATING_DTYPES


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d in INTEGER_DTYPES or d == bool_


_DEFAULT_DTYPE = [float32]


def set_default_dtype(dtype):
    """paddle.set_default_dtype parity: the dtype floats take where the
    caller names none (``to_tensor`` of python floats, creation and random
    ops). Floating dtypes only."""
    d = convert_dtype(dtype)
    if d not in FLOATING_DTYPES:
        raise TypeError(f"default dtype must be floating, got {d}")
    _DEFAULT_DTYPE[0] = d


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def promote(*dtypes):
    out = convert_dtype(dtypes[0])
    for d in dtypes[1:]:
        out = torch.promote_types(out, convert_dtype(d))
    return out


def to_numpy_dtype(dtype):
    """The numpy dtype of ``dtype``. bfloat16 has none without
    ``ml_dtypes``, which the port does not use: it raises ``TypeError``."""
    d = convert_dtype(dtype)
    if d == bfloat16:
        raise TypeError("numpy has no bfloat16 dtype (the port carries bf16 "
                        "as torch tensors)")
    return np.dtype(dtype_name(d))


class finfo:
    """paddle.finfo parity: the reference's numpy-finfo-shaped record."""

    def __init__(self, dtype):
        d = convert_dtype(dtype)
        info = torch.finfo(d)
        self.dtype = dtype_name(d)
        self.bits = info.bits
        self.eps = float(info.eps)
        self.min = float(info.min)
        self.max = float(info.max)
        self.tiny = float(info.tiny)
        self.smallest_normal = float(info.smallest_normal)
        # numpy's record holds the resolution rounded to the dtype
        self.resolution = float(torch.tensor(info.resolution, dtype=d))


class iinfo:
    """paddle.iinfo parity."""

    def __init__(self, dtype):
        d = convert_dtype(dtype)
        info = torch.iinfo(d)
        self.dtype = dtype_name(d)
        self.bits = info.bits
        self.min = int(info.min)
        self.max = int(info.max)
