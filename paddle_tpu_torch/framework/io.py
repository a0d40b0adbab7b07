"""``paddle.save`` / ``paddle.load`` (port of ``paddle_tpu/framework/io.py``).

The reference's format: a pickle (protocol 4 or above) of nested dicts,
lists, tuples and namedtuples whose tensors are ``_TensorPayload`` objects
holding a numpy array, a name and a trainable flag. The port writes the
same structure with its own payload class, and reads both its own files
and the JAX package's.

- A JAX-written file names the payload class by the reference's path
  (``paddle_tpu.framework.io._TensorPayload``). The port's ``load`` unpickles
  through an ``Unpickler`` whose ``find_class`` maps that path, held here as
  a string, to the port's payload class, so reading it imports nothing of
  the JAX package; any other class of ``paddle_tpu``, ``jax`` or ``jaxlib``
  is refused.
- numpy has no bfloat16 of its own (the JAX package stores ``ml_dtypes``
  arrays). The port stores a bf16 tensor as its uint16 bits with the dtype
  tag ``"bfloat16"``, so its own files need no ``ml_dtypes`` either way. A
  JAX-written bf16 array is read where ``ml_dtypes`` imports; elsewhere
  ``load`` raises and says so.

``load`` returns torch tensors on ``device`` (:func:`get_device`: the CUDA
card unless ``device="cpu"``), each with ``requires_grad`` set from the
payload's trainable flag where its dtype allows one, or, with
``return_numpy=True``, numpy arrays (a bf16 tensor as fp32, the same
values).
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..device import get_device

__all__ = ["save", "load"]

_PROTOCOL = 4
# the JAX package's payload class, by name only (never imported)
_REFERENCE_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")
_REFUSED = ("paddle_tpu", "jax", "jaxlib")


class _TensorPayload:
    """A tagged tensor: numpy ``array`` (uint16 bits when ``dtype`` is
    ``"bfloat16"``), ``name`` and ``trainable``, as the reference's."""

    def __init__(self, array, name=None, trainable=False, dtype=None):
        self.array = array
        self.name = name
        self.trainable = trainable
        self.dtype = dtype


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _TensorPayload(t.view(torch.int16).numpy().view(np.uint16),
                                  None, obj.requires_grad, "bfloat16")
        return _TensorPayload(t.numpy(), None, obj.requires_grad)
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        if hasattr(obj, "_fields"):  # namedtuple
            return t(*(_to_saveable(v) for v in obj))
        return t(_to_saveable(v) for v in obj)
    return obj


def _bf16_bits(arr: np.ndarray) -> np.ndarray:
    """The uint16 bits of a bf16 array (the port's, or an ml_dtypes one)."""
    return arr if arr.dtype == np.uint16 else arr.view(np.uint16)


def _tensor(p: _TensorPayload, device, return_numpy: bool):
    arr = np.asarray(p.array)
    bf16 = getattr(p, "dtype", None) == "bfloat16" or \
        arr.dtype.name == "bfloat16"
    if bf16:
        bits = torch.from_numpy(_bf16_bits(arr).view(np.int16).copy())
        t = bits.view(torch.bfloat16)
        if return_numpy:
            return t.float().numpy()
    else:
        if return_numpy:
            return arr
        t = torch.from_numpy(np.array(arr))      # a writable copy
    t = t.to(device)
    if p.trainable and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _from_saved(obj, device, return_numpy):
    if isinstance(obj, _TensorPayload):
        return _tensor(obj, device, return_numpy)
    if isinstance(obj, dict):
        return {k: _from_saved(v, device, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        if hasattr(obj, "_fields"):
            return t(*(_from_saved(v, device, return_numpy) for v in obj))
        return t(_from_saved(v, device, return_numpy) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in (_REFERENCE_PAYLOAD,
                              (__name__, "_TensorPayload")):
            return _TensorPayload
        root = module.split(".")[0]
        if root in _REFUSED:
            raise pickle.UnpicklingError(
                f"{module}.{name}: paddle_tpu_torch.load reads tensors and "
                f"Python containers only, never classes of {root}")
        if root == "ml_dtypes":
            try:
                return super().find_class(module, name)
            except ImportError as e:
                raise pickle.UnpicklingError(
                    "the file holds bf16 arrays written by the JAX package "
                    "(ml_dtypes arrays); reading them needs ml_dtypes, "
                    "which does not import here") from e
        return super().find_class(module, name)


def save(obj: Any, path, protocol: int = _PROTOCOL, **configs):
    """Pickle ``obj`` (tensors as payloads) to ``path`` (a file name, its
    directory made if missing, or a binary file object)."""
    if isinstance(path, str):
        dirname = os.path.dirname(path)
        if dirname and not os.path.exists(dirname):
            os.makedirs(dirname, exist_ok=True)
    payload = _to_saveable(obj)
    with open(path, "wb") if isinstance(path, str) else path as f:
        pickle.dump(payload, f, protocol=max(protocol, 4))


def load(path, **configs) -> Any:
    """Read what :func:`save` (or the JAX package's ``save``) wrote.
    ``configs``: ``return_numpy`` (default False) and ``device`` (default:
    the CUDA card, see :func:`get_device`)."""
    return_numpy = configs.get("return_numpy", False)
    device = None if return_numpy else get_device(configs.get("device"))
    with open(path, "rb") if isinstance(path, str) else path as f:
        payload = _Unpickler(f).load()
    return _from_saved(payload, device, return_numpy)
