"""Random sampling (port of ``paddle_tpu/ops/random.py``).

Every op draws from ``core.random.default_generator``'s generator for its
device, passed to torch explicitly, the in-place ``uniform_`` and
``exponential_`` included; nothing reads torch's global generators. New
tensors go on the current place, in the default dtype unless a dtype is
given.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.random import default_generator
from ._helpers import device_of, dtype_or_default, inplace_guard, shape_arg, \
    tensor

__all__ = ["rand", "randn", "randint", "randint_like", "randperm", "uniform",
           "normal", "standard_normal", "poisson", "bernoulli", "multinomial",
           "exponential_", "rand_like", "randn_like", "normal_like",
           "uniform_"]


def _gen(device) -> torch.Generator:
    return default_generator.generator(device)


def rand(shape, dtype=None, name=None):
    dev = device_of()
    return torch.rand(shape_arg(shape), generator=_gen(dev),
                      dtype=dtype_or_default(dtype), device=dev)


def randn(shape, dtype=None, name=None):
    dev = device_of()
    return torch.randn(shape_arg(shape), generator=_gen(dev),
                       dtype=dtype_or_default(dtype), device=dev)


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = device_of()
    return torch.randint(low, high, shape_arg(shape), generator=_gen(dev),
                         dtype=dtypes.convert_dtype(dtype), device=dev)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    v = tensor(x)
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, v.shape, generator=_gen(v.device),
                         dtype=dtypes.convert_dtype(dtype) or v.dtype,
                         device=v.device)


def randperm(n, dtype="int64", name=None):
    dev = device_of()
    return torch.randperm(n, generator=_gen(dev),
                          dtype=dtypes.convert_dtype(dtype), device=dev)


def _seeded(seed, dev) -> torch.Generator:
    """The default generator, or for a nonzero ``seed`` a generator of that
    seed alone (paddle's per-call seed)."""
    if seed == 0:
        return _gen(dev)
    return torch.Generator(device=dev).manual_seed(int(seed))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = device_of()
    out = torch.empty(shape_arg(shape), dtype=dtype_or_default(dtype),
                      device=dev)
    return out.uniform_(float(min), float(max), generator=_seeded(seed, dev))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with inplace_guard(x):
        x.uniform_(float(min), float(max), generator=_seeded(seed, x.device))
    return x


def normal(mean=0.0, std=1.0, shape=None, name=None):
    dev = device_of(mean, std)
    if shape is None:
        shape = torch.broadcast_shapes(
            tuple(getattr(mean, "shape", ())), tuple(getattr(std, "shape",
                                                             ())))
    sample = torch.randn(shape_arg(shape), generator=_gen(dev),
                         dtype=dtypes.get_default_dtype(), device=dev)
    return sample * std + mean


def normal_like(x, mean=0.0, std=1.0, name=None):
    return normal(mean, std, tensor(x).shape)


def rand_like(x, dtype=None, name=None):
    v = tensor(x)
    return torch.rand(v.shape, generator=_gen(v.device),
                      dtype=dtypes.convert_dtype(dtype) or v.dtype,
                      device=v.device)


def randn_like(x, dtype=None, name=None):
    v = tensor(x)
    return torch.randn(v.shape, generator=_gen(v.device),
                       dtype=dtypes.convert_dtype(dtype) or v.dtype,
                       device=v.device)


def poisson(x, name=None):
    v = tensor(x)
    return torch.poisson(v, generator=_gen(v.device))


def bernoulli(x, name=None):
    v = tensor(x)
    return torch.bernoulli(v, generator=_gen(v.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    v = tensor(x)
    return torch.multinomial(v, num_samples, replacement,
                             generator=_gen(v.device))


def exponential_(x, lam=1.0, name=None):
    with inplace_guard(x):
        x.exponential_(lam, generator=_gen(x.device))
    return x
