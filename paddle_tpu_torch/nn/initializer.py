"""Parameter initializers (port of ``paddle_tpu/nn/initializer.py``).

Each initializer is called as ``init(shape, dtype=None, generator=None,
device=None)`` and returns a new tensor: ``dtype`` defaults to the port's
default dtype (``core.dtype``), ``device`` to the current place, and the
random ones draw from the port's generator for that device
(``core.random.default_generator``), never from torch's global one, unless
a ``torch.Generator`` is given. The draws are torch's, so a seed repeats
port against port and the distributions are the reference's, not its
numbers. ``Constant``, ``Assign``, ``Dirac``, ``Bilinear`` and
``calculate_gain`` are exact.

Random values are drawn in fp32 and cast once to ``dtype``, as the
reference's bf16 draws are made at the draw's own precision.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.place import resolve_device
from ..core.random import default_generator

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Dirac", "Orthogonal", "calculate_gain", "Bilinear"]


def calculate_gain(nonlinearity: str, param=None) -> float:
    """paddle.nn.initializer.calculate_gain parity."""
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in recommended:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return recommended[nonlinearity]


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: [out_c, in_c, *spatial]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=None, generator=None, device=None):
        dtype = dtypes.convert_dtype(dtype) or dtypes.get_default_dtype()
        device = resolve_device(device)
        if generator is None:
            generator = default_generator.generator(device)
        shape = tuple(int(s) for s in shape)
        return self._generate(generator, shape, dtype, device)

    def _generate(self, gen, shape, dtype, device):
        raise NotImplementedError


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


def _uniform(gen, shape, device, low, high):
    u = torch.rand(shape, generator=gen, device=device)
    return u * (high - low) + low


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, gen, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, gen, shape, dtype, device):
        return (self.mean + self.std * _normal(gen, shape, device)).to(dtype)


class TruncatedNormal(Initializer):
    """Normal truncated to ``[a, b]`` standard deviations around the mean,
    drawn by the inverse CDF of a uniform between the bounds' CDFs."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _generate(self, gen, shape, dtype, device):
        cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))  # noqa
        u = _uniform(gen, shape, device, cdf(self.a), cdf(self.b))
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        z = z.clamp(self.a, self.b)
        return (self.mean + self.std * z).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, gen, shape, dtype, device):
        return _uniform(gen, shape, device, self.low, self.high).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, gen, shape, dtype, device):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (std * _normal(gen, shape, device)).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, gen, shape, dtype, device):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(gen, shape, device, -limit, limit).to(dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, gen, shape, dtype, device):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        std = calculate_gain(self.nonlinearity,
                             self.negative_slope) / math.sqrt(fi)
        return (std * _normal(gen, shape, device)).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, gen, shape, dtype, device):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        limit = calculate_gain(self.nonlinearity,
                               self.negative_slope) * math.sqrt(3.0 / fi)
        return _uniform(gen, shape, device, -limit, limit).to(dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _generate(self, gen, shape, dtype, device):
        v = self.value
        if isinstance(v, torch.Tensor):
            t = v.detach().to(device=device, dtype=dtype, copy=True)
        else:
            t = torch.as_tensor(np.asarray(v), device=device).to(dtype)
        return t.reshape(shape) if tuple(t.shape) != shape else t


class Dirac(Initializer):
    """Identity-preserving conv kernel (nn/initializer/dirac.py)."""

    def __init__(self, groups=1):
        self.groups = groups

    def _generate(self, gen, shape, dtype, device):
        arr = torch.zeros(shape, dtype=dtype, device=device)
        out_per_group = shape[0] // self.groups
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for d in range(min(out_per_group, shape[1])):
                arr[(g * out_per_group + d, d, *centers)] = 1.0
        return arr


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix: the Q of a normal square matrix's QR,
    its columns signed by R's diagonal (as ``jax.random.orthogonal``)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, gen, shape, dtype, device):
        if len(shape) < 2:
            raise ValueError("Orthogonal init needs >=2 dims")
        rows, cols = shape[0], int(np.prod(shape[1:]))
        n = max(rows, cols)
        q, r = torch.linalg.qr(_normal(gen, (n, n), device))
        q = q * torch.sign(torch.diagonal(r))[None, :]
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Bilinear(Initializer):
    """The FCN bilinear-upsampling filter for a transposed conv weight
    ``[in_c, out_c / groups, kH, kW]``."""

    def _generate(self, gen, shape, dtype, device):
        if len(shape) != 4:
            raise ValueError("Bilinear expects a 4-D conv weight")

        def tri(k):
            f = (k + 1) // 2
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            x = torch.arange(k, dtype=torch.float32, device=device)
            return 1.0 - torch.abs(x / f - c)

        kern = tri(shape[2])[:, None] * tri(shape[3])[None, :]
        return kern.expand(shape).to(dtype).clone()


# paddle.nn.initializer.set_global_initializer
_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def get_global_initializer():
    return _global_weight_init, _global_bias_init
