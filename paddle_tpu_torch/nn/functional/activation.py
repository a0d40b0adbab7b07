"""Activation functions (port of ``paddle_tpu/nn/functional/activation.py``).

The reference's formulas as plain torch ops, differentiable in ``x`` (and
in ``prelu``'s weight). ``rrelu`` in training and ``gumbel_softmax`` draw
from the port's generator (``core.random``). The in-place names
(``relu_``, ``elu_``, ``softmax_``, ``tanh_``) return new tensors, as the
reference's do. The clipping activations (``relu6``, ``hardtanh``,
``hardsigmoid``, ``hardswish``) clip as ``jnp.clip`` does, by a maximum
then a minimum, so an input exactly on a bound takes half the gradient,
as in the reference (``torch.clamp`` gives it all).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core import dtype as dtypes
from ...core.random import default_generator
from ._op import amp_op

__all__ = [
    "relu", "relu6", "relu_", "elu", "elu_", "selu", "celu", "gelu", "silu",
    "swish", "sigmoid", "hardsigmoid", "hardswish", "hardtanh", "hardshrink",
    "softshrink", "tanhshrink", "leaky_relu", "log_sigmoid", "log_softmax",
    "maxout", "prelu", "rrelu", "softmax", "softmax_", "softplus", "softsign",
    "mish", "tanh", "tanh_", "thresholded_relu", "glu", "gumbel_softmax",
]


@amp_op("relu")
def relu(x, name=None):
    return torch.relu(x)


relu_ = relu


@amp_op("sigmoid")
def sigmoid(x, name=None):
    return torch.sigmoid(x)


@amp_op("silu")
def silu(x, name=None):
    return F.silu(x)


@amp_op("softsign")
def softsign(x, name=None):
    return x / (1 + x.abs())


@amp_op("tanh")
def tanh(x, name=None):
    return torch.tanh(x)


tanh_ = tanh


@amp_op("log_sigmoid")
def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


def _clip(x, lo, hi):
    """``jnp.clip``'s values and gradients: half the gradient on a bound
    (torch's binary maximum and minimum split a tie evenly)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


@amp_op("relu6")
def relu6(x, name=None):
    return _clip(x, 0.0, 6.0)


@amp_op("elu")
def elu(x, alpha: float = 1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


elu_ = elu


@amp_op("selu")
def selu(x, scale: float = 1.0507009873554805,
         alpha: float = 1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@amp_op("celu")
def celu(x, alpha: float = 1.0, name=None):
    return F.celu(x, alpha)


@amp_op("gelu")
def gelu(x, approximate: bool = False, name=None):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def swish(x, name=None):
    return silu(x)


@amp_op("hardsigmoid")
def hardsigmoid(x, slope: float = 0.1666667, offset: float = 0.5, name=None):
    return _clip(slope * x + offset, 0.0, 1.0)


@amp_op("hardswish")
def hardswish(x, name=None):
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


@amp_op("hardtanh")
def hardtanh(x, min: float = -1.0, max: float = 1.0, name=None):
    return _clip(x, min, max)


@amp_op("hardshrink")
def hardshrink(x, threshold: float = 0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@amp_op("softshrink")
def softshrink(x, threshold: float = 0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@amp_op("tanhshrink")
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@amp_op("leaky_relu")
def leaky_relu(x, negative_slope: float = 0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


def _cast(x, dtype):
    return x if dtype is None else x.to(dtypes.convert_dtype(dtype))


@amp_op("log_softmax")
def log_softmax(x, axis: int = -1, dtype=None, name=None):
    return torch.log_softmax(_cast(x, dtype), dim=axis)


@amp_op("softmax")
def softmax(x, axis: int = -1, dtype=None, name=None):
    return torch.softmax(_cast(x, dtype), dim=axis)


softmax_ = softmax


@amp_op("softplus")
def softplus(x, beta: float = 1.0, threshold: float = 20.0, name=None):
    return F.softplus(x, beta, threshold)


@amp_op("mish")
def mish(x, name=None):
    return F.mish(x)


@amp_op("thresholded_relu")
def thresholded_relu(x, threshold: float = 1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


@amp_op("maxout")
def maxout(x, groups: int, axis: int = 1, name=None):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (groups, c // groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax)


@amp_op("prelu")
def prelu(x, weight, data_format: str = "NCHW", name=None):
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    ax = 1 if data_format in ("NCHW", "NCL", "NCDHW") else x.dim() - 1
    shape = [1] * x.dim()
    shape[ax] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


@amp_op("rrelu")
def rrelu(x, lower: float = 0.125, upper: float = 0.3333333,
          training: bool = False, name=None):
    if training:
        u = torch.rand(x.shape, generator=default_generator.generator(
            x.device), device=x.device, dtype=torch.float32)
        a = (lower + (upper - lower) * u).to(x.dtype)
        return torch.where(x >= 0, x, a * x)
    return leaky_relu(x, (lower + upper) / 2.0)


@amp_op("glu")
def glu(x, axis: int = -1, name=None):
    return F.glu(x, dim=axis)


@amp_op("gumbel_softmax")
def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1, name=None):
    u = torch.rand(x.shape, generator=default_generator.generator(x.device),
                   device=x.device, dtype=torch.float32)
    u = (1e-20 + (1.0 - 1e-20) * u).to(x.dtype)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (onehot - y).detach() + y
    return y
