"""Activation layers (port of ``paddle_tpu/nn/layer/activation.py``):
``Layer`` wrappers of ``nn.functional``'s activations. ``PReLU`` holds its
slope as a parameter (``Constant(init)``); ``RReLU`` samples its slopes in
training mode only."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = [
    "CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish",
    "PReLU", "ReLU", "ReLU6", "RReLU", "SELU", "Sigmoid", "Silu", "Softmax",
    "Softplus", "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
    "ThresholdedReLU", "Softmax2D",
]


def _plain(fn_name):
    """A layer of no arguments over ``F.<fn_name>``."""
    def forward(self, x):
        return getattr(F, fn_name)(x)

    def __init__(self, name=None):
        Layer.__init__(self)

    return {"forward": forward, "__init__": __init__}


ReLU = type("ReLU", (Layer,), _plain("relu"))
ReLU6 = type("ReLU6", (Layer,), _plain("relu6"))
Hardsigmoid = type("Hardsigmoid", (Layer,), _plain("hardsigmoid"))
Hardswish = type("Hardswish", (Layer,), _plain("hardswish"))
LogSigmoid = type("LogSigmoid", (Layer,), _plain("log_sigmoid"))
Mish = type("Mish", (Layer,), _plain("mish"))
Sigmoid = type("Sigmoid", (Layer,), _plain("sigmoid"))
Silu = type("Silu", (Layer,), _plain("silu"))
Softsign = type("Softsign", (Layer,), _plain("softsign"))
Swish = type("Swish", (Layer,), _plain("swish"))
Tanh = type("Tanh", (Layer,), _plain("tanh"))
Tanhshrink = type("Tanhshrink", (Layer,), _plain("tanhshrink"))
for _cls in (ReLU, ReLU6, Hardsigmoid, Hardswish, LogSigmoid, Mish, Sigmoid,
             Silu, Softsign, Swish, Tanh, Tanhshrink):
    _cls.__module__ = __name__


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.glu(x, self._axis)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=0.125, upper=0.3333333, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self._scale, self._alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)


class Softmax2D(Layer):
    """Softmax over the channel dim of 3-D (CHW) or 4-D (NCHW) inputs."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError("Softmax2D expects 3-D or 4-D input")
        return F.softmax(x, axis=-3)
