"""Convolution layers (port of ``paddle_tpu/nn/layer/conv.py``): ``Layer``
s over ``nn.functional``'s convolutions. The weight is ``[out, in /
groups, *k]`` (a transpose: ``[in, out / groups, *k]``), drawn from
``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))`` with ``fan_in = in /
groups * prod(k)`` by the port's generator; the bias from the global or
the attribute's initializer, else zeros; ``bias_attr=False`` gives none.
``padding_mode`` is kept and, as in the reference, not used: the padding
is zeros.
"""
from __future__ import annotations

import math

import numpy as np

from .. import functional as F
from ..initializer import Uniform
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


class _ConvNd(Layer):
    def __init__(self, nd, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, transposed=False, output_padding=0):
        super().__init__()
        self._nd = nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, nd)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        self._transposed = transposed
        self._output_padding = output_padding
        if transposed:
            shape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            shape = [out_channels, in_channels // groups, *self._kernel_size]
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        k = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        self.weight = self.create_parameter(
            shape, attr=weight_attr, default_initializer=Uniform(-k, k))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)
