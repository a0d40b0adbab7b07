"""Common layers (port of ``paddle_tpu/nn/layer/common.py``).

``Linear`` holds its weight as ``[in_features, out_features]`` and computes
``x @ W + b`` (``F.linear``), the reference's layout, so a reference
``state_dict`` carries across as it is. ``Embedding`` zeroes its
``padding_idx`` row at construction. ``LinearCompress`` is ``Linear``, as
in the reference.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ...ops.manipulation import flatten, unflatten
from ..initializer import Uniform, XavierUniform
from .layers import Layer

__all__ = [
    "Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
    "Embedding", "Flatten", "Unflatten", "Identity", "Upsample",
    "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D", "Pad3D",
    "ZeroPad2D", "Bilinear", "CosineSimilarity", "PairwiseDistance",
    "PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "Fold", "Unfold",
    "LinearCompress",
]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(Layer):
    """y = x W + b, W [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


LinearCompress = Linear


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierUniform())
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx].zero_()

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        return unflatten(x, self.axis, self.shape)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "nearest",
                             data_format=self.data_format)


class UpsamplingBilinear2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "bilinear",
                             align_corners=True,
                             data_format=self.data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._pad, self._mode = padding, mode
        self._value, self._data_format = value, data_format

    def forward(self, x):
        return F.pad(x, self._pad, self._mode, self._value,
                     self._data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        if isinstance(padding, int):
            padding = [padding] * 2
        super().__init__(padding, mode, value,
                         "NCW" if data_format in ("NCL", "NCW") else "NWC")


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        if isinstance(padding, int):
            padding = [padding] * 4
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        if isinstance(padding, int):
            padding = [padding] * 6
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        k = 1.0 / math.sqrt(in1_features)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=Uniform(-k, k))
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-k, k))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self._axis, self._eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor, self._data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self._factor, self._data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor, self._data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self._factor, self._data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._groups, self._data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self._groups, self._data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)
