"""Pooling layers (port of ``paddle_tpu/nn/layer/pooling.py``): ``Layer``
s over ``nn.functional``'s pooling, with the reference's arguments in the
reference's order."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = [
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
]


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, exclusive, ceil_mode)

    def forward(self, x):
        return F.avg_pool1d(x, *self.a)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, ceil_mode, exclusive,
                  divisor_override, data_format)

    def forward(self, x):
        return F.avg_pool2d(x, *self.a)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, ceil_mode, exclusive,
                  divisor_override, data_format)

    def forward(self, x):
        return F.avg_pool3d(x, *self.a)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, return_mask, ceil_mode)

    def forward(self, x):
        return F.max_pool1d(x, *self.a)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, return_mask, ceil_mode, data_format)

    def forward(self, x):
        return F.max_pool2d(x, *self.a)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, return_mask, ceil_mode, data_format)

    def forward(self, x):
        return F.max_pool3d(x, *self.a)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, *self.a)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, *self.a)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCDHW",
                 output_size=None, name=None):
        super().__init__()
        self.a = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, *self.a)
