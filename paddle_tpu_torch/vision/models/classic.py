"""Classic CNN families (port of ``paddle_tpu/vision/models/classic.py``):
LeNet, AlexNet, VGG (with ``batch_norm``), MobileNetV1, MobileNetV2 and
SqueezeNet with their model functions, NCHW, with the reference's
``state_dict`` keys and shapes."""
from __future__ import annotations

import torch

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Layer,
                   Linear, MaxPool2D, ReLU, ReLU6, Sequential)

__all__ = ["LeNet", "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16",
           "vgg19", "MobileNetV1", "mobilenet_v1", "MobileNetV2",
           "mobilenet_v2", "SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class LeNet(Layer):
    """reference vision/models/lenet.py."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120), Linear(120, 84), Linear(84, num_classes))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


class AlexNet(Layer):
    """reference vision/models/alexnet.py."""

    def __init__(self, num_classes: int = 1000, dropout: float = 0.5):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1), ReLU(),
            Conv2D(384, 256, 3, padding=1), ReLU(),
            Conv2D(256, 256, 3, padding=1), ReLU(),
            MaxPool2D(3, 2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        self.classifier = Sequential(
            Dropout(dropout), Linear(256 * 6 * 6, 4096), ReLU(),
            Dropout(dropout), Linear(4096, 4096), ReLU(),
            Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        x = self.avgpool(x)
        x = x.flatten(1)
        return self.classifier(x)


def alexnet(pretrained: bool = False, **kwargs):
    return AlexNet(**kwargs)


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(Layer):
    """reference vision/models/vgg.py."""

    def __init__(self, features, num_classes: int = 1000,
                 with_pool: bool = True):
        super().__init__()
        self.features = features
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096), ReLU(), Dropout(),
                Linear(4096, 4096), ReLU(), Dropout(),
                Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def _make_vgg_layers(cfg, batch_norm: bool = False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


def _vgg(cfg_key, batch_norm=False, **kw):
    return VGG(_make_vgg_layers(_VGG_CFGS[cfg_key], batch_norm), **kw)


def vgg11(pretrained=False, batch_norm=False, **kw):
    return _vgg("A", batch_norm, **kw)


def vgg13(pretrained=False, batch_norm=False, **kw):
    return _vgg("B", batch_norm, **kw)


def vgg16(pretrained=False, batch_norm=False, **kw):
    return _vgg("D", batch_norm, **kw)


def vgg19(pretrained=False, batch_norm=False, **kw):
    return _vgg("E", batch_norm, **kw)


class _ConvBNReLU(Sequential):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 relu6=False):
        super().__init__(
            Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                   groups=groups, bias_attr=False),
            BatchNorm2D(out_c),
            ReLU6() if relu6 else ReLU())


class _DepthwiseSeparable(Layer):
    def __init__(self, in_c, out_c1, out_c2, stride):
        super().__init__()
        self.dw = _ConvBNReLU(in_c, out_c1, 3, stride=stride, padding=1,
                              groups=in_c)
        self.pw = _ConvBNReLU(out_c1, out_c2, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Layer):
    """reference vision/models/mobilenetv1.py."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: max(int(c * scale), 8)
        cfg = [(s(32), s(64), 1), (s(64), s(128), 2), (s(128), s(128), 1),
               (s(128), s(256), 2), (s(256), s(256), 1),
               (s(256), s(512), 2)] + [(s(512), s(512), 1)] * 5 + [
                  (s(512), s(1024), 2), (s(1024), s(1024), 1)]
        blocks = [_ConvBNReLU(3, s(32), 3, stride=2, padding=1)]
        for in_c, out_c, st in cfg:
            blocks.append(_DepthwiseSeparable(in_c, in_c, out_c, st))
        self.features = Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    return MobileNetV1(scale=scale, **kw)


class _InvertedResidual(Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU(in_c, hidden, 1, relu6=True))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, relu6=True),
            Conv2D(hidden, out_c, 1, bias_attr=False),
            BatchNorm2D(out_c),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    """reference vision/models/mobilenetv2.py."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = max(int(32 * scale), 8)
        feats = [_ConvBNReLU(3, in_c, 3, stride=2, padding=1, relu6=True)]
        for t, c, n, s in cfg:
            out_c = max(int(c * scale), 8)
            for i in range(n):
                feats.append(_InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t))
                in_c = out_c
        last = max(int(1280 * scale), 1280 if scale <= 1.0 else 8)
        feats.append(_ConvBNReLU(in_c, last, 1, relu6=True))
        self.features = Sequential(*feats)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(Dropout(0.2),
                                         Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kw):
    return MobileNetV2(scale=scale, **kw)


class _Fire(Layer):
    def __init__(self, in_c, squeeze, e1, e3):
        super().__init__()
        self.squeeze = Sequential(Conv2D(in_c, squeeze, 1), ReLU())
        self.expand1 = Sequential(Conv2D(squeeze, e1, 1), ReLU())
        self.expand3 = Sequential(Conv2D(squeeze, e3, 3, padding=1), ReLU())

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1(x), self.expand3(x)], dim=1)


class SqueezeNet(Layer):
    """reference vision/models/squeezenet.py."""

    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 with_pool: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2), ReLU(), MaxPool2D(3, 2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128), MaxPool2D(3, 2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                MaxPool2D(3, 2), _Fire(512, 64, 256, 256))
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2), ReLU(), MaxPool2D(3, 2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                MaxPool2D(3, 2),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                MaxPool2D(3, 2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        self.classifier = Sequential(
            Dropout(0.5), Conv2D(512, num_classes, 1), ReLU())
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(pretrained=False, **kw):
    return SqueezeNet("1.1", **kw)
