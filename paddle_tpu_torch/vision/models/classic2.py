"""The second batch of classic CNN families (port of
``paddle_tpu/vision/models/classic2.py``): DenseNet, GoogLeNet (Inception
v1; in training mode it returns ``(out, aux1, aux2)``), InceptionV3 (its
stem has no padding: 299 x 299 inputs), MobileNetV3 Large and Small (the
squeeze-excite gate a ``Hardsigmoid``, ``Hardswish`` activations, widths
by ``scale``) and ShuffleNetV2 with its seven model functions, NCHW, with
the reference's ``state_dict`` keys and shapes. The model functions take
and ignore ``pretrained``, as the reference's do."""
from __future__ import annotations

import torch

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                   Dropout, Flatten, Hardsigmoid, Hardswish, Layer, Linear,
                   MaxPool2D, ReLU, Sequential, Swish)

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264", "GoogLeNet", "googlenet",
           "InceptionV3", "inception_v3", "MobileNetV3Large",
           "MobileNetV3Small", "mobilenet_v3_large", "mobilenet_v3_small",
           "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


def _cbr(in_c, out_c, k, s=1, p=0, groups=1, act="relu"):
    layers = [Conv2D(in_c, out_c, k, stride=s, padding=p, groups=groups,
                     bias_attr=False), BatchNorm2D(out_c)]
    if act == "relu":
        layers.append(ReLU())
    elif act == "hardswish":
        layers.append(Hardswish())
    elif act == "swish":
        layers.append(Swish())
    # act == "none": conv+bn only
    return Sequential(*layers)


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------


class _DenseLayer(Layer):
    def __init__(self, in_c, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = BatchNorm2D(in_c)
        self.relu = ReLU()
        self.conv1 = Conv2D(in_c, bn_size * growth_rate, 1,
                            bias_attr=False)
        self.bn2 = BatchNorm2D(bn_size * growth_rate)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3,
                            padding=1, bias_attr=False)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], 1)


class _Transition(Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.bn = BatchNorm2D(in_c)
        self.relu = ReLU()
        self.conv = Conv2D(in_c, out_c, 1, bias_attr=False)
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


_DENSE_CFG = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
              169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
              264: (6, 12, 64, 48)}


class DenseNet(Layer):
    """reference vision/models/densenet.py DenseNet."""

    def __init__(self, layers: int = 121, bn_size: int = 4, dropout=0.0,
                 num_classes: int = 1000, with_pool: bool = True):
        super().__init__()
        block_cfg = _DENSE_CFG[layers]
        growth = 48 if layers == 161 else 32
        init_c = 96 if layers == 161 else 64
        self.features = [Sequential(
            Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False),
            BatchNorm2D(init_c), ReLU(), MaxPool2D(3, stride=2, padding=1))]
        c = init_c
        for bi, n in enumerate(block_cfg):
            for _ in range(n):
                self.features.append(_DenseLayer(c, growth, bn_size,
                                                 dropout))
                c += growth
            if bi != len(block_cfg) - 1:
                self.features.append(_Transition(c, c // 2))
                c //= 2
        self.features = Sequential(*self.features)
        self.bn_last = BatchNorm2D(c)
        self.relu = ReLU()
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Linear(c, num_classes)

    def forward(self, x):
        x = self.relu(self.bn_last(self.features(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _densenet(layers, pretrained=False, **kw):
    return DenseNet(layers=layers, **kw)


def densenet121(pretrained=False, **kw):
    return _densenet(121, pretrained, **kw)


def densenet161(pretrained=False, **kw):
    return _densenet(161, pretrained, **kw)


def densenet169(pretrained=False, **kw):
    return _densenet(169, pretrained, **kw)


def densenet201(pretrained=False, **kw):
    return _densenet(201, pretrained, **kw)


def densenet264(pretrained=False, **kw):
    return _densenet(264, pretrained, **kw)


# ---------------------------------------------------------------------------
# GoogLeNet (Inception v1)
# ---------------------------------------------------------------------------


class _Inception(Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _cbr(in_c, c1, 1)
        self.b2 = Sequential(_cbr(in_c, c3r, 1), _cbr(c3r, c3, 3, p=1))
        self.b3 = Sequential(_cbr(in_c, c5r, 1), _cbr(c5r, c5, 5, p=2))
        self.b4 = Sequential(MaxPool2D(3, stride=1, padding=1),
                             _cbr(in_c, proj, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         1)


class GoogLeNet(Layer):
    """reference vision/models/googlenet.py (returns (out, aux1, aux2) in
    train mode like the reference)."""

    def __init__(self, num_classes: int = 1000, with_pool: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _cbr(3, 64, 7, s=2, p=3), MaxPool2D(3, stride=2, padding=1),
            _cbr(64, 64, 1), _cbr(64, 192, 3, p=1),
            MaxPool2D(3, stride=2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = MaxPool2D(3, stride=2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = MaxPool2D(3, stride=2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.2)
            self.fc = Linear(1024, num_classes)
            self.aux1 = Sequential(AdaptiveAvgPool2D(4),
                                   _cbr(512, 128, 1), Flatten(),
                                   Linear(2048, 1024), ReLU(),
                                   Dropout(0.7), Linear(1024, num_classes))
            self.aux2 = Sequential(AdaptiveAvgPool2D(4),
                                   _cbr(528, 128, 1), Flatten(),
                                   Linear(2048, 1024), ReLU(),
                                   Dropout(0.7), Linear(1024, num_classes))

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux1 = self.aux1(x) if (self.training and self.num_classes > 0) \
            else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if (self.training and self.num_classes > 0) \
            else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        if self.training and self.num_classes > 0:
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kw):
    return GoogLeNet(**kw)


# ---------------------------------------------------------------------------
# InceptionV3
# ---------------------------------------------------------------------------


class _IncA(Layer):
    def __init__(self, in_c, pool_c):
        super().__init__()
        self.b1 = _cbr(in_c, 64, 1)
        self.b5 = Sequential(_cbr(in_c, 48, 1), _cbr(48, 64, 5, p=2))
        self.b3 = Sequential(_cbr(in_c, 64, 1), _cbr(64, 96, 3, p=1),
                             _cbr(96, 96, 3, p=1))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _cbr(in_c, pool_c, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], 1)


class _IncB(Layer):  # grid reduction
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _cbr(in_c, 384, 3, s=2)
        self.b33 = Sequential(_cbr(in_c, 64, 1), _cbr(64, 96, 3, p=1),
                              _cbr(96, 96, 3, s=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b33(x), self.pool(x)], 1)


class _IncC(Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _cbr(in_c, 192, 1)
        self.b7 = Sequential(_cbr(in_c, c7, 1),
                             _cbr(c7, c7, (1, 7), p=(0, 3)),
                             _cbr(c7, 192, (7, 1), p=(3, 0)))
        self.b77 = Sequential(_cbr(in_c, c7, 1),
                              _cbr(c7, c7, (7, 1), p=(3, 0)),
                              _cbr(c7, c7, (1, 7), p=(0, 3)),
                              _cbr(c7, c7, (7, 1), p=(3, 0)),
                              _cbr(c7, 192, (1, 7), p=(0, 3)))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _cbr(in_c, 192, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b77(x), self.bp(x)], 1)


class _IncD(Layer):  # grid reduction 17->8
    def __init__(self, in_c):
        super().__init__()
        self.b3 = Sequential(_cbr(in_c, 192, 1), _cbr(192, 320, 3, s=2))
        self.b7 = Sequential(_cbr(in_c, 192, 1),
                             _cbr(192, 192, (1, 7), p=(0, 3)),
                             _cbr(192, 192, (7, 1), p=(3, 0)),
                             _cbr(192, 192, 3, s=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], 1)


class _IncE(Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _cbr(in_c, 320, 1)
        self.b3_stem = _cbr(in_c, 384, 1)
        self.b3_a = _cbr(384, 384, (1, 3), p=(0, 1))
        self.b3_b = _cbr(384, 384, (3, 1), p=(1, 0))
        self.b33_stem = Sequential(_cbr(in_c, 448, 1),
                                   _cbr(448, 384, 3, p=1))
        self.b33_a = _cbr(384, 384, (1, 3), p=(0, 1))
        self.b33_b = _cbr(384, 384, (3, 1), p=(1, 0))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _cbr(in_c, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        t = self.b33_stem(x)
        return torch.cat([self.b1(x), self.b3_a(s), self.b3_b(s),
                       self.b33_a(t), self.b33_b(t), self.bp(x)], 1)


class InceptionV3(Layer):
    """reference vision/models/inceptionv3.py."""

    def __init__(self, num_classes: int = 1000, with_pool: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _cbr(3, 32, 3, s=2), _cbr(32, 32, 3), _cbr(32, 64, 3, p=1),
            MaxPool2D(3, stride=2), _cbr(64, 80, 1), _cbr(80, 192, 3),
            MaxPool2D(3, stride=2))
        self.blocks = Sequential(
            _IncA(192, 32), _IncA(256, 64), _IncA(288, 64),
            _IncB(288),
            _IncC(768, 128), _IncC(768, 160), _IncC(768, 160),
            _IncC(768, 192),
            _IncD(768),
            _IncE(1280), _IncE(2048))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.5)
            self.fc = Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kw):
    return InceptionV3(**kw)


# ---------------------------------------------------------------------------
# MobileNetV3
# ---------------------------------------------------------------------------


class _SE(Layer):
    def __init__(self, c, r=4):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(c, c // r, 1)
        self.relu = ReLU()
        self.fc2 = Conv2D(c // r, c, 1)
        self.hs = Hardsigmoid()

    def forward(self, x):
        s = self.hs(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _MBV3Block(Layer):
    def __init__(self, in_c, exp, out_c, k, s, se, act):
        super().__init__()
        self.use_res = s == 1 and in_c == out_c
        layers = []
        if exp != in_c:
            layers.append(_cbr(in_c, exp, 1, act=act))
        layers.append(_cbr(exp, exp, k, s=s, p=k // 2, groups=exp, act=act))
        if se:
            layers.append(_SE(exp))
        layers += [Conv2D(exp, out_c, 1, bias_attr=False),
                   BatchNorm2D(out_c)]
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_V3_LARGE = [
    # k, exp, out, se, act, stride
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1)]

_V3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1)]


def _mk(v, scale):
    out = int(v * scale)
    return max(out + (8 - out % 8) % 8, 8) if out % 8 else max(out, 8)


class _MobileNetV3(Layer):
    def __init__(self, cfg, last_exp, num_classes=1000, scale=1.0,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        c = _mk(16, scale)
        layers = [_cbr(3, c, 3, s=2, p=1, act="hardswish")]
        for k, exp, out, se, act, s in cfg:
            layers.append(_MBV3Block(c, _mk(exp, scale), _mk(out, scale),
                                     k, s, se, act))
            c = _mk(out, scale)
        last_c = _mk(last_exp, scale)
        layers.append(_cbr(c, last_c, 1, act="hardswish"))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            hid = 1280 if last_exp == 960 else 1024
            self.classifier = Sequential(
                Linear(last_c, hid), Hardswish(), Dropout(0.2),
                Linear(hid, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Large(_MobileNetV3):
    """reference vision/models/mobilenetv3.py MobileNetV3Large."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_LARGE, 960, num_classes, scale, with_pool)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_SMALL, 576, num_classes, scale, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    return MobileNetV3Large(scale=scale, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    return MobileNetV3Small(scale=scale, **kw)


# ---------------------------------------------------------------------------
# ShuffleNetV2
# ---------------------------------------------------------------------------


def _channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w)
    x = x.permute(0, 2, 1, 3, 4)
    return x.reshape(n, c, h, w)


class _ShuffleUnit(Layer):
    def __init__(self, in_c, out_c, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            self.branch2 = Sequential(
                _cbr(in_c // 2, branch_c, 1, act=act),
                _cbr(branch_c, branch_c, 3, s=1, p=1, groups=branch_c,
                     act="none"),
                _cbr(branch_c, branch_c, 1, act=act))
        else:
            self.branch1 = Sequential(
                _cbr(in_c, in_c, 3, s=stride, p=1, groups=in_c, act="none"),
                _cbr(in_c, branch_c, 1, act=act))
            self.branch2 = Sequential(
                _cbr(in_c, branch_c, 1, act=act),
                _cbr(branch_c, branch_c, 3, s=stride, p=1, groups=branch_c,
                     act="none"),
                _cbr(branch_c, branch_c, 1, act=act))

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1 = x[:, :c]
            x2 = x[:, c:]
            out = torch.cat([x1, self.branch2(x2)], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return _channel_shuffle(out, 2)


_SHUFFLE_CFG = {0.25: (24, (24, 48, 96), 512),
                0.33: (24, (32, 64, 128), 512),
                0.5: (24, (48, 96, 192), 1024),
                1.0: (24, (116, 232, 464), 1024),
                1.5: (24, (176, 352, 704), 1024),
                2.0: (24, (244, 488, 976), 2048)}


class ShuffleNetV2(Layer):
    """reference vision/models/shufflenetv2.py."""

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        stem_c, stage_cs, last_c = _SHUFFLE_CFG[scale]
        self.stem = Sequential(_cbr(3, stem_c, 3, s=2, p=1, act=act),
                               MaxPool2D(3, stride=2, padding=1))
        blocks = []
        c = stem_c
        for sc in stage_cs:
            blocks.append(_ShuffleUnit(c, sc, 2, act))
            for _ in range(3 if sc == stage_cs[0] else
                           (7 if sc == stage_cs[1] else 3)):
                blocks.append(_ShuffleUnit(sc, sc, 1, act))
            c = sc
        self.blocks = Sequential(*blocks)
        self.last = _cbr(c, last_c, 1, act=act)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(last_c, num_classes)

    def forward(self, x):
        x = self.last(self.blocks(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return ShuffleNetV2(scale=0.25, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return ShuffleNetV2(scale=0.33, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return ShuffleNetV2(scale=0.5, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return ShuffleNetV2(scale=1.0, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return ShuffleNetV2(scale=1.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return ShuffleNetV2(scale=2.0, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return ShuffleNetV2(scale=1.0, act="swish", **kw)
