"""``paddle.vision.models`` (port of ``paddle_tpu/vision/models/``): the
ResNet family (``resnet.py``), the classic families (``classic.py``) and
DenseNet, GoogLeNet, InceptionV3, MobileNetV3 and ShuffleNetV2
(``classic2.py``)."""
from . import classic, classic2, resnet
from .classic import *  # noqa: F401,F403
from .classic2 import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .resnet import (BasicBlock, BottleneckBlock, resnext50_64x4d,
                     resnext101_32x4d, resnext101_64x4d, resnext152_32x4d)

__all__ = (classic.__all__ + classic2.__all__ + resnet.__all__
           + ["BasicBlock", "BottleneckBlock", "resnext50_64x4d",
              "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d"])
