"""``paddle.nn``: ``RMSNorm``, the loss layers, the gradient clips and
``nn.functional``."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layer_all

__all__ = (["functional", "ClipGradByValue", "ClipGradByNorm",
            "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]
           + [n for n in _layer_all if n != "loss"])
