"""``paddle.nn`` (port of ``paddle_tpu/nn``): ``Layer`` and its
containers, ``Parameter`` and ``ParamAttr``, the initializers, the
activation, common, norm, loss, convolution, pooling, recurrent and
transformer layers, ``nn.functional``, the gradient clips, ``nn.utils``
and the decoders (``BeamSearchDecoder``, ``dynamic_decode``, the
``decode`` module)."""
from . import decode, functional, initializer, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .decode import BeamSearchDecoder, dynamic_decode
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layer_all
from .param_attr import ParamAttr
from .parameter import Parameter

__all__ = (["functional", "initializer", "utils", "ClipGradByValue",
            "ClipGradByNorm", "ClipGradByGlobalNorm", "clip_grad_norm_",
            "clip_grad_value_", "ParamAttr", "Parameter", "decode",
            "BeamSearchDecoder", "dynamic_decode"]
           + [n for n in _layer_all if n != "loss"])
