"""``paddle.hapi`` (port of ``paddle_tpu/hapi``): ``Model``, the callbacks,
``summary`` and ``flops``."""
from . import callbacks
from .dynamic_flops import flops
from .model import Model
from .model_summary import summary

__all__ = ["Model", "summary", "flops", "callbacks"]
