"""``paddle.hapi`` (port of ``paddle_tpu/hapi``): ``Model`` and the
callbacks. ``summary`` and ``flops`` (``dynamic_flops``) are not ported
yet (ROADMAP A14d)."""
from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
