"""paddle.incubate counterpart (port of ``paddle_tpu/incubate``): only what
the ``FusedMultiTransformer`` path uses, under ``incubate.nn``."""
from . import nn

__all__ = ["nn"]
