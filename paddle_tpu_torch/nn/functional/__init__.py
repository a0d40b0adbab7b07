"""``paddle.nn.functional``: the losses (port of
``paddle_tpu/nn/functional/loss.py``)."""
from . import loss
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss_all

__all__ = ["loss"] + list(_loss_all)
