"""paddle.incubate.distributed counterpart (port of
``paddle_tpu/incubate/distributed``): the MoE model layer."""
from . import models

__all__ = ["models"]
