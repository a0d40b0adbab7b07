"""paddle.incubate counterpart (port of ``paddle_tpu/incubate``): the
fused layers and functions under ``incubate.nn`` and the MoE layer under
``incubate.distributed.models.moe``."""
from . import distributed, nn

__all__ = ["distributed", "nn"]
