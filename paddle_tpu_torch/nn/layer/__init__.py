from . import loss
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss_all
from .norm import RMSNorm

__all__ = ["RMSNorm", "loss"] + list(_loss_all)
