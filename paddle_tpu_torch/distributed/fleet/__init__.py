from . import utils
from .recompute import recompute

__all__ = ["recompute", "utils"]
