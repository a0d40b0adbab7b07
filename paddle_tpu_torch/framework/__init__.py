from .flags import define_flag, get_flags, set_flags
from .io import load, save

__all__ = ["define_flag", "get_flags", "set_flags", "save", "load"]
