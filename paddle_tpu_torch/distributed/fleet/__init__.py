from .recompute import recompute

__all__ = ["recompute"]
