from .layer import RMSNorm

__all__ = ["RMSNorm"]
