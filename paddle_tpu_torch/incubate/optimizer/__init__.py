"""paddle.incubate.optimizer counterpart."""
from .distributed_fused_lamb import DistributedFusedLamb

__all__ = ["DistributedFusedLamb"]
