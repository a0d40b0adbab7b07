"""Mixture-of-Experts (port of
``paddle_tpu/incubate/distributed/models/moe``): ``MoELayer`` and its
gates."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .moe_layer import MoELayer

__all__ = ["MoELayer", "BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]
