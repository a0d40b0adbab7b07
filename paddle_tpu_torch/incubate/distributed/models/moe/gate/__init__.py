from .base_gate import BaseGate
from .naive_gate import NaiveGate
from .gshard_gate import GShardGate
from .switch_gate import SwitchGate

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]
