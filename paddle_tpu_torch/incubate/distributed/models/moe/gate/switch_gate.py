"""Switch-Transformer top-1 gate with its load-balancing loss (port of
``.../moe/gate/switch_gate.py``): while training the scores take a
multiplicative jitter uniform in [1 - eps, 1 + eps); aux loss =
E * sum(fraction of tokens * mean probability), as in the Switch paper."""
from __future__ import annotations

import torch

from .base_gate import one_hot
from .naive_gate import NaiveGate

__all__ = ["SwitchGate"]


class SwitchGate(NaiveGate):
    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 1, switch_eps: float = 0.1, capacity=(1.2, 2.4),
                 group=None):
        if topk != 1:
            raise ValueError("topk should be 1 in SwitchGate")
        super().__init__(d_model, num_expert, world_size, topk=1)
        self.switch_eps = switch_eps
        self.capacity = capacity

    def forward(self, inp):
        score = self.gate(inp)
        if self.training:
            score = score * self._uniform(score.shape, score,
                                          1.0 - self.switch_eps,
                                          1.0 + self.switch_eps)
        probs = torch.softmax(score.float(), dim=-1)
        top_val, top_idx = torch.topk(probs, 1, dim=-1)
        ce = one_hot(top_idx[..., 0], self.tot_expert).mean(0)
        me = probs.mean(0)
        self.set_loss((ce * me).sum() * self.tot_expert)
        return top_val, top_idx
