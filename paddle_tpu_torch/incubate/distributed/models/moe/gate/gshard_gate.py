"""GShard top-2 gate with its load-balancing auxiliary loss (port of
``.../moe/gate/gshard_gate.py``): top-2 over the softmax of the scores,
aux loss = mean(ce * me) * E^2 as in the GShard paper, and, with
``random_routing``, the second expert dropped where its weight is below a
uniform draw times half the first's."""
from __future__ import annotations

import torch

from .base_gate import one_hot
from .naive_gate import NaiveGate

__all__ = ["GShardGate"]


class GShardGate(NaiveGate):
    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity=(1.2, 2.4), random_routing=True,
                 group=None):
        if topk != 2:
            raise ValueError("topk should be 2 in GShardGate")
        super().__init__(d_model, num_expert, world_size, topk=2)
        self.capacity = capacity
        self.random_routing = random_routing

    def forward(self, x):
        probs = torch.softmax(self.gate(x).float(), dim=-1)
        top_val, top_idx = torch.topk(probs, 2, dim=-1)
        ce = one_hot(top_idx[..., 0], self.tot_expert).mean(0)
        me = probs.mean(0)
        self.set_loss((ce * me).mean() * self.tot_expert ** 2)
        if self.random_routing:
            r = self._uniform(top_val[..., 1].shape, x)
            keep2 = top_val[..., 1] > r * top_val[..., 0] / 2.0
            top_idx = torch.stack(
                [top_idx[..., 0],
                 torch.where(keep2, top_idx[..., 1], -1)], dim=-1)
        return top_val, top_idx
