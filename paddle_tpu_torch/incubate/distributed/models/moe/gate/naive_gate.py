"""Naive top-k gate (port of ``.../moe/gate/naive_gate.py``): a Linear
scorer with top-k selection, no auxiliary loss."""
from __future__ import annotations

import torch

from ......nn.layer.common import Linear
from .base_gate import BaseGate

__all__ = ["NaiveGate"]


class NaiveGate(BaseGate):
    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2):
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert)
        self.top_k = topk

    def forward(self, inp, return_all_scores=False):
        gate_score = self.gate(inp)
        # the weights are the softmax over the selected k (probability-
        # like, as the dispatch's renormalisation over kept choices wants)
        top_val, idx = torch.topk(gate_score, self.top_k, dim=-1)
        val = torch.softmax(top_val.float(), dim=-1)
        if return_all_scores:
            return val, idx, gate_score
        return val, idx
