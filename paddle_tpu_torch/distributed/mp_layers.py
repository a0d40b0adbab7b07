"""Megatron-style parallel layers at tensor-parallel degree 1.

Port of ``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py`` (:32-172).
Names, parameter names and shapes stay those of the reference, so weights
carry across as they are: embeddings ``[vocab, hidden]``, linear weights
``[in, out]`` applied as ``x @ W``. Sharding over a mesh (the reference's
``mp`` axis) is not ported yet: each layer holds and applies its whole
weight.

Under AMP the embedding casts its weight as the reference's ``embedding``
op (gray), the linears their input and weight as ``linear`` (white) and the
cross entropy its logits as ``c_softmax_with_cross_entropy`` (black), each
output checked under ``FLAGS_check_nan_inf``
(``framework/amp_state.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..framework.amp_state import cast_inputs, check_outputs

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        (w,) = cast_inputs("embedding", self.weight)
        out = F.embedding(ids.long(), w)
        check_outputs("embedding", out)
        return out


class _Linear(nn.Module):
    """``y = x @ W (+ b)`` with ``W [in, out]``."""

    def __init__(self, in_features: int, out_features: int,
                 has_bias: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias: Optional[nn.Parameter] = (
            nn.Parameter(torch.zeros(out_features, device=device,
                                     dtype=dtype)) if has_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = cast_inputs("linear", x, self.weight, self.bias)
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        check_outputs("linear", y)
        return y


class ColumnParallelLinear(_Linear):
    """Output dim sharded over the mp axis in the reference; whole here,
    so ``gather_output`` has nothing to gather."""


class RowParallelLinear(_Linear):
    """Input dim sharded over the mp axis in the reference; whole here,
    so ``input_is_parallel`` has nothing to reduce."""


class ParallelCrossEntropy(nn.Module):
    """Softmax cross entropy per position: ``[..., V]`` logits and ``[...]``
    labels give ``[..., 1]`` losses, 0 where the label is
    ``ignore_index``. Computed in the logits' dtype, as the reference's
    ``_c_softmax_with_cross_entropy`` does."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits: torch.Tensor,
                label: torch.Tensor) -> torch.Tensor:
        (logits,) = cast_inputs("c_softmax_with_cross_entropy", logits)
        ignored = label == self.ignore_index
        safe = torch.where(ignored, torch.zeros_like(label), label).long()
        gmax = logits.amax(-1, keepdim=True)
        gsum = torch.exp(logits - gmax).sum(-1, keepdim=True)
        tgt = torch.gather(logits, -1, safe[..., None])
        loss = torch.log(gsum) + gmax - tgt
        loss = loss.masked_fill(ignored[..., None], 0.0)
        check_outputs("c_softmax_with_cross_entropy", loss)
        return loss
