"""Decode-step attention dispatch: one query token per row over a dense KV
cache (port of ``paddle_tpu/ops/_decode.py::gqa_decode_attention``).

The TPU package sent MHA to its Pallas kernel and GQA to a grouped XLA
einsum, because that kernel was MHA-only. K7 takes both, so the dispatch
here is only the device rule of every kernel wrapper: a CUDA tensor
launches K7, a CPU tensor runs its plain version. Tensor-parallel serving
(the reference's ``tp`` argument) is not ported.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_mha

__all__ = ["gqa_decode_attention"]


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         seq_lens: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D]; k/v_cache [B, S, Hkv, D]; seq_lens [B] int32 valid
    rows (the current token's K/V already written at seq_lens - 1).
    Returns [B, Hq, D] in q's dtype."""
    return decode_mha(q, k_cache, v_cache, seq_lens)
