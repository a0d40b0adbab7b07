"""Memory-efficient attention (port of
``paddle_tpu/incubate/nn/memory_efficient_attention.py``): without a bias
it is K3, non-causal (``ops.attention.flash_attention``; its backward K5
and K6); with ``attn_bias`` it is the reference's composition, fp32 scores
plus the bias, softmax, cast to the query's dtype, times V."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...ops.attention import flash_attention

__all__ = ["memory_efficient_attention"]


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale: Optional[float] = None,
                               training: bool = True):
    """q/k/v [B, S, H, D]; ``attn_bias`` broadcasts to [B, H, Sq, Sk].
    ``p`` is kept for the reference's signature, which applies no
    dropout either."""
    if attn_bias is None:
        return flash_attention(query, key, value, causal=False,
                               sm_scale=scale)
    s = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (query, key, value))
    sc = torch.matmul(qt, kt.transpose(-1, -2)).float() * s
    probs = torch.softmax(sc + attn_bias.float(), dim=-1).to(query.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)
