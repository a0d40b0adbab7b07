"""Attention entry point over the repo's ``[B, S, H, D]`` layout.

Port of ``paddle_tpu/ops/pallas.py::flash_attention`` (:97-164). The TPU
version transposes to ``[B, H, S, D]``, pads head dims for Mosaic and falls
back to ``_chunked_attention`` (without dropout) where its block sizes do
not divide the lengths. Here the kernels read ``[B, S, H, D]`` through
their strides and take any length, so the dispatch is only the device rule:
the CPU runs the plain versions, CUDA runs K3 forward and the two backward
kernels, through :class:`~.flash_attention_kernel.FlashAttention`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention_kernel import FlashAttention

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    dropout_p: float = 0.0,
                    seed: Optional[int] = None) -> torch.Tensor:
    """Softmax attention of q [B, Sq, Hq, D] over k/v [B, Sk, Hkv, D]
    (GQA: Hq a multiple of Hkv), bottom-right causal when ``causal``.
    ``dropout_p`` drops attention probabilities with the kernels' counter
    hash keyed by ``seed`` (default 0), the same mask in the forward and
    the backward. Differentiable. Returns [B, Sq, Hq, D]."""
    return FlashAttention.apply(q, k, v, causal, sm_scale, float(dropout_p),
                                0 if seed is None else int(seed))
