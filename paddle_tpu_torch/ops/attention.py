"""Attention entry point over the repo's ``[B, S, H, D]`` layout.

Port of ``paddle_tpu/ops/pallas.py::flash_attention`` (:97-164). The TPU
version transposes to ``[B, H, S, D]``, pads head dims for Mosaic and falls
back to ``_chunked_attention`` where its block sizes do not divide the
lengths. Here the kernel (K3) reads ``[B, S, H, D]`` through its strides and
takes any length, so the dispatch is only the device rule: the CPU runs the
plain version (which follows ``_chunked_attention``), CUDA runs K3.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention_kernel import flash_attention_bshd

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    dropout_p: float = 0.0) -> torch.Tensor:
    """Softmax attention of q [B, Sq, Hq, D] over k/v [B, Sk, Hkv, D]
    (GQA: Hq a multiple of Hkv), bottom-right causal when ``causal``.
    Returns [B, Sq, Hq, D]."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet: the TPU kernel's "
            "in-kernel hash comes with the backward kernels")
    out, _ = flash_attention_bshd(q, k, v, causal=causal, sm_scale=sm_scale)
    return out
