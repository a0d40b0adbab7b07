"""Attention entry point over the repo's ``[B, S, H, D]`` layout.

Port of ``paddle_tpu/ops/pallas.py::flash_attention`` (:97-164). The TPU
version transposes to ``[B, H, S, D]``, pads head dims for Mosaic and falls
back to ``_chunked_attention`` (without dropout) where its block sizes do
not divide the lengths. Here the kernels read ``[B, S, H, D]`` through
their strides and take any length, so the dispatch is only the device rule:
the CPU runs the plain versions, CUDA runs K3 forward and the two backward
kernels, through :class:`~.flash_attention_kernel.FlashAttention` (the
library op ``paddle_tpu::flash_fwd`` while compiling).

Under ``FLAGS_flash_head_batched`` the router takes the head-batched route
(``flash_attention_hb.py``) where :func:`supports_hb` holds, and only on
the card, as the JAX router takes it only on the TPU (:131-141).

:func:`prefix_chunk_attention`, the port of
``paddle_tpu/ops/pallas.py::prefix_chunk_attention`` (:167-213), chunked
prefill's attention, is K3's prefix-chunk instance itself (defined in
``flash_attention_kernel.py``): no routing stands before it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..framework.amp_state import cast_inputs, check_outputs
from ..framework.flags import get_flags
from .flash_attention_hb import flash_attention_bshd_hb, supports_hb
from .flash_attention_kernel import (flash_attention_apply,
                                     prefix_chunk_attention)

__all__ = ["flash_attention", "prefix_chunk_attention"]

_HB = "FLAGS_flash_head_batched"


def _use_hb(q: torch.Tensor, k: torch.Tensor, dropout_p: float) -> bool:
    """The router's branch: the flag set, CUDA tensors, and shapes the
    head-batched route supports."""
    return (bool(get_flags(_HB)[_HB]) and q.device.type == "cuda"
            and supports_hb(q.shape, k.shape, dropout_p))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    dropout_p: float = 0.0,
                    seed: Optional[int] = None) -> torch.Tensor:
    """Softmax attention of q [B, Sq, Hq, D] over k/v [B, Sk, Hkv, D]
    (GQA: Hq a multiple of Hkv), bottom-right causal when ``causal``.
    ``dropout_p`` drops attention probabilities with the kernels' counter
    hash keyed by ``seed`` (default 0), the same mask in the forward and
    the backward. Differentiable. Returns [B, Sq, Hq, D]. White under
    AMP (q, k, v go to the AMP dtype); under ``FLAGS_check_nan_inf`` the
    output is checked."""
    q, k, v = cast_inputs("flash_attention", q, k, v)
    if _use_hb(q, k, dropout_p):
        out = flash_attention_bshd_hb(q, k, v, causal=causal,
                                      sm_scale=sm_scale)
    else:
        out = flash_attention_apply(q, k, v, causal, sm_scale,
                                    float(dropout_p),
                                    0 if seed is None else int(seed))
    check_outputs("flash_attention", out)
    return out
