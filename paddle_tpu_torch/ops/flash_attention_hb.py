"""Head-batched flash attention: port of
``paddle_tpu/ops/flash_attention_hb.py`` (``flash_attention_bshd_hb``,
``supports_hb``; pallas_calls at :167, :297 and :315).

The TPU kernel computes the same attention as the per-head one: bottom-
right-causal softmax attention over native ``[B, S, H, D]`` tensors, fp32
softmax, with its own VJP. It exists because a per-head ``[B, S, H, D]``
block breaks the TPU's (8, 128) tiling, so the per-head kernel needs
transposes to ``[B, H, S, D]`` and the head-batched one avoids them. K3
forward and the K5/K6 backward kernels already read ``[B, S, H, D]``
through their strides, so on Hopper they are this kernel's counterpart:
the route below calls :class:`~.flash_attention_kernel.FlashAttention`
and writes no kernel of its own.

Kept from the TPU function: ``Hq == Hkv`` and no dropout
(:func:`supports_hb`; :func:`flash_attention_bshd_hb` raises
``ValueError`` otherwise). Not carried over, because they exist only for
Mosaic and VMEM on the TPU: the VMEM budget of the score block
(``2 H bq bk 4 <= 16 MB``), the condition that the block sizes tile the
sequence lengths (the kernels here mask ragged edges), ``D % 128`` and the
``PADDLE_TPU_HB_ON_DEVICE`` gate. ``block_q``/``block_k`` are accepted
and checked as positive ints; the kernels keep their own 64-row tiles.

``flash_attention_bshd_hb.calls`` counts the calls of the route (a route,
not a kernel: the kernels it reaches count their own launches).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention_kernel import _check_shapes, flash_attention_apply

__all__ = ["flash_attention_bshd_hb", "supports_hb"]


def supports_hb(q_shape, k_shape, dropout_p: float,
                interpret: Optional[bool] = None, block: int = 512) -> bool:
    """Whether the head-batched route takes these shapes: as many kv heads
    as query heads and no dropout. ``interpret`` and ``block`` enter only
    the TPU's Mosaic and VMEM conditions, which the port does not have."""
    return q_shape[2] == k_shape[2] and dropout_p == 0.0


def _check_block(name: str, value) -> None:
    if isinstance(value, bool) or not isinstance(value, int) or value <= 0:
        raise ValueError(f"flash_attention_bshd_hb: {name} must be a "
                         f"positive int, got {value!r}")


def flash_attention_bshd_hb(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            block_q: int = 512, block_k: int = 512
                            ) -> torch.Tensor:
    """Flash attention over q, k, v ``[B, S, H, D]`` with as many kv heads
    as query heads and no dropout; differentiable. Returns
    ``[B, Sq, H, D]``."""
    _check_block("block_q", block_q)
    _check_block("block_k", block_k)
    _check_shapes(q, k, v)
    if q.shape[2] != k.shape[2]:
        raise ValueError(
            f"flash_attention_bshd_hb takes Hq == Hkv, got {q.shape[2]} "
            f"query and {k.shape[2]} kv heads")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    flash_attention_bshd_hb.calls += 1
    return flash_attention_apply(q, k, v, causal, float(sm_scale), 0.0, 0)


flash_attention_bshd_hb.calls = 0
