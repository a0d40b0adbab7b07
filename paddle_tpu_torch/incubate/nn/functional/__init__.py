"""incubate.nn.functional counterpart (port of
``paddle_tpu/incubate/nn/functional/__init__.py``): the three functions
the fused transformer path calls, each on a Hopper kernel.

- ``fused_layer_norm`` -> K8 (``ops.fused_kernels.fused_layer_norm``);
- ``fused_bias_dropout_residual_layer_norm``: bias, dropout, then K8 with
  the residual;
- ``masked_multihead_attention`` -> K7 (``ops.decode_attention``), without
  autograd, as the reference's decode kernel has no gradient.

Dropout draws its mask from a ``torch.Generator``: the JAX package's
random bits are not reproduced.
"""
from __future__ import annotations

from typing import Optional

import torch

from ....ops.decode_attention import decode_mha
from ....ops.fused_kernels import fused_layer_norm as _ln

__all__ = ["fused_layer_norm", "fused_bias_dropout_residual_layer_norm",
           "masked_multihead_attention"]

_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x: torch.Tensor, p: float, mode: str = "upscale_in_train",
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Training-time dropout: zero each element with probability ``p``;
    ``upscale_in_train`` divides the kept ones by 1 - p, as the reference's
    ``nn.functional.dropout`` does."""
    if mode not in _MODES:
        raise ValueError(f"dropout mode must be one of {_MODES}, got {mode!r}")
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    y = x * keep
    return y / (1.0 - p) if mode == "upscale_in_train" else y


def fused_layer_norm(x: torch.Tensor, norm_weight=None, norm_bias=None,
                     epsilon: float = 1e-5, residual=None,
                     bias=None) -> torch.Tensor:
    """LN(x [+ bias] [+ residual]) * norm_weight + norm_bias (K8)."""
    return _ln(x, residual, bias, norm_weight, norm_bias, epsilon)


def fused_bias_dropout_residual_layer_norm(
        x: torch.Tensor, residual: torch.Tensor, bias=None, ln_scale=None,
        ln_bias=None, dropout_rate: float = 0.5, ln_epsilon: float = 1e-5,
        training: bool = True, mode: str = "upscale_in_train",
        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """LN(residual + dropout(x + bias)) * ln_scale + ln_bias; dropout only
    while training, its mask drawn from ``generator``."""
    y = x if bias is None else x + bias
    if dropout_rate > 0.0 and training:
        y = dropout(y, dropout_rate, mode, generator)
    return fused_layer_norm(y, ln_scale, ln_bias, ln_epsilon,
                            residual=residual)


def masked_multihead_attention(x: torch.Tensor, cache_kv, seq_lens):
    """Decode-time attention of x [B, H, D] (this step's query) over
    ``cache_kv = (k_cache, v_cache)`` [B, S, H, D], row b over its first
    ``seq_lens[b]`` positions (K7). No gradient."""
    if cache_kv is None or seq_lens is None:
        raise ValueError("cache_kv and seq_lens are required")
    k_cache, v_cache = cache_kv
    with torch.no_grad():
        return decode_mha(x, k_cache, v_cache, seq_lens)
