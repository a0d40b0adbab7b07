"""incubate.nn.functional counterpart (port of
``paddle_tpu/incubate/nn/functional/__init__.py``): the fused-op
functions, each on the Hopper kernel the reference's reaches.

- ``fused_rms_norm`` -> K1 (``ops.fused_kernels.rms_norm``);
- ``fused_layer_norm`` -> K8 (``ops.fused_kernels.fused_layer_norm``);
- ``fused_bias_dropout_residual_layer_norm``: bias, dropout, then K8 with
  the residual;
- ``fused_rotary_position_embedding`` -> K2 (``ops.fused_kernels.
  fused_rope``) for the NeoX layout with positions 0..S-1, where the
  reference calls its kernel; with ``position_ids`` or the interleaved
  (GPT-J) layout the rotation is torch ops, as the reference composes it
  in jnp;
- ``masked_multihead_attention`` -> K7 (``ops.decode_attention``), without
  autograd, as the reference's decode kernel has no gradient;
- ``weight_quantize`` / ``weight_dequantize`` / ``weight_only_linear``
  (per-output-channel int8 or [-7, 7] "int4" weights in the reference's
  untransposed ``[in, out]`` layout) and ``fused_linear`` /
  ``fused_linear_activation``: torch ops, as the reference's are XLA.

Dropout draws its mask from a ``torch.Generator``: the JAX package's
random bits are not reproduced.
"""
from __future__ import annotations

from typing import Optional

import torch

from ....ops.decode_attention import decode_mha
from ....ops.fused_kernels import fused_layer_norm as _ln
from ....ops.fused_kernels import fused_rope, rms_norm

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_bias_dropout_residual_layer_norm",
           "fused_rotary_position_embedding", "masked_multihead_attention",
           "fused_linear", "fused_linear_activation",
           "weight_quantize", "weight_dequantize", "weight_only_linear"]

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


def weight_quantize(weight: torch.Tensor, algo: str = "weight_only_int8"):
    """Per-output-channel weight compression: ``(int8 weights, fp32
    scales [out])`` for ``weight`` [in, out], scale = max |w| over the
    input dim / qmax (127 for int8; 7 for int4, one value a byte)."""
    if algo not in ("weight_only_int8", "weight_only_int4"):
        raise ValueError(f"unsupported algo {algo!r}")
    qmax = 127.0 if algo.endswith("int8") else 7.0
    w = weight.float()
    scale = (w.abs().amax(0) / qmax).clamp_min(1e-10)
    qw = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return qw, scale


def weight_dequantize(qweight: torch.Tensor, scale: torch.Tensor,
                      algo: str = "weight_only_int8", out_dtype=None):
    """The inverse of :func:`weight_quantize`, in fp32 unless
    ``out_dtype`` is given."""
    out = qweight.float() * scale.float()
    return out if out_dtype is None else out.to(out_dtype)


def weight_only_linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
                       weight_scale=None, weight_dtype: str = "int8",
                       arch=None, group_size=-1) -> torch.Tensor:
    """x @ (int8 weight * scale) [+ bias], the weight dequantized in x's
    dtype."""
    if weight_scale is None:
        raise ValueError("weight_scale is required (from weight_quantize)")
    if group_size not in (-1, None):
        raise NotImplementedError(
            "group-wise scales are not supported; quantize with "
            "weight_quantize (per-output-channel scales, group_size=-1)")
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"unsupported weight_dtype {weight_dtype!r}")
    out = x @ (weight.to(x.dtype) * weight_scale.to(x.dtype))
    return out if bias is None else out + bias


def fused_rms_norm(x: torch.Tensor, norm_weight: torch.Tensor,
                   epsilon: float = 1e-6, **kw) -> torch.Tensor:
    """x / sqrt(mean(x^2, -1) + epsilon) * norm_weight (K1)."""
    return rms_norm(x, norm_weight, epsilon)


def _rope_table(t) -> Optional[torch.Tensor]:
    """cos or sin as [S, D/2]: paddle's [1, S, 1, D] layout (halves
    duplicated) is cut to its first half."""
    if t is None:
        return None
    t = torch.as_tensor(t)
    return t[0, :, 0, : t.shape[-1] // 2] if t.dim() == 4 else t


def _rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
            neox: bool) -> torch.Tensor:
    """The reference's jnp rotation: tables [S, D/2] or, gathered by
    position, [B, S, D/2]."""
    c = c[:, :, None, :] if c.dim() == 3 else c[None, :, None, :]
    s = s[:, :, None, :] if s.dim() == 3 else s[None, :, None, :]
    if neox:
        d2 = x.shape[-1] // 2
        x1, x2 = x[..., :d2], x[..., d2:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)
    xp = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x1, x2 = xp[..., 0], xp[..., 1]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                       -1).reshape(x.shape)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style: bool = True):
    """Rotary embedding of each of q, k, v [B, S, H, D] that is given, by
    cos/sin [S, D/2] (or paddle's [1, S, 1, D]); ``position_ids`` [B, S]
    picks each token's row. Returns a tuple of three (None where an input
    was None). K2 for the NeoX layout without ``position_ids``."""
    cos, sin = _rope_table(cos), _rope_table(sin)
    if cos is None or sin is None:
        raise ValueError("cos and sin are required")
    if position_ids is not None:
        pid = torch.as_tensor(position_ids, device=cos.device).long()
        cos, sin = cos[pid], sin[pid]              # [B, S, D/2]
    use_kernel = position_ids is None and use_neox_rotary_style
    return tuple(
        None if t is None else
        fused_rope(t, cos, sin) if use_kernel else
        _rotate(t, cos, sin, use_neox_rotary_style)
        for t in (q, k, v))


def fused_linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
                 transpose_weight: bool = False, name=None) -> torch.Tensor:
    """x @ W [+ bias], W [in, out] (or [out, in] with
    ``transpose_weight``)."""
    out = x @ (weight.T if transpose_weight else weight)
    return out if bias is None else out + bias


def fused_linear_activation(x: torch.Tensor, y: torch.Tensor, bias,
                            trans_x: bool = False, trans_y: bool = False,
                            activation: str = "gelu") -> torch.Tensor:
    """act(x @ y + bias), each operand's last two dims transposed where
    asked; ``activation`` "gelu" (exact), "relu", or anything else for
    none."""
    out = (x.transpose(-1, -2) if trans_x else x) @ (
        y.transpose(-1, -2) if trans_y else y)
    if bias is not None:
        out = out + bias
    if activation == "gelu":
        return torch.nn.functional.gelu(out)
    if activation == "relu":
        return torch.relu(out)
    return out
