"""Fused transformer layers (port of
``paddle_tpu/incubate/nn/layer/fused_transformer.py``):
``FusedBiasDropoutResidualLayerNorm`` and ``FusedMultiTransformer``, a
pre-LN GPT-style decoder stack with optional dense KV caches.

Kernels on the path: both LayerNorms of every layer -> K8
``fused_layer_norm``; the causal context pass -> K3 flash forward (with
its backward kernels under autograd); every cached decode step -> K7
``decode_mha`` through ``masked_multihead_attention``. A context pass with
an explicit ``attn_mask`` runs plain masked attention, as the reference
sends it to ``_sdpa_ref``, which has no Pallas kernel. Both layers are
differentiable through K8's and K3's autograd Functions.

Parameters carry the reference's names (``ln_scales_0``,
``qkv_weights_0``, ..., ``ffn2_biases_{L-1}``) and layouts, so
``models.convert.load_paddle_params`` loads a JAX layer's weights as they
are: ``qkv_weights`` [3E, E] and ``linear_weights`` [E, E] are applied
transposed (``x @ W^T``), ``ffn1_weights`` [E, F] and ``ffn2_weights``
[F, E] as they are (``x @ W``). Cache writes happen in place.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....device import get_device
from ....ops.attention import flash_attention
from .. import functional as incubate_F

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedMultiTransformer"]


def _xavier_uniform(shape, generator, **kw) -> nn.Parameter:
    """``create_parameter``'s default initializer for a weight: uniform in
    +-sqrt(6 / (fan_in + fan_out))."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    w = torch.empty(shape, **kw)
    return nn.Parameter(w.uniform_(-limit, limit, generator=generator))


def _const(n: int, value: float, **kw) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), value, **kw))


def _masked_attention(q, k, v, attn_mask) -> torch.Tensor:
    """Softmax attention of [B, S, H, D] operands under ``attn_mask``
    (bool: keep where True; float: added to the scores), broadcastable to
    [B, H, Sq, Sk], with no causal mask of its own: ``_sdpa_ref``'s math
    (scores in the input dtype, softmax in fp32, probabilities cast back
    before P.V)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = (qt @ kt.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    scores = scores.float()
    mask = torch.as_tensor(attn_mask, device=q.device)
    if mask.dtype == torch.bool:
        scores = scores.masked_fill(~mask, float("-inf"))
    else:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return (probs @ vt).transpose(1, 2)


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """out = LN(residual + dropout(x + linear_bias)) * ln_scale + ln_bias
    (K8); dropout only while training, its mask drawn from ``generator``."""

    def __init__(self, embed_dim: int, dropout_rate: float = 0.5,
                 epsilon: float = 1e-5, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=get_device(device), dtype=dtype or torch.float32)
        self.embed_dim = embed_dim
        self._dropout_rate = dropout_rate
        self._epsilon = epsilon
        self._generator = generator
        self.linear_bias = _const(embed_dim, 0.0, **kw)
        self.ln_scale = _const(embed_dim, 1.0, **kw)
        self.ln_bias = _const(embed_dim, 0.0, **kw)

    def forward(self, x, residual):
        return incubate_F.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self._dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            generator=self._generator)

    def extra_repr(self):
        return f"embed_dim={self.embed_dim}, dropout={self._dropout_rate}"


_PARAMS = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
           "linear_weights", "linear_biases", "ffn_ln_scales",
           "ffn_ln_biases", "ffn1_weights", "ffn1_biases", "ffn2_weights",
           "ffn2_biases")


class FusedMultiTransformer(nn.Module):
    """A pre-LN decoder stack of ``num_layers`` layers (reference
    fused_transformer.py:1021).

    ``forward(src, attn_mask=None, caches=None, seq_lens=None,
    time_step=None)``:

    - context pass (``time_step`` None): causal attention over src [B, S,
      E] (K3), or ``attn_mask`` attention when a mask is given; with
      ``caches`` it fills each layer's (k, v) at [0, S) and returns (out,
      caches);
    - decode pass (``time_step`` given): src [B, 1, E]; with ``seq_lens``
      (row b holds seq_lens[b] tokens) row b writes its K/V at seq_lens[b]
      and attends [0, seq_lens[b] + 1); without, every row writes at
      ``time_step`` and attends [0, time_step] (K7). Returns (out, caches).

    Built on ``device`` (default: the CUDA card) in ``dtype`` (default
    fp32), weights XavierUniform from ``generator``, biases 0, LN scales 1;
    dropout (training only) draws from the same generator."""

    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int,
                 dropout_rate: float = 0.0, activation: str = "gelu",
                 normalize_before: bool = True, epsilon: float = 1e-5,
                 num_layers: int = 1, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError("post-LN FusedMultiTransformer not "
                                      "supported (pre-LN is the LLM path)")
        if activation not in ("gelu", "relu"):
            raise ValueError(f"activation must be 'gelu' or 'relu', got "
                             f"{activation!r}")
        if num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {num_layers}")
        dev = get_device(device)
        kw = dict(device=dev, dtype=dtype or torch.float32)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self._epsilon = epsilon
        self._dropout_rate = dropout_rate
        self._generator = generator
        self.activation = activation
        self.num_layers = num_layers
        e, f = embed_dim, dim_feedforward
        for name in _PARAMS:
            setattr(self, name, [])
        for i in range(num_layers):
            made = {
                "ln_scales": _const(e, 1.0, **kw),
                "ln_biases": _const(e, 0.0, **kw),
                "qkv_weights": _xavier_uniform((3 * e, e), generator, **kw),
                "qkv_biases": _const(3 * e, 0.0, **kw),
                "linear_weights": _xavier_uniform((e, e), generator, **kw),
                "linear_biases": _const(e, 0.0, **kw),
                "ffn_ln_scales": _const(e, 1.0, **kw),
                "ffn_ln_biases": _const(e, 0.0, **kw),
                "ffn1_weights": _xavier_uniform((e, f), generator, **kw),
                "ffn1_biases": _const(f, 0.0, **kw),
                "ffn2_weights": _xavier_uniform((f, e), generator, **kw),
                "ffn2_biases": _const(e, 0.0, **kw)}
            for name in _PARAMS:
                getattr(self, name).append(made[name])
                self.register_parameter(f"{name}_{i}", made[name])

    def _act(self, x):
        return F.gelu(x) if self.activation == "gelu" else F.relu(x)

    def _dropout(self, x):
        if self._dropout_rate > 0.0 and self.training:
            return incubate_F.dropout(x, self._dropout_rate,
                                      generator=self._generator)
        return x

    def forward(self, src, attn_mask=None, caches=None, seq_lens=None,
                time_step=None):
        b, s, e = src.shape
        h, hd = self.num_heads, self.head_dim
        decode = time_step is not None
        if decode:
            if attn_mask is not None:
                raise NotImplementedError(
                    "FusedMultiTransformer decode supports ragged batches "
                    "via seq_lens (prefix masking), not arbitrary attn_mask "
                    "- pass seq_lens instead")
            if seq_lens is not None:
                # row b holds seq_lens[b] tokens: write there, attend one more
                pos = torch.as_tensor(seq_lens, device=src.device).long()
                rows = torch.arange(b, device=src.device)
            else:
                pos = int(time_step)
                rows = slice(None)
            lens = (pos + 1 if seq_lens is not None else torch.full(
                (b,), pos + 1, device=src.device)).to(torch.int32)
        x = src
        for i in range(self.num_layers):
            resid = x
            xn = incubate_F.fused_layer_norm(x, self.ln_scales[i],
                                             self.ln_biases[i], self._epsilon)
            qkv = F.linear(xn, self.qkv_weights[i], self.qkv_biases[i])
            q, k, v = (t.reshape(b, s, h, hd) for t in qkv.chunk(3, dim=-1))
            if decode:
                kc, vc = caches[i]
                kc[rows, pos] = k[:, 0].to(kc.dtype)
                vc[rows, pos] = v[:, 0].to(vc.dtype)
                ctx = incubate_F.masked_multihead_attention(
                    q.reshape(b, h, hd), (kc, vc), lens).reshape(b, 1, e)
            else:
                ctx = (flash_attention(q, k, v, causal=True)
                       if attn_mask is None
                       else _masked_attention(q, k, v, attn_mask))
                ctx = ctx.reshape(b, s, e)
                if caches is not None:
                    kc, vc = caches[i]
                    kc[:, :s] = k.to(kc.dtype)
                    vc[:, :s] = v.to(vc.dtype)
            attn_out = self._dropout(F.linear(ctx, self.linear_weights[i],
                                              self.linear_biases[i]))
            # the residual stream carries the un-normalized sum; LN output
            # feeds only the FFN
            r1 = resid + attn_out
            x_ln = incubate_F.fused_layer_norm(r1, self.ffn_ln_scales[i],
                                               self.ffn_ln_biases[i],
                                               self._epsilon)
            y = self._act(F.linear(x_ln, self.ffn1_weights[i].t(),
                                   self.ffn1_biases[i]))
            y = self._dropout(F.linear(y, self.ffn2_weights[i].t(),
                                       self.ffn2_biases[i]))
            x = r1 + y
        if caches is not None or decode:
            return x, caches
        return x

    @staticmethod
    def make_caches(num_layers: int, batch: int, max_seq: int,
                    num_heads: int, head_dim: int,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> List[tuple]:
        """Per-layer zero caches (k, v) [batch, max_seq, num_heads,
        head_dim] on ``device`` (default: the CUDA card)."""
        kw = dict(dtype=dtype, device=get_device(device))
        shape = (batch, max_seq, num_heads, head_dim)
        return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in range(num_layers)]
