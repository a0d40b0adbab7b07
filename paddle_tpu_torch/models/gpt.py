"""GPT-3-family causal LM (port of ``paddle_tpu/models/gpt.py``).

Pre-LN transformer: learned position embeddings, LayerNorm, a GELU (tanh)
MLP, built from the port's tensor-parallel layers at degree 1
(``distributed/mp_layers.py``) and ``paddle.nn`` layers, with the
reference's parameter names and ``[in, out]`` linear layouts, so
``models/convert.py`` carries a JAX model's weights over as they are.

Attention is ``nn.functional.flash_attention(causal=True)``: on the card
K3 forward and K5/K6 in its backward, on the CPU their plain versions. The
packed ``qkv_proj`` output is head-major, ``[B, S, 3, heads, head_dim]``,
as the reference packs it. ``recompute="full"`` reruns each decoder layer
in the backward while the model trains (``distributed.fleet.recompute``,
which replays the port's generator, so dropout draws the same masks).

The reference's ``constraint(..., P(...))`` sharding hints are the
identity at tensor-parallel degree 1 and are left out; tensor parallelism
waits for the hybrid-parallel port (ROADMAP A11/A13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..distributed.fleet.recompute import recompute
from ..distributed.mp_layers import (ColumnParallelLinear,
                                     ParallelCrossEntropy, RowParallelLinear,
                                     VocabParallelEmbedding)
from ..nn import functional as F
from ..nn.layer.container import LayerList
from ..nn.layer.layers import Layer
from ..nn.layer.norm import LayerNorm
from ._utils import (IGNORE_INDEX, building_on, here, init_normal,
                     masked_lm_loss, seeded)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_config"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: Optional[int] = None  # None -> 4 * hidden
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    dropout: float = 0.0
    dtype: str = "float32"
    recompute: str = "none"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


# name: (hidden, layers, heads, vocab, positions)
_PRESETS = {
    "tiny": (64, 2, 4, 256, 128),
    "125m": (768, 12, 12, 50304, 2048),
    "1b3": (2048, 24, 16, 50304, 2048),
    "6b7": (4096, 32, 32, 50304, 2048),
}


def gpt_config(preset: str = "tiny", **overrides) -> GPTConfig:
    h, l, a, v, m = _PRESETS[preset]
    cfg = GPTConfig(hidden_size=h, num_hidden_layers=l, num_attention_heads=a,
                    vocab_size=v, max_position_embeddings=m)
    for k, val in overrides.items():
        setattr(cfg, k, val)
    return cfg


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__(dtype=config.dtype)
        self.config = config
        h = config.hidden_size
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, has_bias=True,
                                             **here())
        self.out_proj = RowParallelLinear(h, h, has_bias=True, **here())

    def forward(self, x):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        q, k, v = self.qkv_proj(x).reshape(b, s, 3, nh, hd).unbind(2)
        ctx, _ = F.flash_attention(q, k, v, causal=True, dropout=cfg.dropout,
                                   training=self.training)
        return self.out_proj(ctx.reshape(b, s, nh * hd))


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__(dtype=config.dtype)
        self.fc_in = ColumnParallelLinear(config.hidden_size, config.ffn_size,
                                          has_bias=True, **here())
        self.fc_out = RowParallelLinear(config.ffn_size, config.hidden_size,
                                        has_bias=True, **here())

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTDecoderLayer(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__(dtype=config.dtype)
        self.ln_1 = LayerNorm(config.hidden_size, epsilon=config.layer_norm_eps)
        self.attn = GPTAttention(config)
        self.ln_2 = LayerNorm(config.hidden_size, epsilon=config.layer_norm_eps)
        self.mlp = GPTMLP(config)
        self.dropout = config.dropout

    def forward(self, x):
        h = self.attn(self.ln_1(x))
        if self.dropout:
            h = F.dropout(h, self.dropout, training=self.training)
        x = x + h
        h = self.mlp(self.ln_2(x))
        if self.dropout:
            h = F.dropout(h, self.dropout, training=self.training)
        return x + h


class GPTModel(Layer):
    """Embeddings, the decoder stack and the final LayerNorm, built on
    ``device`` (default: the current place) in ``config.dtype`` with
    weights drawn from ``generator`` as :class:`GPTForCausalLM` draws
    them."""

    def __init__(self, config: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=config.dtype)
        if config.recompute not in ("none", "full"):
            raise ValueError(f"recompute must be 'none' or 'full', got "
                             f"{config.recompute!r}")
        self.config = config
        with building_on(device, config.dtype) as dev:
            self.embed_tokens = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, **here())
            self.embed_positions = VocabParallelEmbedding(
                config.max_position_embeddings, config.hidden_size,
                **here())
            self.layers = LayerList([GPTDecoderLayer(config)
                                     for _ in range(config.num_hidden_layers)])
            self.ln_f = LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps)
        init_normal(self, seeded(generator, dev))

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.embed_tokens(input_ids) + self.embed_positions(pos)
        for layer in self.layers:
            if self.config.recompute == "full" and self.training:
                x = recompute(layer, x)
            else:
                x = layer(x)
        return self.ln_f(x)


class GPTForCausalLM(Layer):
    """GPT with an untied LM head. Built on ``device`` (default: the
    current place, the CUDA card unless set otherwise) in
    ``config.dtype``, with weights drawn from ``generator`` (default: seed
    0 on that device): normal with std 0.02 (GPT-3's initializer range),
    biases 0, LayerNorm scales 1. ``model(ids)`` gives the logits,
    ``model(ids, labels)`` the mean cross entropy over the labels that are
    not ``IGNORE_INDEX``."""

    IGNORE_INDEX = IGNORE_INDEX

    def __init__(self, config: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=config.dtype)
        self.config = config
        with building_on(device, config.dtype) as dev:
            generator = seeded(generator, dev)
            self.model = GPTModel(config, generator=generator)
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                **here())
        self.loss_fn = ParallelCrossEntropy(ignore_index=self.IGNORE_INDEX)
        init_normal(self.lm_head, generator)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, input_ids, labels=None):
        logits = self.lm_head(self.model(input_ids))
        if labels is None:
            return logits
        return masked_lm_loss(self.loss_fn(logits, labels), labels,
                              self.IGNORE_INDEX)
