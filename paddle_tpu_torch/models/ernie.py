"""ERNIE-MoE encoder (port of ``paddle_tpu/models/ernie.py``).

A bidirectional pre-LN transformer encoder in the ERNIE 3.0 shape with a
Mixture-of-Experts FFN on every ``moe_every``-th layer (GShard top-2
gate, experts ``Linear-GELU-Linear``, ``incubate.distributed.models.moe``)
and an MLM head. The other pieces are the port's tensor-parallel layers at
degree 1 and ``paddle.nn`` layers, with the reference's parameter names and
``[in, out]`` linear layouts, so ``models/convert.py`` carries a JAX
model's weights over as they are.

Attention is ``nn.functional.flash_attention(causal=False)``: on the card
K3 forward and K5/K6 in its backward, non-causal, on the CPU their plain
versions. The reference's ``constraint(..., P(...))`` hints are the
identity at degree 1 and are left out; expert parallelism over several
cards waits for ROADMAP A13.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import nn
from ..distributed.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding)
from ..incubate.distributed.models.moe import MoELayer
from ..nn import functional as F
from ..nn.layer.common import Embedding
from ..nn.layer.container import LayerList
from ..nn.layer.layers import Layer
from ..nn.layer.norm import LayerNorm
from ._utils import IGNORE_INDEX, building_on, here, init_normal, seeded

__all__ = ["ErnieMoEConfig", "ErnieMoEModel", "ErnieMoEForMaskedLM",
           "ernie_moe_config"]


@dataclass
class ErnieMoEConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: Optional[int] = None      # None -> 4 * hidden
    num_experts: int = 8
    top_k: int = 2
    moe_every: int = 2          # MoE FFN on every Nth layer (1-indexed)
    capacity_factor: float = 1.2
    max_position_embeddings: int = 512
    type_vocab_size: int = 4
    layer_norm_eps: float = 1e-5
    dropout: float = 0.0
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


_PRESETS = {
    # name: (hidden, layers, heads, experts, vocab)
    "tiny": (64, 2, 4, 4, 256),
    "base": (768, 12, 12, 8, 40000),
    "large": (1024, 24, 16, 64, 40000),
}


def ernie_moe_config(preset: str = "tiny", **overrides) -> ErnieMoEConfig:
    h, l, a, e, v = _PRESETS[preset]
    cfg = ErnieMoEConfig(hidden_size=h, num_hidden_layers=l,
                         num_attention_heads=a, num_experts=e, vocab_size=v)
    for k, val in overrides.items():
        setattr(cfg, k, val)
    return cfg


class _SelfAttention(Layer):
    def __init__(self, config: ErnieMoEConfig):
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
        ctx, _ = F.flash_attention(q, k, v, causal=False,
                                   dropout=cfg.dropout,
                                   training=self.training)
        return self.out_proj(ctx.reshape(b, s, nh * hd))


def _make_moe_ffn(config: ErnieMoEConfig) -> MoELayer:
    experts = [
        nn.Sequential(nn.Linear(config.hidden_size, config.ffn_size),
                      nn.GELU(),
                      nn.Linear(config.ffn_size, config.hidden_size))
        for _ in range(config.num_experts)
    ]
    return MoELayer(d_model=config.hidden_size, experts=experts,
                    gate={"type": "gshard", "top_k": config.top_k},
                    capacity_factor=config.capacity_factor)


class _DenseFFN(Layer):
    def __init__(self, config: ErnieMoEConfig):
        super().__init__(dtype=config.dtype)
        self.fc_in = ColumnParallelLinear(config.hidden_size,
                                          config.ffn_size, has_bias=True,
                                          **here())
        self.fc_out = RowParallelLinear(config.ffn_size, config.hidden_size,
                                        has_bias=True, **here())

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class ErnieMoEEncoderLayer(Layer):
    def __init__(self, config: ErnieMoEConfig, use_moe: bool):
        super().__init__(dtype=config.dtype)
        self.ln_1 = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps)
        self.attn = _SelfAttention(config)
        self.ln_2 = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps)
        self.ffn = _make_moe_ffn(config) if use_moe else _DenseFFN(config)
        self.use_moe = use_moe

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.ffn(self.ln_2(x))


class ErnieMoEModel(Layer):
    """Embeddings (tokens, positions, token types), the encoder stack and
    the final LayerNorm, built on ``device`` (default: the current place)
    in ``config.dtype``, weights drawn from ``generator`` as
    :class:`ErnieMoEForMaskedLM` draws them."""

    def __init__(self, config: ErnieMoEConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=config.dtype)
        self.config = config
        with building_on(device, config.dtype) as dev:
            self.embed_tokens = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, **here())
            self.embed_pos = Embedding(config.max_position_embeddings,
                                       config.hidden_size)
            self.embed_type = Embedding(config.type_vocab_size,
                                        config.hidden_size)
            self.layers = LayerList([
                ErnieMoEEncoderLayer(
                    config, use_moe=((i + 1) % config.moe_every == 0))
                for i in range(config.num_hidden_layers)
            ])
            self.norm = LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps)
        init_normal(self, seeded(generator, dev))

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.embed_tokens(input_ids) + self.embed_pos(pos)
        if token_type_ids is not None:
            x = x + self.embed_type(token_type_ids)
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)

    def moe_layers(self):
        """The MoE layers, in depth order."""
        return [layer.ffn for layer in self.layers if layer.use_moe]

    def moe_aux_loss(self):
        """Sum of the gates' load-balancing losses of the last forward
        (each gate keeps its own, cleared here), None without MoE."""
        total = None
        for moe in self.moe_layers():
            l = moe.gate.get_loss(clear=True)
            if l is not None:
                total = l if total is None else total + l
        return total


class ErnieMoEForMaskedLM(Layer):
    """MLM head over :class:`ErnieMoEModel`. Built on ``device`` (default:
    the current place, the CUDA card unless set otherwise) in
    ``config.dtype`` with weights drawn from ``generator`` (default: seed 0
    on that device): normal with std 0.02, biases 0, LayerNorm scales 1.
    ``model(ids)`` gives the logits; ``model(ids, labels)`` gives ``(loss,
    logits)``, the loss the mean cross entropy over the labels that are not
    ``IGNORE_INDEX`` plus ``aux_loss_weight`` times the MoE aux loss."""

    IGNORE_INDEX = IGNORE_INDEX

    def __init__(self, config: ErnieMoEConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=config.dtype)
        with building_on(device, config.dtype) as dev:
            generator = seeded(generator, dev)
            self.ernie = ErnieMoEModel(config, generator=generator)
            self.lm_head = ColumnParallelLinear(config.hidden_size,
                                                config.vocab_size,
                                                has_bias=False, **here())
        init_normal(self.lm_head, generator)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, input_ids, labels=None, token_type_ids=None,
                aux_loss_weight: float = 0.01):
        logits = self.lm_head(self.ernie(input_ids, token_type_ids))
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape([-1, self.ernie.config.vocab_size]),
            labels.reshape([-1]), ignore_index=self.IGNORE_INDEX)
        aux = self.ernie.moe_aux_loss()
        if aux is not None:
            loss = loss + aux_loss_weight * aux
        return loss, logits
