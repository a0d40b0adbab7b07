"""paddle.incubate.nn counterpart (port of ``paddle_tpu/incubate/nn``): the
fused transformer layers, the fused-op functions and
``memory_efficient_attention``."""
from . import functional
from .layer.fused_transformer import (FusedBiasDropoutResidualLayerNorm,
                                      FusedMultiTransformer)
from .memory_efficient_attention import memory_efficient_attention

__all__ = ["functional", "FusedMultiTransformer",
           "FusedBiasDropoutResidualLayerNorm", "memory_efficient_attention"]
