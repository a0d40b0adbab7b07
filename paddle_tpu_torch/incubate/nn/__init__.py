"""paddle.incubate.nn counterpart (port of ``paddle_tpu/incubate/nn``): the
fused transformer layers and the functions they call."""
from . import functional
from .layer.fused_transformer import (FusedBiasDropoutResidualLayerNorm,
                                      FusedMultiTransformer)

__all__ = ["functional", "FusedMultiTransformer",
           "FusedBiasDropoutResidualLayerNorm"]
