from .fused_transformer import (FusedBiasDropoutResidualLayerNorm,
                                FusedMultiTransformer)

__all__ = ["FusedMultiTransformer", "FusedBiasDropoutResidualLayerNorm"]
