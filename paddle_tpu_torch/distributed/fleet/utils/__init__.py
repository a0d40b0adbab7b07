from . import mix_precision_utils
from .mix_precision_utils import (MixPrecisionLayer, MixPrecisionOptimizer,
                                  MixPrecisionScaler)

__all__ = ["mix_precision_utils", "MixPrecisionLayer",
           "MixPrecisionOptimizer", "MixPrecisionScaler"]
