"""paddle.nn.utils (port of ``paddle_tpu/nn/utils``): weight and spectral
norm, parameter flattening and the gradient clips."""
from .utils import (clip_grad_norm_, clip_grad_value_, parameters_to_vector,
                    remove_weight_norm, spectral_norm, vector_to_parameters,
                    weight_norm)

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]
