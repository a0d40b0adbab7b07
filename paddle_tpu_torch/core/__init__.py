"""The core of the tensor surface: dtypes, places, the generator, the
tensor and the gradient-mode switches (port of ``paddle_tpu/core``)."""
from . import dtype, place, random
from .autograd import enable_grad, is_grad_enabled, no_grad, set_grad_enabled
from .tensor import Tensor, is_tensor, to_tensor

__all__ = ["Tensor", "to_tensor", "is_tensor", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "dtype", "place", "random"]
