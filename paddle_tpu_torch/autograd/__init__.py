"""User-facing autograd API (port of ``paddle_tpu/autograd``): ``grad``,
``backward``, ``jacobian``, ``hessian``, ``saved_tensors_hooks`` and
``PyLayer``, over torch's autograd."""
from ..core.autograd import (enable_grad, is_grad_enabled, no_grad,
                             set_grad_enabled)
from .functional import (backward, grad, hessian, jacobian,
                         saved_tensors_hooks)
from .py_layer import PyLayer, PyLayerContext

__all__ = ["backward", "grad", "jacobian", "hessian", "saved_tensors_hooks",
           "PyLayer", "PyLayerContext", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled"]
