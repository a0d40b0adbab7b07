"""paddle.static counterpart, in part (port of ``paddle_tpu/static``):
``InputSpec`` (``paddle_tpu/static/__init__.py:33-50``), which
``jit.save``, ``onnx.export`` and ``hapi.Model`` take.

The rest of ``static`` (``enable_static``, ``Program``, ``Executor``,
``data``, ``append_backward``, ``save_inference_model`` ...) is not ported
yet: the JAX package builds its programs in record mode at the ``apply_op``
choke point (``paddle_tpu/static/record.py:37``), and the port has no such
point yet (ROADMAP A9c).
"""
from __future__ import annotations

from ..core import dtype as dtypes

__all__ = ["InputSpec"]


class InputSpec:
    """reference paddle.static.InputSpec: a shape (None or -1 for a
    dynamic dim), a dtype and a name."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = dtypes.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), tensor.dtype, name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
