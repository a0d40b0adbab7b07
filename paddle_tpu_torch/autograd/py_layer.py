"""PyLayer: a user-defined forward and backward, over
``torch.autograd.Function`` (port of ``paddle_tpu/autograd/py_layer.py``).

``PyLayer.apply`` runs the subclass's ``forward(ctx, *args, **kwargs)``
inside a ``torch.autograd.Function`` made once per subclass; the backward
calls the subclass's ``backward(ctx, *grads)``, which returns one gradient
for each tensor argument of the forward (positional, then keyword, in
order), ``None`` where there is none. Arguments that are not tensors get
no gradient. ``ctx`` is a :class:`PyLayerContext`: paddle's
``save_for_backward`` / ``saved_tensor()`` (a method, as in paddle),
``mark_non_differentiable`` and ``set_materialize_grads``, each handed to
torch's context, and any attribute the forward sets.
"""
from __future__ import annotations

import torch

__all__ = ["PyLayer", "PyLayerContext", "LegacyPyLayer"]


class PyLayerContext:
    def __init__(self, fn_ctx=None):
        self._fn_ctx = fn_ctx

    def save_for_backward(self, *tensors):
        self._fn_ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        """The saved tuple, unpacked through the ``saved_tensors_hooks`` that
        were active when it was saved."""
        return self._fn_ctx.saved_tensors

    def saved_tensors(self):
        return self.saved_tensor()

    def mark_non_differentiable(self, *tensors):
        self._fn_ctx.mark_non_differentiable(*tensors)

    def set_materialize_grads(self, value: bool):
        self._fn_ctx.set_materialize_grads(bool(value))


def _function_of(layer):
    """The ``torch.autograd.Function`` behind PyLayer subclass ``layer``.
    Its arguments: the keyword names, then every argument flattened
    (positional, then keyword values), so torch sees each tensor."""

    def forward(fn_ctx, kw_names, *flat):
        n_pos = len(flat) - len(kw_names)
        ctx = PyLayerContext(fn_ctx)
        fn_ctx.pylayer_ctx = ctx
        fn_ctx.is_tensor = [isinstance(a, torch.Tensor) for a in flat]
        return layer.forward(ctx, *flat[:n_pos],
                             **dict(zip(kw_names, flat[n_pos:])))

    def backward(fn_ctx, *grads):
        res = layer.backward(fn_ctx.pylayer_ctx, *grads)
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        out = [None]
        for is_t in fn_ctx.is_tensor:
            out.append(res.pop(0) if is_t and res else None)
        return tuple(out)

    return type(layer.__name__ + "Function", (torch.autograd.Function,),
                {"forward": staticmethod(forward),
                 "backward": staticmethod(backward)})


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        fn = cls.__dict__.get("_torch_function")
        if fn is None:
            fn = _function_of(cls)
            cls._torch_function = fn
        return fn.apply(tuple(kwargs), *args, *kwargs.values())


# the reference's alias
LegacyPyLayer = PyLayer
