"""``Parameter``, a trainable tensor (port of ``paddle_tpu/nn/parameter.py``).

A subclass of ``torch.nn.Parameter``, so ``torch.nn.Module`` registers it,
``torch.optim`` steps it and torch's autograd fills its ``.grad``. It
carries the reference's metadata:

- ``trainable`` and ``stop_gradient`` are views of ``requires_grad``
  (``stop_gradient == not requires_grad``), so the three stay in step
  whichever is set;
- ``name`` (``param_<i>`` from a process-wide counter unless given),
  ``optimize_attr`` (the learning-rate multiplier the optimizers read),
  ``regularizer``, ``need_clip``, ``do_model_average``, ``persistable`` and
  the tensor-parallel flags ``is_distributed`` / ``split_axis``.

``copy.deepcopy`` keeps the class and the metadata. Pickling (``torch.save``
of a ``state_dict()``) goes through :func:`_rebuild`, which torch's
``weights_only`` loader is told is safe, and gives back a ``Parameter``
with the same metadata.
"""
from __future__ import annotations

import torch

__all__ = ["Parameter"]

_param_counter = [0]
_META = ("optimize_attr", "regularizer", "need_clip", "do_model_average",
         "persistable", "is_distributed", "split_axis")


class Parameter(torch.nn.Parameter):
    def __new__(cls, value=None, trainable: bool = True, name=None,
                learning_rate: float = 1.0, regularizer=None,
                need_clip: bool = True, do_model_average: bool = True):
        if value is None:
            value = torch.empty(0)
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        p = torch.Tensor._make_subclass(cls, value.detach(), bool(trainable))
        if name is None:
            name = f"param_{_param_counter[0]}"
            _param_counter[0] += 1
        p._name = name
        p.optimize_attr = {"learning_rate": learning_rate}
        p.regularizer = regularizer
        p.need_clip = need_clip
        p.do_model_average = do_model_average
        p.persistable = True
        p.is_distributed = False
        p.split_axis = None
        return p

    def __init__(self, *args, **kwargs):
        pass

    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self.requires_grad_(not value)

    def _meta(self) -> dict:
        return {"_name": self.name, **{k: self.__dict__.get(k) for k in _META}}

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = Parameter(self.data.clone(memory_format=torch.preserve_format),
                        self.requires_grad)
        out.__dict__.update(
            {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in self._meta().items()})
        memo[id(self)] = out
        return out

    def __reduce_ex__(self, proto):
        return (_rebuild, (self.data, self.requires_grad, self._meta()))

    def __repr__(self):
        return "Parameter containing:\n" + torch.Tensor.__repr__(self.data)


def _rebuild(data, requires_grad, meta):
    p = Parameter(data, requires_grad)
    p.__dict__.update(meta)
    return p


torch.serialization.add_safe_globals([_rebuild, Parameter])
