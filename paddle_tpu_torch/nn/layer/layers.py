"""``Layer``, the module system (port of ``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module``: parameters, buffers and sublayers live
in torch's own ``_parameters``, ``_buffers`` and ``_modules``, so the
engines, ``torch.optim``, the port's optimizers, ``amp``,
``framework.io``, ``hapi.Model``, CUDA graphs and ``torch.autograd`` see an
ordinary module, and a ``Layer`` may hold plain ``torch.nn.Module``
children. Paddle's names sit on top with paddle's meaning. Where a name is
also torch's and the two contracts differ, the paddle one holds inside
``Layer``, and the torch calls torch's own machinery makes keep working:

- ``parameters()`` / ``buffers()`` return lists (torch: generators);
  ``named_parameters`` / ``named_buffers`` also take torch's ``recurse`` and
  ``remove_duplicate``.
- ``state_dict()`` holds every parameter first, then the persistable
  buffers (torch interleaves them layer by layer), keyed as the
  reference keys them, and its values are the parameters and buffers
  themselves, not detached copies. Called as torch calls a child's
  (``prefix=`` / ``keep_vars=``), it is torch's.
- ``set_state_dict`` (``load_dict``, ``set_dict``) copies values given as
  tensors or numpy arrays into the parameters in place and returns
  ``(missing, unexpected)``; torch's ``load_state_dict`` stays as it is.
- ``register_buffer(name, tensor, persistable=True)``: paddle's third
  argument (torch's ``persistent=`` keyword is also taken); a
  non-persistable buffer is left out of ``state_dict``.
- ``to(device=None, dtype=None, blocking=None)``: paddle's argument order
  and device names (``"gpu:0"``); torch's forms (``to(dtype)``,
  ``to(tensor)``, ``non_blocking=``) are also taken. ``astype`` and
  ``float16`` are ``to(dtype=...)``.
- Assigning a plain tensor to a parameter's name copies it into the
  parameter (paddle's ``set_value``), where torch would refuse it.
- ``register_forward_post_hook`` is torch's ``register_forward_hook``; the
  pre and post hooks' return values replace the inputs and the output, and
  the handle they return has ``remove()``, as in paddle.

Parameters are created on the current place (``core.place``) in the
layer's dtype, which is the port's default dtype at construction
(``core.dtype.get_default_dtype``) unless ``dtype`` is given; torch's own
default dtype is never touched.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch

from ...core import dtype as dtypes
from ...core.place import _parse, resolve_device
from ..initializer import (Constant, Initializer, XavierUniform,
                           get_global_initializer)
from ..param_attr import ParamAttr
from ..parameter import Parameter

__all__ = ["Layer"]

_layer_name_counters: Dict[str, int] = collections.defaultdict(int)

# what the forward hooks' registration returns: torch's handle, whose
# ``remove()`` is paddle's
HookRemoveHelper = torch.utils.hooks.RemovableHandle


def _as_tensor(v) -> torch.Tensor:
    """A state value (tensor, numpy array, list) as a torch tensor; an
    ``ml_dtypes`` bf16 array reads as fp32 (numpy has no bf16)."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def _dtype_name(v) -> bool:
    if not isinstance(v, str):
        return False
    try:
        dtypes.convert_dtype(v)
    except ValueError:
        return False
    return True


class Layer(torch.nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        super().__init__()
        cls = name_scope or self.__class__.__name__.lower()
        _layer_name_counters[cls] += 1
        self._full_name = f"{cls}_{_layer_name_counters[cls] - 1}"
        self._dtype = (dtypes.convert_dtype(dtype)
                       or dtypes.get_default_dtype())

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    # -- hooks ----------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        return self.register_forward_hook(hook)

    # -- registration ---------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False,
                         default_initializer: Optional[Initializer] = None
                         ) -> Optional[Parameter]:
        """A new ``Parameter`` of ``shape`` on the current place: the
        initializer is ``attr``'s, else the global one, else
        ``default_initializer``, else zeros for a bias and Xavier-uniform
        for a weight. ``attr=False`` gives None."""
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        dtype = dtypes.convert_dtype(dtype) or self._dtype
        init = attr.initializer
        if init is None:
            gw, gb = get_global_initializer()
            init = (gb if is_bias else gw) or default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        return Parameter(init(shape, dtype, device=resolve_device()),
                         trainable=attr.trainable, name=attr.name,
                         learning_rate=attr.learning_rate,
                         regularizer=attr.regularizer,
                         need_clip=attr.need_clip,
                         do_model_average=attr.do_model_average)

    def add_parameter(self, name: str, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    torch.nn.Parameter):
            raise TypeError("add_parameter expects a Parameter or None")
        self.__dict__.pop(name, None)
        self.register_parameter(name, parameter)
        return parameter

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        *, persistent: Optional[bool] = None):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=keep)
        return tensor

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    @property
    def _non_persistable_buffer_names_set(self):
        return self._non_persistent_buffers_set

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if (params is not None and params.get(name) is not None
                and isinstance(value, torch.Tensor)
                and not isinstance(value, torch.nn.Parameter)):
            with torch.no_grad():
                params[name].copy_(value)
            return
        super().__setattr__(name, value)

    # -- traversal ------------------------------------------------------------
    def full_name(self) -> str:
        return self._full_name

    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None):
        for name, layer in self.named_modules(memo=layers_set,
                                              prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self: bool = False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def parameters(self, include_sublayers: bool = True, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return list(super().parameters(recurse=rec))

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True, recurse=None,
                         remove_duplicate: bool = True):
        rec = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=rec,
                                        remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers: bool = True, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return list(super().buffers(recurse=rec))

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      recurse=None, remove_duplicate: bool = True):
        rec = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=rec,
                                     remove_duplicate=remove_duplicate)

    # -- state ----------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   **torch_kwargs):
        if torch_kwargs:       # a torch parent's recursion into this child
            return super().state_dict(destination=destination,
                                      **torch_kwargs)
        dest = (collections.OrderedDict() if destination is None
                else destination)
        prefix = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(
                prefix=prefix, include_sublayers=include_sublayers):
            dest[name] = p
        layers = (self.named_sublayers(prefix=prefix, include_self=True)
                  if include_sublayers else [(prefix, self)])
        seen = set()
        for layer_prefix, layer in layers:
            for name, b in layer._buffers.items():
                if (b is None or id(b) in seen
                        or name in layer._non_persistent_buffers_set):
                    continue
                seen.add(id(b))
                dest[layer_prefix + ("." if layer_prefix else "") + name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s values (tensors or numpy arrays) into this
        layer's parameters and buffers, in their dtypes and places. Returns
        ``(missing_keys, unexpected_keys)``."""
        own = self.state_dict()
        missing = []
        with torch.no_grad():
            for key, target in own.items():
                if key not in state_dict:
                    missing.append(key)
                    continue
                v = _as_tensor(state_dict[key])
                if tuple(v.shape) != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: receives "
                        f"{tuple(v.shape)}, expects {tuple(target.shape)}")
                target.copy_(v.to(device=target.device, dtype=target.dtype))
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    def raw_state(self):
        """{name: tensor} of the parameters and persistable buffers,
        detached (the reference's pytree view)."""
        return {k: v.detach() for k, v in self.state_dict().items()}

    def load_raw_state(self, raw):
        self.set_state_dict(raw)
        return self

    # -- dtype and device -----------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, *,
           non_blocking: bool = False):
        if isinstance(device, torch.Tensor):
            return super().to(device)
        if isinstance(device, torch.dtype) or _dtype_name(device):
            device, dtype = None, device
        kw = {}
        if device is not None:
            kw["device"] = _parse(device)
        if dtype is not None:
            kw["dtype"] = dtypes.convert_dtype(dtype)
            self._dtype = kw["dtype"]
        if not kw:
            return self
        return super().to(non_blocking=non_blocking or blocking is False,
                          **kw)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float16(self):
        return self.half()

    # -- misc -----------------------------------------------------------------
    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None
