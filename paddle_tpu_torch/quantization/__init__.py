"""paddle.quantization counterpart (port of ``paddle_tpu/quantization``;
reference python/paddle/quantization/: QuantConfig, PTQ observers, QAT
fake-quant, the quanted layer swap).

Training-time quantization is simulated, as in the reference's QAT:
scale observation, then round-to-nearest on an int grid in floating
point, with straight-through gradients (``_FakeQuant``, an autograd
``Function``: the JAX package's ``custom_vjp``). ``fake_quant`` is one op
of the record point, so static programs record it as one node.

The serving side, int8 KV pages (``quantization.kv``), is re-exported
here as in the reference.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Type

import torch

from ..core import dispatch

__all__ = ["quant", "dequant", "fake_quant", "AbsmaxObserver",
           "BaseObserver", "FakeQuanterWithAbsMax", "QuantConfig", "QAT",
           "PTQ", "QuantedLinear"]


# -- functional core ---------------------------------------------------------


def quant(x, scale, bits: int = 8) -> torch.Tensor:
    """Real quantize: float -> int (reference quant kernels)."""
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x / scale * qmax), -qmax - 1, qmax)
    return q.to(torch.int8 if bits == 8 else torch.int32)


def dequant(x, scale, bits: int = 8) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    return x.to(torch.float32) * scale / qmax


class _FakeQuant(torch.autograd.Function):
    """round(v / scale * qmax) on [-qmax - 1, qmax], back to v's scale;
    straight-through gradient where |v| <= scale (the JAX package's
    ``_fake_quant`` with ``_fq_fwd`` / ``_fq_bwd``)."""

    @staticmethod
    def forward(ctx, v, scale, qmax: float):
        ctx.save_for_backward(v, scale if isinstance(scale, torch.Tensor)
                              else torch.tensor(scale, dtype=v.dtype,
                                                device=v.device))
        q = torch.clamp(torch.round(v / scale * qmax), -qmax - 1, qmax)
        return q * scale / qmax

    @staticmethod
    def backward(ctx, g):
        v, scale = ctx.saved_tensors
        return g * (v.abs() <= scale).to(g.dtype), None, None


def _fake_quant(v, scale, qmax: float):
    return _FakeQuant.apply(v, scale, qmax)


@dispatch.op("fake_quant")
def _fake_quant_op(x, scale, qmax):
    return _fake_quant(x, scale, qmax)


def fake_quant(x, scale, bits: int = 8):
    """Simulated quantization with a straight-through gradient (QAT
    core)."""
    return _fake_quant_op(x, scale, float(2 ** (bits - 1) - 1))


# -- observers ---------------------------------------------------------------


def _absmax(x) -> Optional[float]:
    """max |x| read back to the host, or None for a symbolic value (a
    program being recorded observes nothing)."""
    if x.is_meta:
        return None
    return float(x.detach().abs().max())


def _layer_base():
    from ..nn.layer.layers import Layer

    return Layer


class BaseObserver(_layer_base()):
    """reference quantization/observer.py BaseObserver."""

    def __init__(self, quant_bits: int = 8):
        super().__init__()
        self._quant_bits = quant_bits

    def scales(self):
        raise NotImplementedError

    def bit_length(self):
        return self._quant_bits


class AbsmaxObserver(BaseObserver):
    """Running abs-max scale observer (reference AbsmaxObserver)."""

    def __init__(self, quant_bits: int = 8):
        super().__init__(quant_bits)
        self._max = 1e-9

    def forward(self, x):
        cur = _absmax(x)
        if cur is not None:
            self._max = max(self._max, cur)
        return x

    def scales(self):
        return torch.tensor(self._max, dtype=torch.float32)


class FakeQuanterWithAbsMax(BaseObserver):
    """QAT fake-quanter (reference FakeQuanterWithAbsMaxObserver): observes
    the abs-max while training and fake-quantizes its input."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9,
                 name=None):
        super().__init__(quant_bits)
        self._moving_rate = moving_rate
        # set from the FIRST batch's absmax (ramping from ~0 would mask
        # every straight-through gradient early in training)
        self._scale = None

    def forward(self, x):
        if self.training:
            cur = _absmax(x)
            if cur is not None:
                if self._scale is None:
                    self._scale = max(cur, 1e-9)
                else:
                    r = self._moving_rate
                    self._scale = max(r * self._scale + (1 - r) * cur, 1e-9)
        return fake_quant(x, self._scale if self._scale is not None else 1.0,
                          self._quant_bits)

    def scales(self):
        return torch.tensor(self._scale or 1e-9, dtype=torch.float32)


# -- quanted layers ----------------------------------------------------------


class QuantedLinear(_layer_base()):
    """Linear with weight and activation fake-quant (reference
    nn/quant/qat/linear.py QuantedLinear), over the port's ``nn.Linear``
    or a model's column/row-parallel linear (weights [in, out])."""

    def __init__(self, linear, q_config=None):
        super().__init__()
        self.linear = linear
        self.weight_quanter = FakeQuanterWithAbsMax(
            q_config.weight_bits if q_config else 8)
        self.activation_quanter = FakeQuanterWithAbsMax(
            q_config.activation_bits if q_config else 8)

    def forward(self, x):
        from ..nn import functional as F

        x = self.activation_quanter(x)
        w = self.weight_quanter(self.linear.weight)
        return F.linear(x, w, self.linear.bias)


def _linear_types():
    from ..distributed.mp_layers import (ColumnParallelLinear,
                                         RowParallelLinear)
    from ..nn.layer.common import Linear

    return (Linear, ColumnParallelLinear, RowParallelLinear)


class QuantConfig:
    """reference quantization/config.py QuantConfig. Its layer map sends
    the linears (the port's ``nn.Linear`` and the models' column/row
    parallel linears) to :class:`QuantedLinear`."""

    def __init__(self, activation=None, weight=None, weight_bits: int = 8,
                 activation_bits: int = 8):
        self.activation = activation
        self.weight = weight
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self._layer_map: Dict[Type, Type] = {
            t: QuantedLinear for t in _linear_types()}

    def add_layer_config(self, layer_types, activation=None, weight=None):
        return self

    def add_type_config(self, layer_types, activation=None, weight=None):
        return self


def _swap_layers(model, cfg: QuantConfig):
    for name, sub in list(model.named_children()):
        swapped = cfg._layer_map.get(type(sub))
        if swapped is not None:
            setattr(model, name, swapped(sub, cfg))
        else:
            _swap_layers(sub, cfg)
    return model


def _maybe_copy(model, inplace: bool):
    return model if inplace else copy.deepcopy(model)


class QAT:
    """Quantization-aware training (reference quantization/qat.py): swaps
    the linears for :class:`QuantedLinear`."""

    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model, inplace: bool = False):
        return _swap_layers(_maybe_copy(model, inplace), self._config)

    def convert(self, model, inplace: bool = False):
        return model  # the fake-quant layers already carry final scales


class PTQ:
    """Post-training quantization (reference quantization/ptq.py):
    insert observers, run calibration data through, and ``convert``
    freezes the observed scales into quanted layers."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self._config = config or QuantConfig()
        self._observers: List[AbsmaxObserver] = []
        self._obs_by_layer: Dict[int, AbsmaxObserver] = {}
        self._hooks = []

    def quantize(self, model, inplace: bool = False):
        cfg = self._config
        model = _maybe_copy(model, inplace)
        types = tuple(cfg._layer_map)

        def attach(m):
            for _, sub in list(m.named_children()):
                if isinstance(sub, types):
                    obs = AbsmaxObserver(cfg.activation_bits)
                    self._observers.append(obs)
                    self._obs_by_layer[id(sub)] = obs
                    self._hooks.append(sub.register_forward_pre_hook(
                        lambda l, inputs, _o=obs: (_o(inputs[0]),)
                        + tuple(inputs[1:])))
                else:
                    attach(sub)

        attach(model)
        return model

    def convert(self, model, inplace: bool = False):
        """Swap to quanted layers and FREEZE the calibrated scales (the
        reference's scale-transfer step)."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
        types = tuple(self._config._layer_map)

        def swap(m):
            for name, sub in list(m.named_children()):
                if isinstance(sub, types):
                    ql = QuantedLinear(sub, self._config)
                    obs = self._obs_by_layer.get(id(sub))
                    if obs is not None:
                        ql.activation_quanter._scale = float(obs.scales())
                    ql.weight_quanter._scale = float(
                        sub.weight.detach().abs().max())
                    ql.eval()
                    setattr(m, name, ql)
                else:
                    swap(sub)

        swap(model)
        return model


class BaseQuanter(BaseObserver):
    """Base class for trainable quanters (reference
    quantization/base_quanter.py): the observers' contract plus
    scales()/zero_points()."""

    def scales(self):
        return getattr(self, "_scale", None)

    def zero_points(self):
        return getattr(self, "_zero_point", 0)


def quanter(class_name: str):
    """Class decorator registering a quanter under a factory name
    (reference quantization/factory.py:quanter): makes a ``<class_name>``
    factory whose call instantiates the decorated class."""
    def wrapper(cls):
        class _Factory:
            def __init__(self, *args, **kwargs):
                self._args, self._kwargs = args, kwargs

            def _instance(self, layer=None):
                return cls(*self._args, **self._kwargs)

            __call__ = _instance

        _Factory.__name__ = class_name
        globals()[class_name] = _Factory
        return cls

    return wrapper


__all__ += ["BaseQuanter", "quanter"]

# serving-side KV quantization math (int8 pages, per-page-per-head absmax
# scales), as the reference re-exports it
from . import kv  # noqa: E402
from .kv import (KV_DTYPES, KV_QMAX, KV_SCALE_FLOOR,  # noqa: E402,F401
                 dequant_scale, dequantize_page, max_logit_divergence,
                 quant_store_rows, quantize_page)

__all__ += ["kv", "KV_DTYPES", "KV_QMAX", "KV_SCALE_FLOOR",
            "dequant_scale", "quantize_page", "dequantize_page",
            "quant_store_rows", "max_logit_divergence"]
