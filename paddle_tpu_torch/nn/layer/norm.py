"""Normalization layers (port of ``paddle_tpu/nn/layer/norm.py``).

``RMSNorm`` always goes through K1 (``ops.fused_kernels.rms_norm``): the
CUDA C++ kernel of ``csrc/norm_rope.cu`` on the card, its plain version on
the CPU. Both follow the TPU kernel's math (fp32 throughout, one cast at
the end), not the reference layer's off-TPU branch, which casts ``rsqrt``
to the input dtype before the multiply. It is the model's norm (the Llama
layers build it with ``device=`` and ``dtype=``) and stays a plain
``torch.nn.Module``; a ``Layer`` holds it as any other child.

The other layers are ``Layer`` s over ``nn.functional``'s norms. The batch
norms keep their running statistics as persistable fp32 buffers
``_mean`` / ``_variance`` (the reference's names) and update them in
training mode. ``SyncBatchNorm`` is ``BatchNorm`` here, as the reference's
is where no sync axis is set: its cross-replica statistics wait for the
hybrid-parallel port (ROADMAP A13). ``SpectralNorm`` normalizes a weight it
is given by power iteration from its ``weight_u`` / ``weight_v``, which
take no gradient.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core.place import resolve_device
from ...ops.fused_kernels import rms_norm
from .. import functional as F
from ..initializer import Constant, Normal
from .layers import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
    "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm", "RMSNorm",
]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self._epsilon)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, epsilon={self._epsilon}"


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        dev = resolve_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    """The legacy ``paddle.nn.BatchNorm``, with a fused activation."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NCHW" if data_format in ("NCL", "NC") else "NLC",
                         use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics would be all-reduced across replicas;
    with no replica group in the port it is ``BatchNorm2D``."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if (isinstance(layer, _BatchNormBase)
                and not isinstance(layer, SyncBatchNorm)):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format)
            out.set_state_dict(layer.state_dict())
        for name, sub in list(layer._modules.items()):
            out._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the largest singular value of ``weight``
    (moved ``dim`` first, flattened to a matrix) by ``power_iters`` steps
    of power iteration from ``weight_u`` / ``weight_v``."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            [h], default_initializer=Normal(0, 1.0))
        self.weight_v = self.create_parameter(
            [w], default_initializer=Normal(0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        mat = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                   -1)
        with torch.no_grad():
            u, v = self.weight_u.detach(), self.weight_v.detach()
            m = mat.detach()
            for _ in range(self._power_iters):
                v = m.T @ u
                v = v / (torch.linalg.norm(v) + self._eps)
                u = m @ v
                u = u / (torch.linalg.norm(u) + self._eps)
        return weight / (u @ mat @ v)
