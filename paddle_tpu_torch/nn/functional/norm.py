"""Normalization functions (port of ``paddle_tpu/nn/functional/norm.py``):
the reference's mean / biased-variance / rsqrt formulas as plain torch ops.
``layer_norm`` is not routed to K8 (``ops.fused_kernels.fused_layer_norm``),
as the reference's is not routed to its Pallas kernel. ``batch_norm`` in
training updates the running statistics it is given in place, as the
reference's does."""
from __future__ import annotations

import torch

from ._op import amp_op

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize"]


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@amp_op("normalize")
def normalize(x, p: float = 2, axis: int = 1, epsilon: float = 1e-12,
              name=None):
    norm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


@amp_op("batch_norm")
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats=None, name=None):
    ch = (1 if data_format.startswith("NC") else -1) % x.dim()
    if use_global_stats is None:
        use_global_stats = not training
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    axes = tuple(i for i in range(x.dim()) if i != ch)
    if training and not use_global_stats:
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, unbiased=False)
        if isinstance(running_mean, torch.Tensor):
            with torch.no_grad():
                running_mean.copy_(momentum * running_mean
                                   + (1 - momentum) * mean)
                running_var.copy_(momentum * running_var
                                  + (1 - momentum) * var)
    else:                   # the running statistics are constants here
        mean, var = running_mean.detach(), running_var.detach()
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    return _affine(out, weight, bias, shape)


@amp_op("layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    m = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    out = (x - m) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
        if bias is not None:
            out = out + bias
    return out


@amp_op("instance_norm")
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats: bool = True,
                  momentum: float = 0.9, eps: float = 1e-5,
                  data_format: str = "NCHW", name=None):
    """Per-sample, per-channel statistics over the spatial dims (NC...);
    the running statistics are not used, as in the reference."""
    axes = tuple(range(2, x.dim()))
    m = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    out = (x - m) * torch.rsqrt(var + eps)
    return _affine(out, weight, bias, [1, x.shape[1]] + [1] * (x.dim() - 2))


@amp_op("group_norm")
def group_norm(x, num_groups: int, epsilon: float = 1e-5, weight=None,
               bias=None, data_format: str = "NCHW", name=None):
    channel_last = not data_format.startswith("NC")
    v = x.movedim(-1, 1) if channel_last else x
    n, c = v.shape[0], v.shape[1]
    g = v.reshape(n, num_groups, c // num_groups, *v.shape[2:])
    axes = tuple(range(2, g.dim()))
    m = g.mean(dim=axes, keepdim=True)
    var = g.var(dim=axes, unbiased=False, keepdim=True)
    out = ((g - m) * torch.rsqrt(var + epsilon)).reshape(v.shape)
    out = _affine(out, weight, bias, [1, c] + [1] * (v.dim() - 2))
    return out.movedim(1, -1) if channel_last else out


@amp_op("local_response_norm")
def local_response_norm(x, size: int, alpha: float = 1e-4, beta: float = 0.75,
                        k: float = 1.0, data_format: str = "NCHW", name=None):
    """out = x / (k + alpha / size * window_sum(x^2))^beta, the window
    ``size`` channels wide, zero-padded (size // 2 before)."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    half = size // 2
    sq = (x * x).movedim(ch, -1)
    sq = torch.nn.functional.pad(sq, (half, size - 1 - half))
    s = sq.unfold(-1, size, 1).sum(-1).movedim(-1, ch)
    return x / (k + (alpha / size) * s) ** beta
