"""nn.utils (port of ``paddle_tpu/nn/utils/utils.py``).

``weight_norm`` and ``spectral_norm`` reparameterize a layer's weight with a
forward pre-hook that recomputes it from auxiliary parameters before every
forward: ``weight = g * v / ||v||`` from ``weight_g`` / ``weight_v``, and
``weight = weight_orig / sigma`` with ``weight_u`` / ``weight_v`` (plain
attributes, not buffers, as in the reference) moved by power iteration in
training mode. The recomputed weight is differentiable in ``g``, ``v`` and
``weight_orig``, so an optimizer trains them. The reference's hooks read
the parameters' raw values, so its recomputed weight carries no gradient
back to them (ROADMAP C-ref-6); the port follows what the hooks are for.
The power iteration's start vectors come from torch generators seeded 0
and 1, so they are not the reference's draws. ``parameters_to_vector``
returns the values (no graph), as the reference does. The clips are
``nn.clip``'s.
"""
from __future__ import annotations

import torch

from ..clip import clip_grad_norm_, clip_grad_value_
from ..parameter import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _norm_except_dim(v, dim):
    if dim is None:
        return torch.sqrt((v * v).sum())
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt((v * v).sum(dim=axes, keepdim=True))


def _set_weight(layer, name, w):
    layer.__dict__[name] = w


class _WeightNormHook:
    def __init__(self, name, dim):
        self.name, self.dim = name, dim

    def compute(self, layer):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        _set_weight(layer, self.name, v * (g / torch.clamp(
            _norm_except_dim(v, self.dim), min=1e-12)))

    def __call__(self, layer, inputs):
        self.compute(layer)
        return inputs


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """Reparameterize ``layer.<name>`` as g * v / ||v||. Returns the
    layer."""
    w = getattr(layer, name).detach()
    del layer._parameters[name]
    layer.add_parameter(name + "_g", Parameter(_norm_except_dim(w, dim)))
    layer.add_parameter(name + "_v", Parameter(w.clone()))
    hook = _WeightNormHook(name, dim)
    handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_hook = (hook, handle, name)
    hook.compute(layer)
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    """Fold g * v / ||v|| back into a plain weight parameter."""
    hook, handle, hname = layer._weight_norm_hook
    hook.compute(layer)
    w = layer.__dict__.pop(hname).detach()
    handle.remove()
    del layer._parameters[hname + "_g"]
    del layer._parameters[hname + "_v"]
    layer.add_parameter(hname, Parameter(w))
    del layer._weight_norm_hook
    return layer


class _SpectralNormHook:
    def __init__(self, name, n_power_iterations, eps, dim):
        self.name, self.n = name, n_power_iterations
        self.eps, self.dim = eps, dim

    def compute(self, layer, update_uv=True):
        w = getattr(layer, self.name + "_orig")
        wm = w.movedim(self.dim, 0).reshape(w.shape[self.dim], -1)
        u = getattr(layer, self.name + "_u")
        v = getattr(layer, self.name + "_v")
        if update_uv and layer.training:
            with torch.no_grad():
                m = wm.detach()
                for _ in range(self.n):
                    v = m.T @ u
                    v = v / torch.clamp(torch.linalg.norm(v), min=self.eps)
                    u = m @ v
                    u = u / torch.clamp(torch.linalg.norm(u), min=self.eps)
            layer.__dict__[self.name + "_u"] = u
            layer.__dict__[self.name + "_v"] = v
        sigma = u @ wm @ v
        _set_weight(layer, self.name, w / torch.clamp(sigma, min=self.eps))

    def __call__(self, layer, inputs):
        self.compute(layer)
        return inputs


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1,
                  eps: float = 1e-12, dim=None):
    """Spectral normalization w / sigma_max(w) by power iteration."""
    w = getattr(layer, name).detach()
    if dim is None:
        dim = 1 if type(layer).__name__.startswith(
            ("Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
             "Linear")) else 0
    h = w.shape[dim]
    cols = w.numel() // h

    def unit(n, seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(n, generator=g).to(device=w.device, dtype=w.dtype)
        return x / torch.clamp(torch.linalg.norm(x), min=eps)

    del layer._parameters[name]
    layer.add_parameter(name + "_orig", Parameter(w.clone()))
    layer.__dict__[name + "_u"] = unit(h, 0)
    layer.__dict__[name + "_v"] = unit(cols, 1)
    hook = _SpectralNormHook(name, n_power_iterations, eps, dim)
    layer.register_forward_pre_hook(hook)
    hook.compute(layer, update_uv=False)
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters' values flattened into one 1-D tensor."""
    return torch.cat([p.detach().reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Write consecutive slices of ``vec`` into ``parameters`` in place."""
    off = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[off:off + n].reshape(p.shape).to(p.dtype))
            off += n
