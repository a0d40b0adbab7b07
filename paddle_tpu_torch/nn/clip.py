"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``).

Clip objects map a list of (param, grad) pairs to a new one, as the
reference's do; parameters whose ``need_clip`` attribute is False, and
missing gradients, pass through. The norms are fp32 sums of squares, the
global norm's scale ``min(clip / max(norm, 1e-6), 1)`` is applied in fp32
and cast back to each gradient's dtype (``:54-81``). The work is a few
``torch._foreach_*`` calls and device reductions; nothing reads a value
back to the host. ``clip_grad_norm_`` and ``clip_grad_value_`` write the
clipped gradients into ``p.grad`` in place.
"""
from __future__ import annotations

import torch

from ..optimizer._foreach import chunks, f32_copies

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _clipped(params_grads):
    """Indices of the pairs the clip applies to."""
    return [i for i, (p, g) in enumerate(params_grads)
            if g is not None and getattr(p, "need_clip", True)]


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        out = list(params_grads)
        for i in _clipped(params_grads):
            p, g = params_grads[i]
            out[i] = (p, torch.clamp(g, self.min, self.max))
        return out


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        out = list(params_grads)
        idx = _clipped(params_grads)
        if not idx:
            return out
        gs = [params_grads[i][1] for i in idx]
        norms = torch._foreach_norm(gs, 2, dtype=torch.float32)
        for i, g, n in zip(idx, gs, norms):
            scale = torch.where(n > self.clip_norm, self.clip_norm / n, 1.0)
            out[i] = (params_grads[i][0], (g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def _global_norm_sq(self, params_grads) -> torch.Tensor:
        """The sum over the clipped gradients of their fp32 squares: one
        fused norm per tensor (accumulated in fp32), then one reduction."""
        gs = [params_grads[i][1] for i in _clipped(params_grads)]
        if not gs:
            return torch.zeros((), dtype=torch.float32)
        norms = torch.stack(torch._foreach_norm(gs, 2, dtype=torch.float32))
        return (norms * norms).sum()

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        out = list(params_grads)
        idx = _clipped(params_grads)
        if not idx:
            return out
        global_norm = torch.sqrt(self._global_norm_sq(params_grads))
        scale = torch.clamp(self.clip_norm / torch.clamp(global_norm,
                                                         min=1e-6), max=1.0)
        # fp32 gradients in one foreach product; others through fp32
        # copies and back (a product in their own dtype would round the
        # scale first), by foreach copies, in chunks
        f32 = [i for i in idx if params_grads[i][1].dtype == torch.float32]
        for i, g in zip(f32, torch._foreach_mul(
                [params_grads[i][1] for i in f32], scale) if f32 else []):
            out[i] = (params_grads[i][0], g)
        low = [i for i in idx if params_grads[i][1].dtype != torch.float32]
        for run in chunks(low, lambda i: params_grads[i][1].numel()):
            gs = [params_grads[i][1] for i in run]
            bufs = f32_copies(gs)
            torch._foreach_mul_(bufs, scale)
            outs = [torch.empty_like(g) for g in gs]
            torch._foreach_copy_(outs, bufs)
            for i, g in zip(run, outs):
                out[i] = (params_grads[i][0], g)
        return out


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    params = ([parameters] if isinstance(parameters, torch.Tensor)
              else list(parameters))
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.float().abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.copy_(g.float() * scale)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    params = ([parameters] if isinstance(parameters, torch.Tensor)
              else list(parameters))
    for p in params:
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
    return params
