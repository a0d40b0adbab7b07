"""Functional optimizer transforms over name -> tensor dicts (port of
``paddle_tpu/optimizer/functional.py``).

Same math as the reference: AdamW with step-count bias correction and
decoupled weight decay on every parameter, computed in ``master_dtype``
(fp32) whatever the parameters' and moments' dtypes, the moments stored
back in their own dtypes. The reference returns new pytrees (JAX arrays are
immutable); here every update writes its result IN PLACE into the tensors
it was given (parameters, moments, gradients for the clip), so a step holds
no second copy of the model or of the optimizer state, and the functions
return those same objects for symmetry with the reference.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "sgd_update",
           "clip_by_global_norm"]

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-dim int64 on the CPU, advanced in place
    m: Tensors           # first moment per parameter
    v: Tensors           # second moment per parameter


def adamw_init(params: Tensors, master_dtype: torch.dtype = torch.float32,
               moment_dtype: Optional[torch.dtype] = None) -> AdamWState:
    """Zero moments beside each parameter, on its device. ``moment_dtype``
    (e.g. bf16) applies to the FIRST moment only: v changes by
    1 - beta2 = 0.001 of itself per step, below the bf16 ulp, so a bf16 v
    would round every update away; it stays in ``master_dtype``."""
    moment_dtype = moment_dtype or master_dtype
    return AdamWState(
        step=torch.zeros((), dtype=torch.int64),
        m={k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=master_dtype, device=p.device)
           for k, p in params.items()})


@torch.no_grad()
def adamw_update(grads: Tensors, state: AdamWState, params: Tensors,
                 lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.01,
                 master_dtype: torch.dtype = torch.float32
                 ) -> Tuple[AdamWState, Tensors]:
    """One AdamW step over every name of ``grads``, in place: the moments
    of ``state``, its step count and ``params`` are overwritten."""
    state.step.add_(1)
    t = int(state.step)
    c1 = 1.0 - beta1 ** t
    c2 = 1.0 - beta2 ** t
    for k, g in grads.items():
        m, v, p = state.m[k], state.v[k], params[k]
        g32 = g.to(master_dtype)
        m32 = m.to(master_dtype).mul_(beta1).add_(g32, alpha=1 - beta1)
        v32 = v.to(master_dtype).mul_(beta2).addcmul_(g32, g32,
                                                      value=1 - beta2)
        p32 = p.to(master_dtype)
        delta = (m32 / c1) / ((v32 / c2).sqrt_().add_(epsilon))
        delta.add_(p32, alpha=weight_decay)
        m.copy_(m32)
        v.copy_(v32)
        p.copy_(p32.sub_(delta, alpha=lr))
    return state, params


@torch.no_grad()
def sgd_update(grads: Tensors, params: Tensors, lr: float = 0.01,
               weight_decay: float = 0.0) -> Tensors:
    """p -= lr (g + weight_decay p), in place, in the parameters' dtype."""
    for k, g in grads.items():
        p = params[k]
        p.copy_(p - lr * (g + weight_decay * p))
    return params


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, clip_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient in place by min(1, clip_norm / global norm),
    the norm taken in fp32 over all of them. Returns (grads, norm)."""
    total = sum(g.float().square().sum() for g in grads.values())
    gnorm = torch.sqrt(total)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-6), max=1.0)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return grads, gnorm
