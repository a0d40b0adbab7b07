"""Dynamic loss scaling (port of ``paddle_tpu/amp/grad_scaler.py``).

The reference's state machine, unchanged: ``scale`` multiplies the loss by
the scale; ``unscale_`` multiplies every gradient by the fp32 ``1 / scale``
(a product, not a division, so the bits match) and notes any non-finite
value; ``step`` unscales if that has not happened yet and skips the
optimizer's update on inf or nan; ``update`` halves the scale after
``decr_every_n_nan_or_inf`` bad steps (never below 1) and doubles it after
``incr_every_n_steps`` good ones.

The reference reads one bool per parameter. Here the gradients are
multiplied with ``torch._foreach_mul_`` and the non-finite check is one
reduction over all of them (the max of |g| per tensor, then whether all
are finite): one host read a step, the same answer.
"""
from __future__ import annotations

from enum import Enum
from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["GradScaler", "AmpScaler", "OptimizerState", "unscale_grads"]


class OptimizerState(Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


@torch.no_grad()
def unscale_grads(grads: List[torch.Tensor], inv: float) -> bool:
    """Multiply every tensor of ``grads`` by ``inv`` in place (each in its
    own dtype, the product taken in fp32) and return whether any of them
    holds an inf or a nan (one host read)."""
    if not grads:
        return False
    torch._foreach_mul_(grads, inv)
    peaks = torch._foreach_norm(grads, float("inf"))
    return not bool(torch.isfinite(torch.stack(
        [p.float() for p in peaks] if len({p.dtype for p in peaks}) > 1
        else peaks)).all())


class GradScaler:
    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 16,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = bool(enable)
        self._init_loss_scaling = float(init_loss_scaling)
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_count = 0
        self._decr_count = 0
        self._found_inf = False
        self._opt_state = OptimizerState.INIT

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic_loss_scaling

    def scale(self, var):
        """The loss times the current scale."""
        if not self._enable:
            return var
        return var * self._scale

    def _grads(self, optimizer) -> List[torch.Tensor]:
        return [p.grad for p in optimizer._parameter_list
                if p is not None and p.grad is not None]

    def unscale_(self, optimizer):
        """Multiply the optimizer's gradients by 1 / scale in place and note
        whether any is non-finite."""
        if not self._enable or self._opt_state == OptimizerState.UNSCALED:
            return
        if self._opt_state == OptimizerState.STEPPED:
            raise RuntimeError(
                "unscale_() is being called after step(); call update() "
                "first (grads were already unscaled for this iteration)")
        self._found_inf = unscale_grads(self._grads(optimizer),
                                        1.0 / self._scale)
        self._opt_state = OptimizerState.UNSCALED

    def step(self, optimizer):
        """Unscale (if not already) and step, unless a gradient is
        non-finite."""
        if not self._enable:
            optimizer.step()
            return
        if self._opt_state == OptimizerState.STEPPED:
            raise RuntimeError("step() has already been called since the "
                               "last update().")
        if self._opt_state != OptimizerState.UNSCALED:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._opt_state = OptimizerState.STEPPED

    def update(self):
        """Advance the dynamic-scale state machine."""
        if not self._enable:
            return
        if self._use_dynamic_loss_scaling:
            if self._found_inf:
                self._incr_count = 0
                self._decr_count += 1
                if self._decr_count >= self._decr_every_n_nan_or_inf:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._decr_count = 0
            else:
                self._decr_count = 0
                self._incr_count += 1
                if self._incr_count >= self._incr_every_n_steps:
                    self._scale *= self._incr_ratio
                    self._incr_count = 0
        self._found_inf = False
        self._opt_state = OptimizerState.INIT

    def minimize(self, optimizer, scaled_loss):
        """``scaled_loss.backward()`` must have run; steps and updates."""
        self.step(optimizer)
        self.update()

    # -- scale accessors ----------------------------------------------------
    def get_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._init_loss_scaling = float(v)
        self._scale = float(v)

    def get_init_loss_scaling(self):
        return self._init_loss_scaling

    def set_incr_ratio(self, v):
        self._incr_ratio = v

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_decr_ratio(self, v):
        self._decr_ratio = v

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_incr_every_n_steps(self, v):
        self._incr_every_n_steps = v

    def get_incr_every_n_steps(self):
        return self._incr_every_n_steps

    def set_decr_every_n_nan_or_inf(self, v):
        self._decr_every_n_nan_or_inf = v

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every_n_nan_or_inf

    def state_dict(self) -> Dict[str, Any]:
        if not self._enable:
            return {}
        return {
            "scale": np.asarray(self._scale, np.float32),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_count": self._incr_count,
            "decr_count": self._decr_count,
            "use_dynamic_loss_scaling": self._use_dynamic_loss_scaling,
        }

    def load_state_dict(self, state: Dict[str, Any]):
        if not self._enable or not state:
            return
        self._scale = float(state["scale"])
        self._incr_ratio = state["incr_ratio"]
        self._decr_ratio = state["decr_ratio"]
        self._incr_every_n_steps = state["incr_every_n_steps"]
        self._decr_every_n_nan_or_inf = state["decr_every_n_nan_or_inf"]
        self._incr_count = state.get("incr_count", 0)
        self._decr_count = state.get("decr_count", 0)
        self._use_dynamic_loss_scaling = state.get(
            "use_dynamic_loss_scaling", True)


AmpScaler = GradScaler  # legacy alias
