"""Main-gradient mixed precision (port of
``paddle_tpu/distributed/fleet/utils/mix_precision_utils.py``).

``MixPrecisionLayer`` casts a model's floating parameters to bf16 (or
fp16) and gives each one an fp32 ``main_grad``: after every backward the
fresh low-precision gradient is added into it with a plain fp32 add
(``main_grad + g.float()``, as the reference's grad hook does, ``:40-46``).
The hook is ``Tensor.register_post_accumulate_grad_hook``: it runs once a
backward has summed the parameter's gradient, and it then clears
``p.grad``, so the next backward's gradient arrives alone and is added in
the same order as the reference's (one fp32 add per backward) while no
low-precision gradient is held between backwards.

``MixPrecisionOptimizer`` steps the inner optimizer on fp32 master weights
with ``main_grad`` as their gradient (swapping each parameter's data for
its master, ``:60-131``), then writes the updated masters back into the
low-precision parameters in place. Its ``state_dict`` carries the masters
under ``"mix_precision_masters"``, keyed by the inner optimizer's
parameter names.

``MixPrecisionScaler`` wraps a ``GradScaler`` for this flow. The
reference's shim unscales ``p.grad`` and steps whatever it finds; here
``p.grad`` is cleared by the hook, so it unscales ``main_grad`` (the fp32
product by 1 / scale, one non-finite check a step) and skips the step on
inf or nan, as the scaler does for plain gradients.
"""
from __future__ import annotations

import torch

from ....amp.grad_scaler import OptimizerState, unscale_grads

__all__ = ["MixPrecisionLayer", "MixPrecisionOptimizer",
           "MixPrecisionScaler"]

_LOW = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
        "float16": torch.float16, "fp16": torch.float16}


def _accumulate_main_grad(p: torch.Tensor) -> None:
    g32 = p.grad.float()
    if p.main_grad is None:
        p.main_grad = g32 if g32 is not p.grad else g32.clone()
    else:
        p.main_grad.add_(g32)
    p.grad = None


class MixPrecisionLayer:
    """Wrap ``layers``: its floating parameters become ``dtype`` and each
    gets an fp32 ``main_grad`` fed by a post-accumulate grad hook."""

    def __init__(self, layers, dtype: str = "bfloat16"):
        self._layers = layers
        target = _LOW[dtype]
        with torch.no_grad():
            for _, p in layers.named_parameters():
                if p.is_floating_point():
                    p.data = p.data.to(target)
                p.main_grad = None
                p.register_post_accumulate_grad_hook(_accumulate_main_grad)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    __call__ = forward

    def __getattr__(self, item):
        return getattr(self._layers, item)


class MixPrecisionOptimizer:
    """Step ``optimizer`` on fp32 master copies with ``main_grad``."""

    def __init__(self, optimizer):
        self._inner = optimizer
        self._masters = {}

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def _params(self):
        return list(self._inner._parameter_list or [])

    @torch.no_grad()
    def step(self):
        swapped = []
        for p in self._params():
            g = getattr(p, "main_grad", None)
            if g is None and p.grad is None:
                continue
            master = self._masters.get(id(p))
            if master is None:
                master = p.data.float()
                if master is p.data:
                    master = master.clone()
            low_data, low_grad = p.data, p.grad
            p.grad = None
            p.data = master
            p.grad = g if g is not None else low_grad.float()
            swapped.append((p, low_data, low_grad))
        self._inner.step()
        for p, low_data, low_grad in swapped:
            self._masters[id(p)] = p.data       # the updated fp32 master
            p.grad = None
            low_data.copy_(p.data)
            p.data = low_data
            p.grad = low_grad

    def clear_grad(self, set_to_zero: bool = True):
        self._inner.clear_grad()
        for p in self._params():
            p.main_grad = None

    def state_dict(self):
        """The inner optimizer's state and the fp32 masters, by the inner
        optimizer's parameter names (ids do not survive a restart)."""
        sd = self._inner.state_dict()
        sd["mix_precision_masters"] = {
            self._inner._key(p): self._masters[id(p)]
            for p in self._params() if id(p) in self._masters}
        return sd

    @torch.no_grad()
    def set_state_dict(self, sd):
        masters = (sd.pop("mix_precision_masters", None)
                   if isinstance(sd, dict) else None)
        out = self._inner.set_state_dict(sd)
        if masters:
            by_name = {self._inner._key(p): p for p in self._params()}
            for name, m in masters.items():
                p = by_name.get(name)
                if p is not None:
                    m = torch.as_tensor(m).to(device=p.device,
                                              dtype=torch.float32)
                    self._masters[id(p)] = m.clone()
                    p.data.copy_(m)
        return out


class MixPrecisionScaler:
    """A ``GradScaler`` over ``main_grad`` (see the module docstring);
    without one, scale is the identity and ``step`` steps."""

    def __init__(self, scaler=None):
        self._scaler = scaler

    def _on(self) -> bool:
        return self._scaler is not None and self._scaler.is_enable()

    def scale(self, loss):
        return self._scaler.scale(loss) if self._scaler else loss

    def unscale_(self, optimizer):
        sc = self._scaler
        if not self._on() or sc._opt_state == OptimizerState.UNSCALED:
            return
        if sc._opt_state == OptimizerState.STEPPED:
            raise RuntimeError("unscale_() is being called after step(); "
                               "call update() first")
        grads = [p.main_grad for p in optimizer._parameter_list
                 if getattr(p, "main_grad", None) is not None]
        sc._found_inf = unscale_grads(grads, 1.0 / sc._scale)
        sc._opt_state = OptimizerState.UNSCALED

    def step(self, optimizer):
        if not self._on():
            optimizer.step()
            return
        sc = self._scaler
        if sc._opt_state == OptimizerState.STEPPED:
            raise RuntimeError("step() has already been called since the "
                               "last update().")
        self.unscale_(optimizer)
        if not sc._found_inf:
            optimizer.step()
        sc._opt_state = OptimizerState.STEPPED

    def update(self):
        if self._scaler:
            self._scaler.update()
