"""Eager optimizers (port of ``paddle_tpu/optimizer/optimizer.py``).

``loss.backward(); opt.step(); opt.clear_grad()``, as a PaddlePaddle user
trains. Each ``step()`` folds coupled weight decay into the gradients
(``weight_decay`` as a float or ``L2Decay``, or ``L1Decay``; AdamW's own
decay is decoupled), applies ``grad_clip``, advances the step count, reads
the learning rate (a float or an ``lr.LRScheduler``) and updates every
parameter that has a gradient, in place on ``p.data`` under
``torch.no_grad()``.

The arithmetic is the reference's, in the same order and dtypes:
accumulators start as ``zeros_like(p)`` in the parameter's dtype; SGD,
Momentum, Adagrad, Adadelta, RMSProp and Adamax compute in the dtypes the
operands promote to, Adam, AdamW and Lamb in fp32, each new value cast back
to the parameter's dtype. So with bf16 parameters the Adam moments start in
bf16 and are fp32 after the first step, and no fp32 master copy is kept
(``multi_precision`` is stored and unused, as in the reference;
``distributed.fleet.utils.MixPrecisionOptimizer`` is the master-weight
path). Bias-correction powers are fp32 values kept on the host, advanced
by fp32 products as the reference's fp32 scalars are.

SGD, Momentum, Adam and AdamW update all parameters together with
``torch._foreach_*`` calls (in chunks of at most 2^26 elements, to bound
the temporaries); the others walk the parameters one by one.

Parameter names. The reference keys its state by ``p.name``, a
process-wide counter (``param_0``, ``param_1``, ... in creation order). A
torch parameter has no name, so the port's rule is: when ``parameters``
is a list of tensors (``model.parameters()``), parameter i of the
optimizer's flat list is ``param_{i}``; when it holds ``(name, tensor)``
pairs (``model.named_parameters()``), the names are the model's. State
keys are ``f"{name}_{accumulator}"`` as in the reference, and AdamW's
``apply_decay_param_fun`` receives the name. Parameter groups (dicts with
``"params"``) are flattened in order; as in the reference their other keys
are not read.

``minimize`` runs the eager branch (``loss.backward(); step()``): the port
has no static mode.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ._foreach import chunks, f32_copies
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta", "RMSProp",
           "Adam", "AdamW", "Adamax", "Lamb", "LBFGS", "L1Decay", "L2Decay"]

_F32 = torch.float32
_POWS = ("beta1_pow", "beta2_pow")   # host fp32 scalars, not tensors


def _f32mul(a: float, b: float) -> float:
    """The fp32 product of two fp32 values (a reference fp32 scalar times
    a Python float, which JAX casts to fp32 first)."""
    return float(np.float32(a) * np.float32(b))


def _f32sub1(a: float) -> float:
    """1 - a in fp32."""
    return float(np.float32(1.0) - np.float32(a))


class L2Decay:
    """``paddle.regularizer.L2Decay``: coupled decay added to the grad."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + self.coeff * p


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + self.coeff * torch.sign(p)


def _flatten(parameters) -> Tuple[List[torch.Tensor], List[str]]:
    """(params, names) by the module docstring's rule."""
    if parameters is None:
        return [], []
    items = list(parameters)
    if items and isinstance(items[0], dict):
        flat = []
        for group in items:
            flat.extend(group["params"])
        items = flat
    if items and isinstance(items[0], tuple):
        return [p for _, p in items], [n for n, _ in items]
    return items, [f"param_{i}" for i in range(len(items))]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._learning_rate = learning_rate
        params, names = _flatten(parameters)
        self._parameter_list = params if parameters is not None else None
        self._names = {id(p): n for p, n in zip(params, names)}
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if isinstance(weight_decay, (int, float)):
            self._regularization = L2Decay(weight_decay)
        else:
            self._regularization = weight_decay
        # accumulator name -> {parameter name: tensor (or fp32 float)}
        self._accumulators: Dict[str, Dict[str, Any]] = {}
        self._step_count = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when lr is an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- state -------------------------------------------------------------
    def _key(self, p) -> str:
        return self._names[id(p)]

    def _acc(self, name: str, p, init=None):
        d = self._accumulators.setdefault(name, {})
        k = self._key(p)
        if k not in d:
            d[k] = torch.zeros_like(p) if init is None else init
        return d[k]

    def _set_acc(self, name: str, p, value):
        self._accumulators[name][self._key(p)] = value

    def state_dict(self) -> Dict[str, Any]:
        sd: Dict[str, Any] = {}
        for acc_name, d in self._accumulators.items():
            for pkey, v in d.items():
                sd[f"{pkey}_{acc_name}"] = (
                    torch.tensor(v, dtype=_F32) if acc_name in _POWS else v)
        sd["global_step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def _restore(self, acc_name: str, pkey: str, v):
        if acc_name in _POWS:
            return float(np.float32(float(v.item() if hasattr(v, "item")
                                          else v)))
        p = next(q for q in self._parameter_list or []
                 if self._key(q) == pkey)
        t = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v)
        return t.to(p.device).clone()

    def set_state_dict(self, state_dict: Dict[str, Any]):
        if "global_step" in state_dict:
            v = state_dict["global_step"]
            self._step_count = int(v.item() if hasattr(v, "item") else v)
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(
                dict(state_dict["LR_Scheduler"]))
        restored = set()
        for acc_name, d in self._accumulators.items():
            for pkey in list(d.keys()):
                full = f"{pkey}_{acc_name}"
                if full in state_dict:
                    d[pkey] = self._restore(acc_name, pkey, state_dict[full])
                    restored.add(full)
        # a fresh optimizer has no accumulators yet: match the remaining
        # keys against the parameter names, longest name first
        pkeys = sorted((self._key(p) for p in self._parameter_list or []),
                       key=len, reverse=True)
        for full, v in state_dict.items():
            if full in restored or full in ("global_step", "LR_Scheduler") \
                    or full.startswith("__"):
                continue
            for pkey in pkeys:
                if full.startswith(pkey + "_"):
                    acc_name = full[len(pkey) + 1:]
                    self._accumulators.setdefault(acc_name, {})[pkey] = \
                        self._restore(acc_name, pkey, v)
                    break

    set_dict = set_state_dict

    # -- core --------------------------------------------------------------
    def _collect_params_grads(self):
        if self._parameter_list is None:
            raise ValueError("optimizer created without parameters")
        return [(p, p.grad) for p in self._parameter_list
                if p.requires_grad or p.grad is not None]

    def _decoupled_wd(self) -> bool:
        return False

    @torch.no_grad()
    def _apply_decay_and_clip(self, params_grads):
        out = list(params_grads)
        if not self._decoupled_wd():
            shared = []
            for i, (p, g) in enumerate(params_grads):
                if g is None:
                    continue
                reg = getattr(p, "regularizer", None)
                if reg is not None:
                    out[i] = (p, reg(p, g))
                elif self._regularization is not None:
                    shared.append(i)
            reg = self._regularization
            if shared and isinstance(reg, L2Decay):
                decayed = torch._foreach_add(
                    [params_grads[i][1] for i in shared], torch._foreach_mul(
                        [params_grads[i][0] for i in shared], reg.coeff))
                for i, g in zip(shared, decayed):
                    out[i] = (params_grads[i][0], g)
            else:
                for i in shared:
                    p, g = params_grads[i]
                    out[i] = (p, reg(p, g))
        if self._grad_clip is not None:
            out = self._grad_clip(out)
        return out

    def _param_lr(self, p, lr: float) -> float:
        attr = getattr(p, "optimize_attr", None)
        return lr * attr.get("learning_rate", 1.0) if attr else lr

    @torch.no_grad()
    def step(self):
        params_grads = self._apply_decay_and_clip(
            self._collect_params_grads())
        self._step_count += 1
        lr = self.get_lr()
        live = [(p, g, self._param_lr(p, lr)) for p, g in params_grads
                if g is not None]
        if live:
            self._update(live)

    def _update(self, live):
        """Update every (param, grad, lr) of ``live``; one by one unless an
        optimizer overrides it."""
        for p, g, lr in live:
            p.data.copy_(self._update_param(p, g, lr))

    def _update_param(self, p, g, lr):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list or []:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, live):
        for run in chunks(live, lambda t: t[0].numel()):
            ps = [p.data for p, _, _ in run]
            steps = torch._foreach_mul([g for _, g, _ in run],
                                       [lr for _, _, lr in run])
            torch._foreach_sub_(ps, steps)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._rescale = rescale_grad

    def _update(self, live):
        for run in chunks(live, lambda t: t[0].numel()):
            ps = [p for p, _, _ in run]
            gs = torch._foreach_mul([g for _, g, _ in run], self._rescale)
            vs = torch._foreach_mul([self._acc("velocity", p) for p in ps],
                                    self._momentum)
            torch._foreach_add_(vs, gs)
            for p, v in zip(ps, vs):
                self._set_acc("velocity", p, v)
            if self._use_nesterov:
                upd = torch._foreach_add(gs, torch._foreach_mul(
                    vs, self._momentum))
            else:
                upd = vs
            torch._foreach_sub_([p.data for p in ps], torch._foreach_mul(
                upd, [lr for _, _, lr in run]))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g, lr):
        if self._key(p) not in self._accumulators.get("moment", {}):
            self._acc("moment", p, init=torch.full_like(p, self._init_acc))
        m = self._acc("moment", p)
        m_new = m + g * g
        self._set_acc("moment", p, m_new)
        return p - lr * g / (torch.sqrt(m_new) + self._epsilon)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _update_param(self, p, g, lr):
        avg_sq = self._acc("avg_squared_grad", p)
        avg_upd = self._acc("avg_squared_update", p)
        avg_sq = self._rho * avg_sq + (1 - self._rho) * g * g
        upd = (g * torch.sqrt(avg_upd + self._epsilon)
               / torch.sqrt(avg_sq + self._epsilon))
        avg_upd = self._rho * avg_upd + (1 - self._rho) * upd * upd
        self._set_acc("avg_squared_grad", p, avg_sq)
        self._set_acc("avg_squared_update", p, avg_upd)
        return p - lr * upd


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update_param(self, p, g, lr):
        ms = self._acc("mean_square", p)
        ms = self._rho * ms + (1 - self._rho) * g * g
        self._set_acc("mean_square", p, ms)
        if self._centered:
            mg = self._acc("mean_grad", p)
            mg = self._rho * mg + (1 - self._rho) * g
            self._set_acc("mean_grad", p, mg)
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._acc("momentum", p)
        mom = self._momentum * mom + lr * g / denom
        self._set_acc("momentum", p, mom)
        return p - mom


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _decay_of(self, p, lr: float) -> Tuple[float, float]:
        """(lr, decoupled decay coefficient) of ``p``: plain Adam has no
        decoupled decay."""
        return lr, 0.0

    def _update(self, live):
        b1, b2 = float(self._beta1), float(self._beta2)
        for run in chunks(live, lambda t: t[0].numel()):
            self._adam_run(run, b1, b2)

    def _adam_run(self, run, b1, b2):
        """One foreach pass over a chunk, the reference's fp32 arithmetic:
        p' = p (1 - lr wd) - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t))
        + eps) with m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g g."""
        ps = [p for p, _, _ in run]
        lrs, decays, c1s, c2s = [], [], [], []
        pows = {}                    # fp32 power -> its next power
        for p, _, lr in run:
            lr, decay = self._decay_of(p, lr)
            lrs.append(lr)
            decays.append(decay)
            for acc, beta, cs in (("beta1_pow", b1, c1s),
                                  ("beta2_pow", b2, c2s)):
                old = self._acc(acc, p, init=1.0)
                new = pows.setdefault((acc, old), _f32mul(old, beta))
                self._set_acc(acc, p, new)
                cs.append(_f32sub1(new))
        # fp32 parameters update in place; others through fp32 copies
        pfs = f32_copies([p.data for p in ps])
        dec = [i for i, d in enumerate(decays) if d]
        if dec:                      # decoupled, before the Adam update
            torch._foreach_mul_([pfs[i] for i in dec],
                                [1.0 - lrs[i] * decays[i] for i in dec])
        gfs = f32_copies([g for _, g, _ in run])
        ms = _decayed_f32([self._acc("moment1", p) for p in ps], b1)
        torch._foreach_add_(ms, torch._foreach_mul(gfs, 1 - b1))
        vs = _decayed_f32([self._acc("moment2", p) for p in ps], b2)
        sq = torch._foreach_mul(gfs, 1 - b2)
        torch._foreach_mul_(sq, gfs)
        torch._foreach_add_(vs, sq)
        del sq, gfs
        for p, m, v in zip(ps, ms, vs):
            self._set_acc("moment1", p, m)
            self._set_acc("moment2", p, v)
        denom = torch._foreach_div(vs, c2s)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_div(ms, c1s)
        torch._foreach_mul_(upd, lrs)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_sub_(pfs, upd)
        low = [i for i, p in enumerate(ps) if pfs[i] is not p.data]
        if low:                      # round back, as astype does
            torch._foreach_copy_([ps[i].data for i in low],
                                 [pfs[i] for i in low])


def _decayed_f32(ts: List[torch.Tensor], beta: float) -> List[torch.Tensor]:
    """beta * t for each accumulator, promoted to fp32 as the reference's
    ``beta * t + fp32`` is: fp32 ones scaled in place, others multiplied in
    their own dtype, then cast."""
    f32 = [t for t in ts if t.dtype == _F32]
    if f32:
        torch._foreach_mul_(f32, beta)
    return [t if t.dtype == _F32 else (t * beta).float() for t in ts]


class AdamW(Adam):
    """Decoupled weight decay (reference: paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._wd_coeff = (float(weight_decay)
                          if isinstance(weight_decay, (int, float))
                          else weight_decay.coeff)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled_wd(self):
        return True

    def _decay_of(self, p, lr: float) -> Tuple[float, float]:
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        decay = self._wd_coeff
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(self._key(p))):
            decay = 0.0
        return lr, decay


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update_param(self, p, g, lr):
        m = self._acc("moment", p)
        u = self._acc("inf_norm", p)
        b1p = _f32mul(self._acc("beta1_pow", p, init=1.0), self._beta1)
        m = self._beta1 * m + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * u, torch.abs(g))
        self._set_acc("moment", p, m)
        self._set_acc("inf_norm", p, u)
        self._set_acc("beta1_pow", p, b1p)
        # lr / (1 - b1p) is an fp32 scalar in the reference
        scale = float(np.float32(lr) / np.float32(_f32sub1(b1p)))
        return p - scale * m / (u + self._epsilon)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g, lr):
        b1p = _f32mul(self._acc("beta1_pow", p, init=1.0), self._beta1)
        b2p = _f32mul(self._acc("beta2_pow", p, init=1.0), self._beta2)
        gf = g.float()
        pf = p.float()
        m = (_decayed_f32([self._acc("moment1", p)], self._beta1)[0]
             + (1 - self._beta1) * gf)
        v = (_decayed_f32([self._acc("moment2", p)], self._beta2)[0]
             + (1 - self._beta2) * gf * gf)
        r = (m / _f32sub1(b1p)) / (torch.sqrt(v / _f32sub1(b2p))
                                   + self._epsilon)
        wd = (0.0 if (self._exclude_fn is not None and self._exclude_fn(p))
              else self._wd)
        upd = r + wd * pf
        w_norm = torch.linalg.vector_norm(pf)
        u_norm = torch.linalg.vector_norm(upd)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        self._set_acc("beta1_pow", p, b1p)
        self._set_acc("beta2_pow", p, b2p)
        return pf - lr * trust * upd


class LBFGS(Optimizer):
    """Limited-memory BFGS (host-driven loop over flat fp32 vectors, as
    the reference's Python implementation; ``line_search_fn`` is stored
    and, as there, not used)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._max_eval = (max_eval if max_eval is not None
                          else max_iter * 5 // 4)
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history_size = history_size
        self._line_search_fn = line_search_fn
        self._state = {"old_dirs": [], "old_stps": [], "ro": [],
                       "prev_flat_grad": None, "H_diag": 1.0, "n_iter": 0,
                       "d": None, "t": None}

    def _gather_flat_grad(self):
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .reshape(-1) for p in self._parameter_list])

    @torch.no_grad()
    def _add_to_params(self, step_size, direction):
        offset = 0
        for p in self._parameter_list:
            n = p.numel()
            p.data.copy_(p + step_size
                         * direction[offset:offset + n].view_as(p))
            offset += n

    def step(self, closure=None):
        if closure is None:
            raise RuntimeError(
                "LBFGS.step requires a closure returning the loss")
        st = self._state
        loss = closure()
        flat_grad = self._gather_flat_grad()
        if float(flat_grad.abs().max()) <= self._tol_grad:
            return loss
        n_evals = 1
        for _ in range(self._max_iter):
            st["n_iter"] += 1
            if st["n_iter"] == 1:
                d = -flat_grad
                H_diag = 1.0
            else:
                y = flat_grad - st["prev_flat_grad"]
                s = st["d"] * st["t"]
                ys = float(y @ s)
                if ys > 1e-10:
                    if len(st["old_dirs"]) >= self._history_size:
                        st["old_dirs"].pop(0)
                        st["old_stps"].pop(0)
                        st["ro"].pop(0)
                    st["old_dirs"].append(y)
                    st["old_stps"].append(s)
                    st["ro"].append(1.0 / ys)
                    H_diag = ys / float(y @ y)
                else:
                    H_diag = st["H_diag"]
                q = -flat_grad
                alphas = []
                for s_i, y_i, ro_i in zip(reversed(st["old_stps"]),
                                          reversed(st["old_dirs"]),
                                          reversed(st["ro"])):
                    a = ro_i * float(s_i @ q)
                    alphas.append(a)
                    q = q - a * y_i
                d = q * H_diag
                for (s_i, y_i, ro_i), a in zip(
                        zip(st["old_stps"], st["old_dirs"], st["ro"]),
                        reversed(alphas)):
                    b = ro_i * float(y_i @ d)
                    d = d + s_i * (a - b)
            st["prev_flat_grad"] = flat_grad
            st["H_diag"] = H_diag
            t = self.get_lr() if st["n_iter"] > 1 else min(
                1.0, 1.0 / float(flat_grad.abs().sum())) * self.get_lr()
            self._add_to_params(t, d)
            st["d"], st["t"] = d, t
            loss = closure()
            flat_grad = self._gather_flat_grad()
            n_evals += 1
            if n_evals >= self._max_eval:
                break
            if float(flat_grad.abs().max()) <= self._tol_grad:
                break
            if float((d * t).abs().max()) <= self._tol_change:
                break
        return loss
