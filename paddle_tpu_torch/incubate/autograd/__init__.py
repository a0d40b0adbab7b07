"""paddle.incubate.autograd counterpart (port of
``paddle_tpu/incubate/autograd``; reference python/paddle/incubate/
autograd/__init__.py: Jacobian/Hessian/jvp/vjp from functional.py,
forward_grad/grad from primapi.py, prim2orig from primx.py,
enable_prim/disable_prim/prim_enabled from utils.py).

The functional surface maps onto ``torch.func`` (``jacrev``, ``hessian``,
``vmap``, ``jvp``, ``vjp``), as the JAX package's maps onto ``jax.*``, with
the reference's lazy indexing, batch axis and layouts: a single input's
Jacobian keeps jacrev's ``(*out, *in)`` shape; several inputs give one wide
``(out, sum of in)`` matrix; a Hessian is over all inputs flattened into
one vector, cross terms included. The reference's "prim" mode lowers
composite ops to primitives for a rule-based transpose; torch's autograd
differentiates every op already, so the toggles are state only, as in the
JAX package.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils._pytree import tree_map

__all__ = ["Jacobian", "Hessian", "jvp", "vjp", "forward_grad", "grad",
           "prim2orig", "enable_prim", "disable_prim", "prim_enabled"]


def _as_list(xs):
    return list(xs) if isinstance(xs, (list, tuple)) else None


def _detached(xs):
    multi = _as_list(xs)
    if multi is not None:
        return [torch.as_tensor(x).detach() for x in multi]
    return torch.as_tensor(xs).detach()


def _wrap_tree(vals):
    return list(vals) if isinstance(vals, (list, tuple)) else vals


class Jacobian:
    """Lazy Jacobian (reference functional.Jacobian): J[i, j] indexes the
    full matrix; ``batch_axis=0`` treats dim 0 as the batch. Computed once
    through ``torch.func.jacrev`` at the first access."""

    def __init__(self, func, xs, is_batched: bool = False,
                 batch_axis=None):
        if batch_axis not in (None, 0):
            raise ValueError(
                f"batch_axis must be None or 0, got {batch_axis!r}")
        self._func = func
        self._xs = xs
        self._batched = is_batched or batch_axis == 0
        self._mat = None

    def _compute(self):
        if self._mat is not None:
            return self._mat
        xs = _detached(self._xs)
        multi = isinstance(xs, list)
        args = xs if multi else [xs]
        f = self._func
        argnums = tuple(range(len(args))) if multi else 0
        if self._batched:
            def single(*row):
                return f(*[r[None] for r in row])[0]

            jac = torch.func.vmap(torch.func.jacrev(single,
                                                    argnums=argnums))(*args)
        else:
            jac = torch.func.jacrev(f, argnums=argnums)(*args)
        if multi:
            # one wide matrix along the inputs (the reference's layout):
            # each block (*out, *in_i) reshaped to (out, in_i) from the
            # known output size, so scalar inputs and multi-dim outputs
            # keep the right layout
            with torch.no_grad():
                out = f(*([a[:1] for a in args] if self._batched else args))
            if self._batched:
                out_size = math.prod(out.shape[1:]) or 1
                flat = [j.reshape(j.shape[0], out_size, -1) for j in jac]
            else:
                out_size = math.prod(out.shape) or 1
                flat = [j.reshape(out_size, -1) for j in jac]
            jac = torch.cat(flat, dim=-1)
        self._mat = jac
        return jac

    def __getitem__(self, idx):
        return self._compute()[idx]

    @property
    def shape(self):
        return tuple(self._compute().shape)

    def numpy(self):
        return self._compute().detach().cpu().numpy()


class Hessian(Jacobian):
    """Lazy Hessian of a SCALAR-output func (reference functional.Hessian),
    over all inputs flattened into one vector (cross terms included)."""

    def _compute(self):
        if self._mat is not None:
            return self._mat
        xs = _detached(self._xs)
        args = xs if isinstance(xs, list) else [xs]
        f = self._func
        with torch.no_grad():
            out = f(*args)
        out_sz = math.prod(out.shape) or 1
        per_item = math.prod(out.shape[1:]) or 1
        if (per_item if self._batched else out_sz) != 1:
            raise TypeError(
                f"Hessian needs a scalar-output function (per batch item "
                f"when batched); got output shape {tuple(out.shape)}")
        if self._batched:
            shapes = [a.shape[1:] for a in args]
        else:
            shapes = [a.shape for a in args]
        sizes = [math.prod(s) if len(s) else 1 for s in shapes]
        offs = [0]
        for s in sizes:
            offs.append(offs[-1] + s)

        def parts(z):
            return [z[offs[i]:offs[i + 1]].reshape(shapes[i])
                    for i in range(len(args))]

        if self._batched:
            def single(z):
                return torch.sum(f(*[p[None] for p in parts(z)]))

            zb = torch.cat([a.reshape(a.shape[0], -1) for a in args], -1)
            h = torch.func.vmap(torch.func.hessian(single))(zb)
        else:
            def scalar_of_vec(z):
                return torch.sum(f(*parts(z)))

            z = torch.cat([a.reshape(-1) for a in args])
            h = torch.func.hessian(scalar_of_vec)(z)
        self._mat = h
        return h


def jvp(func: Callable, xs, v=None):
    """Forward mode: returns (func(xs), J @ v) (reference functional.jvp;
    v defaults to ones)."""
    xs = _detached(xs)
    args = xs if isinstance(xs, list) else [xs]
    if v is None:
        tangents = [torch.ones_like(a) for a in args]
    else:
        tangents = _detached(v)
        tangents = tangents if isinstance(tangents, list) else [tangents]
    out, tangent_out = torch.func.jvp(func, tuple(args), tuple(tangents))
    return _wrap_tree(out), _wrap_tree(tangent_out)


def vjp(func: Callable, xs, v=None):
    """Reverse mode: returns (func(xs), J^T @ v) (reference
    functional.vjp; v defaults to ones over the output)."""
    xs = _detached(xs)
    multi = isinstance(xs, list)
    args = xs if multi else [xs]
    out, pullback = torch.func.vjp(func, *args)
    if v is not None:
        cot = _detached(v)
        if isinstance(cot, list):      # the output's tuple structure
            cot = tuple(cot)
    else:
        cot = tree_map(torch.ones_like, out)
    grads = pullback(cot)
    grads = list(grads) if multi else grads[0]
    return _wrap_tree(out), _wrap_tree(grads)


def forward_grad(outputs, inputs, grad_inputs=None):
    """reference primapi.forward_grad: forward-mode gradients in the
    static prim world, which the port has not (``static`` is not ported);
    eager forward mode is :func:`jvp`."""
    raise NotImplementedError(
        "forward_grad operates on the reference's static prim program; "
        "use incubate.autograd.jvp (eager forward-mode) instead")


def grad(outputs, inputs, grad_outputs=None):
    """reference primapi.grad (static prim reverse mode). Eager
    equivalent: paddle.grad, delegated for API familiarity."""
    from ...autograd.functional import grad as eager_grad

    return eager_grad(outputs, inputs, grad_outputs)


def prim2orig(block=None):
    """No prim dialect to lower back from (reference primx.prim2orig)."""
    return None


_prim_flag = [False]


def enable_prim():
    """Toggle kept for parity: torch's autograd already differentiates
    every op; there is no composite mode to switch away from."""
    _prim_flag[0] = True


def disable_prim():
    _prim_flag[0] = False


def prim_enabled() -> bool:
    return _prim_flag[0]
