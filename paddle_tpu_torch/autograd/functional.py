"""paddle.grad / paddle.autograd.backward, jacobian and hessian over
``torch.autograd`` (port of ``paddle_tpu/autograd/functional.py``)."""
from __future__ import annotations

import torch

__all__ = ["backward", "grad", "jacobian", "hessian", "saved_tensors_hooks"]


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``."""
    torch.autograd.backward(
        _as_list(tensors),
        _as_list(grad_tensors) if grad_tensors is not None else None,
        retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad parity: the gradients of ``outputs`` with respect to
    ``inputs`` as a list (``None`` for an input the outputs do not use, when
    ``allow_unused``); the leaves' ``.grad`` are left alone.
    ``create_graph=True`` records the gradient's own graph, so it can be
    differentiated again. ``only_inputs`` and ``no_grad_vars`` are taken
    for the signature's sake, as the reference takes them."""
    outputs = _as_list(outputs)
    grad_outputs = (_as_list(grad_outputs) if grad_outputs is not None
                    else None)
    res = torch.autograd.grad(
        outputs, _as_list(inputs), grad_outputs,
        retain_graph=create_graph if retain_graph is None else retain_graph,
        create_graph=create_graph, allow_unused=allow_unused)
    return list(res)


def jacobian(func, xs, create_graph=False, batch_axis=None):
    """The Jacobian of ``func`` at ``xs``, laid out as the reference's
    (``jax.jacrev``): ``out.shape + x.shape`` for each input, one tensor for
    a single ``xs``, a list for a list. The reference takes ``batch_axis``
    and computes the full Jacobian whatever it is; so does the port."""
    single = not isinstance(xs, (list, tuple))
    xs_t = tuple([xs] if single else xs)
    jac = torch.autograd.functional.jacobian(
        lambda *a: func(a[0]) if single else func(*a), xs_t,
        create_graph=create_graph)
    return jac[0] if single else list(jac)


def hessian(func, xs, create_graph=False, batch_axis=None):
    """The Hessian of a scalar ``func`` at ``xs``: one tensor
    ``x.shape + x.shape`` for a single ``xs``, a list of lists of blocks for
    a list (``batch_axis`` as in :func:`jacobian`)."""
    single = not isinstance(xs, (list, tuple))
    xs_t = tuple([xs] if single else xs)
    hes = torch.autograd.functional.hessian(
        lambda *a: (func(a[0]) if single else func(*a)).reshape(()), xs_t,
        create_graph=create_graph)
    if single:
        return hes[0][0]
    return [[hes[i][j] for j in range(len(xs_t))] for i in range(len(xs_t))]


# pack / unpack hooks on the tensors autograd saves for the backward,
# PyLayer's save_for_backward among them
saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks
