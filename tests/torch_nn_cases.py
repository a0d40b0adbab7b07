"""Shared helpers of the ``paddle.nn`` / ``paddle.io`` port tests
(``tests/test_torch_nn_*.py``, ``tests/test_torch_io.py``): seeded numpy
inputs, one call run through the JAX package and through the port with its
output and input gradients, and the weight carry.

A call's inputs are specs: a shape tuple (normal floats), ``("pos",
shape)`` (floats in [0.5, 1.5]), ``("const", shape)`` / ``("constpos",
shape)`` (the same, held constant: no gradient on either side), ``("ids",
shape, hi)`` (int64 in [0, hi)) or a numpy array as it is. Gradients
are taken of ``sum(out * ct)`` for a seeded cotangent ``ct``, for every
floating input and every parameter the two sides hold.

Tolerances: fp32 rtol 1e-5 / atol 1e-6 (the same formulas summed in
another order; a few with longer reductions state their own); bf16 atol
2^-6 of the largest magnitude of the compared array (one bf16 ulp at the
top of the output's range is 2^-7 of it, and the two sides round their
intermediates at different places).
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu
import paddle_tpu_torch as pt
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn.functional_call import substituted_state
from paddle_tpu_torch.core import place

F32 = dict(rtol=1e-5, atol=1e-6)
BF16_REL = 2.0 ** -6


def make_inputs(specs, seed):
    rng = np.random.RandomState(seed)
    out = []
    for s in specs:
        if isinstance(s, np.ndarray):
            out.append(s)
        elif isinstance(s, tuple) and s and s[0] == "pos":
            out.append((rng.rand(*s[1]) + 0.5).astype(np.float32))
        elif isinstance(s, tuple) and s and s[0] == "const":
            out.append(rng.randn(*s[1]))            # float64: a constant
        elif isinstance(s, tuple) and s and s[0] == "constpos":
            out.append(rng.rand(*s[1]) + 0.5)
        elif isinstance(s, tuple) and s and s[0] == "ids":
            out.append(rng.randint(0, s[2], s[1]).astype(np.int64))
        else:
            out.append(rng.randn(*s).astype(np.float32))
    return out


def _floats(arrays):
    """The differentiated inputs: float32 arrays (float64 ones are
    constants, passed as float32)."""
    return [i for i, a in enumerate(arrays) if a.dtype == np.float32]


def _const(a):
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
    a = np.array(x.numpy() if hasattr(x, "numpy") else x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def run_jax(call, arrays, seed, dtype="float32", params=(), tape=False):
    """``call(*tensors)`` on the JAX package: (out, input grads, {param
    name: grad}) of ``sum(out * cotangent(out.shape, seed))``.

    By default the forward and its ``jax.vjp`` are one ``jax.jit`` program
    (the JAX layers' tape off, the parameters substituted as values):
    one compile a case instead of one per primitive and shape. Integer
    inputs are constants of the program. ``tape=True`` runs the JAX
    package's own eager tape instead, for layers whose forward writes
    state (the batch norms' running statistics)."""
    if tape:
        return _run_jax_tape(call, arrays, seed, dtype, params)
    fl = _floats(arrays)
    consts = {i: paddle_tpu.to_tensor(_const(a)) for i, a in enumerate(arrays)
              if i not in fl}
    names = [k for k, _ in params]
    owner = getattr(call, "__self__", call)

    def fwd(pvals, *fvals):
        vals = iter(fvals)
        ts = [consts[i] if i in consts else Tensor(next(vals))
              for i in range(len(arrays))]
        with no_grad(), (substituted_state(owner, dict(zip(names, pvals)))
                         if names else contextlib.nullcontext()):
            out = call(*ts)
        out = out[0] if isinstance(out, (tuple, list)) else out
        return out.value

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fvals = [jnp.asarray(arrays[i], jdt) for i in fl]
    pvals = [p.value for _, p in params]
    shape = jax.eval_shape(fwd, pvals, *fvals)
    ct = jnp.asarray(cotangent(shape.shape, seed), shape.dtype)

    @jax.jit
    def both(pv, *fv):
        out, vjp = jax.vjp(fwd, pv, *fv)
        return out, vjp(ct)

    out, (pg, *xg) = both(pvals, *fvals)
    return (_np(out), [_np(g) for g in xg],
            {k: _np(g) for k, g in zip(names, pg)})


def _run_jax_tape(call, arrays, seed, dtype, params):
    fl = _floats(arrays)
    xs = [paddle_tpu.to_tensor(_const(a), dtype=dtype if i in fl else None,
                               stop_gradient=i not in fl)
          for i, a in enumerate(arrays)]
    out = call(*xs)
    out = out[0] if isinstance(out, (tuple, list)) else out
    ctt = paddle_tpu.to_tensor(cotangent(tuple(out.shape), seed)).astype(
        out.dtype)
    if fl or params:
        (out * ctt).sum().backward()
    grads = [None if xs[i].grad is None else _np(xs[i].grad) for i in fl]
    pgrads = {k: _np(p.grad) for k, p in params if p.grad is not None}
    return _np(out), grads, pgrads


def run_port(call, arrays, seed, dtype=torch.float32, params=()):
    fl = _floats(arrays)
    xs = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(np.ascontiguousarray(_const(a)))
        if i in fl:
            t = t.to(dtype).requires_grad_()
        xs.append(t)
    out = call(*xs)
    out = out[0] if isinstance(out, (tuple, list)) else out
    if fl or params:
        ct = torch.from_numpy(cotangent(tuple(out.shape), seed))
        (out * ct.to(out.dtype)).sum().backward()
    grads = [None if xs[i].grad is None else xs[i].grad.float().numpy()
             for i in fl]
    pgrads = {k: p.grad.float().numpy() for k, p in params
              if p.grad is not None}
    return out.detach().float().numpy(), grads, pgrads


def close(got, want, dtype="float32", tol=None, what=""):
    if got is None or want is None:     # no path, or a path of zeros
        other = want if got is None else got
        assert other is None or not np.any(other), what
        return
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **(tol or F32))
    else:
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_REL * scale, err_msg=what)


def carry(jax_layer, port_layer):
    """The JAX layer's ``state_dict()`` as numpy into the port's
    ``set_state_dict``; both dicts hold the same keys in the same order."""
    sd = {k: _np(v) for k, v in jax_layer.state_dict().items()}
    missing, unexpected = port_layer.set_state_dict(sd)
    assert (missing, unexpected) == ([], []), (missing, unexpected)
    assert list(port_layer.state_dict()) == list(sd)


def cotangent(out_shape, seed):
    return np.asarray(np.random.RandomState(seed + 7).randn(*out_shape),
                      np.float32)


def port_cpu():
    """Fixture body: the port on the CPU, one intra-op thread, the place,
    the default dtype and the generator restored afterwards."""
    threads, prev = torch.get_num_threads(), place._current[0]
    state = pt.get_rng_state()
    torch.set_num_threads(1)
    place.set_device("cpu")
    yield
    pt.set_rng_state(state)
    place._current[0] = prev
    pt.set_default_dtype("float32")
    paddle_tpu.set_default_dtype("float32")
    torch.set_num_threads(threads)
