"""The cases that hold paddle_tpu_torch's tensor surface against
paddle_tpu's, shared by the ``test_torch_tensor_*.py`` files.

A case is ``(fn, args)`` or ``(fn, args, tol)``: ``fn(P, *args)`` runs with
``P`` either package, each numpy array of ``args`` made a tensor by that
package's ``to_tensor`` (other arguments passed as they are). The outputs
(nested tuples and lists too) must agree: the same shapes, the same kind of
dtype (bool, integer, floating, complex; the port's 64-bit names are 64-bit,
so an int64 index is int32 in the JAX package), integers and bools exactly,
floats within ``TOL`` unless the case states its own.

- ``HELD``: forward cases of every op that is neither in ``GRAD`` nor
  random, at two or three shapes, broadcasting and a negative axis among
  them.
- ``GRAD``: the names ``tests/test_check_grad_sweep.py`` checks
  (``AUTO_UNARY``, ``AUTO_BINARY``, ``_SPECIAL``), each ``(fn, inputs,
  kwargs)`` on the sweep's own probe inputs; the gradient of
  ``sum(out * w)`` through each package's ``grad`` must agree, and the
  forward too. ``FORWARD`` adds forward cases at other shapes for some.
- ``RANDOM``: the random ops, checked for repeatability and for their
  distributions (``test_torch_tensor_linalg.py``).
- ``LEFT``: names of the JAX package the port leaves out, each with its
  reason (the same list as ROADMAP's long-tail item, A14d).
"""
from __future__ import annotations

import numpy as np
import torch

import paddle_tpu
import paddle_tpu_torch
import test_check_grad_sweep as sweep

TOL = dict(rtol=1e-5, atol=1e-6)          # fp32
# special functions: the two libraries' series and rational approximations
# differ by a few ulps more than the elementwise basics
SPECIAL_TOL = dict(rtol=1e-4, atol=1e-5)
# factorizations: LAPACK's and XLA's orders of operations
LINALG_TOL = dict(rtol=1e-4, atol=1e-5)

R = np.random.RandomState(20)


def u(*s, lo=0.1, hi=0.9):
    return (R.rand(*s) * (hi - lo) + lo).astype(np.float32)


def n(*s, scale=1.0):
    return (R.randn(*s) * scale).astype(np.float32)


def ints(*s, lo=0, hi=6):
    return R.randint(lo, hi, s).astype(np.int64)


def spd(k, batch=()):
    a = R.randn(*batch, k, k).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + k * np.eye(k)).astype(np.float32)


def _i(P, a):
    return P.to_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# GRAD: the sweep's names on the sweep's probe inputs
# ---------------------------------------------------------------------------
X, Y = sweep.X, sweep.Y

GRAD_UNARY = list(sweep.AUTO_UNARY)
GRAD_BINARY = list(sweep.AUTO_BINARY)

# the sweep's _SPECIAL entries, written once against a module P
_SPECIAL_FN = {
    "acosh": lambda P, t: P.acosh(t),
    "median": lambda P, t: P.median(t),
    "addmm": lambda P, a, b, c: P.addmm(a, b, c),
    "bmm": lambda P, a, b: P.bmm(a, b),
    "matmul": lambda P, a, b: P.matmul(a, b),
    "mm": lambda P, a, b: P.mm(a, b),
    "mv": lambda P, a, b: P.mv(a, b),
    "multi_dot": lambda P, a, b, c: P.multi_dot([a, b, c]),
    "einsum": lambda P, a, b: P.einsum("ij,jk->ik", a, b),
    "matrix_power": lambda P, t: P.matrix_power(t, 2),
    "cholesky": lambda P, t: P.cholesky(t),
    "cholesky_solve": lambda P, a, b: P.cholesky_solve(a, b),
    "triangular_solve": lambda P, a, b: P.triangular_solve(a, b),
    "solve": lambda P, a, b: P.solve(a, b),
    "det": lambda P, t: P.det(t),
    "slogdet": lambda P, t: P.slogdet(t),
    "inv": lambda P, t: P.inv(t),
    "inverse": lambda P, t: P.inverse(t),
    "pinv": lambda P, t: P.pinv(t),
    "qr": lambda P, t: P.qr(t)[1],
    "svd": lambda P, t: P.svd(t)[1],
    "eigh": lambda P, t: P.eigh(t)[0],
    "eigvalsh": lambda P, t: P.eigvalsh(t),
    "cond": lambda P, t: P.cond(t),
    "cumprod": lambda P, t, **kw: P.cumprod(t, **kw),
    "vander": lambda P, t: P.vander(t),
    "polygamma": lambda P, t: P.polygamma(t, 1),
    "ldexp": lambda P, t: P.ldexp(t, P.to_tensor(
        np.full((3, 4), 2, np.int32))),
    "lerp": lambda P, a, b, w: P.lerp(a, b, w),
    "quantile": lambda P, t: P.quantile(t, 0.5, axis=1),
    "nanquantile": lambda P, t: P.nanquantile(t, 0.5, axis=1),
    "kthvalue": lambda P, t: P.kthvalue(t, 2, axis=1)[0],
    "topk": lambda P, t: P.topk(t, 2, axis=1)[0],
    "renorm": lambda P, t, **kw: P.renorm(t, **kw),
    "reshape": lambda P, t: P.reshape(t, [4, 3]),
    "expand": lambda P, t: P.expand(t, [2, 3, 4]),
    "broadcast_to": lambda P, t: P.broadcast_to(t, [2, 3, 4]),
    "expand_as": lambda P, t: P.expand_as(
        t, P.to_tensor(np.zeros((3, 4), np.float32))),
    "tile": lambda P, t: P.tile(t, [2, 1]),
    "repeat_interleave": lambda P, t: P.repeat_interleave(t, 2, axis=0),
    "unsqueeze": lambda P, t: P.unsqueeze(t, 1),
    "unflatten": lambda P, t: P.unflatten(t, 1, [2, 2]),
    "unfold": lambda P, t: P.unfold(t, 1, 2, 1),
    "swapaxes": lambda P, t: P.swapaxes(t, 0, 1),
    "moveaxis": lambda P, t: P.moveaxis(t, 0, 1),
    "flip": lambda P, t: P.flip(t, axis=0),
    "reverse": lambda P, t: P.reverse(t, axis=[0]),
    "roll": lambda P, t: P.roll(t, 1, axis=0),
    "pad": lambda P, t: P.pad(t, [1, 1, 0, 2]),
    "crop": lambda P, t: P.crop(t, shape=[2, 2], offsets=[0, 1]),
    "slice": lambda P, t: P.slice(t, axes=[0, 1], starts=[0, 1], ends=[2, 3]),
    "strided_slice": lambda P, t: P.strided_slice(
        t, axes=[1], starts=[0], ends=[4], strides=[2]),
    "split": lambda P, t: P.split(t, 2, axis=1)[0],
    "chunk": lambda P, t: P.chunk(t, 2, axis=1)[0],
    "tensor_split": lambda P, t: P.tensor_split(t, 2, axis=1)[0],
    "vsplit": lambda P, t: P.vsplit(t, 3)[0],
    "meshgrid": lambda P, a, b: P.meshgrid(a, b)[0],
    "gather": lambda P, t: P.gather(t, _i(P, sweep._idx)),
    "gather_nd": lambda P, t: P.gather_nd(t, _i(P, np.array(
        [[0, 1], [2, 3]], np.int64))),
    "index_select": lambda P, t: P.index_select(t, _i(P, sweep._idx)),
    "index_sample": lambda P, t: P.index_sample(t, _i(P, np.array(
        [[0, 1], [1, 2], [3, 0]], np.int64))),
    "index_add": lambda P, t, s: P.index_add(t, _i(P, sweep._idx), 0, s),
    "index_fill": lambda P, t: P.index_fill(
        t, _i(P, np.array([1], np.int64)), 0, 0.5),
    "index_put": lambda P, t, s: P.index_put(
        t, [_i(P, np.array([0, 2], np.int64))], s),
    "masked_fill": lambda P, t: P.masked_fill(t, _i(P, sweep._mask), 0.5),
    "masked_select": lambda P, t: P.masked_select(t, _i(P, sweep._mask)),
    "take": lambda P, t: P.take(t, _i(P, np.array([0, 5, 11], np.int64))),
    "take_along_axis": lambda P, t: P.take_along_axis(
        t, _i(P, np.array([[0, 1, 2, 0]], np.int64)), 0),
    "put_along_axis": lambda P, t, s: P.put_along_axis(
        t, _i(P, np.array([[0, 1, 2, 0]], np.int64)), s, 0),
    "scatter": lambda P, t, s: P.scatter(
        t, _i(P, np.array([0, 2], np.int64)), s),
    "scatter_nd": lambda P, s: P.scatter_nd(
        _i(P, np.array([[1], [3]], np.int64)), s, [5, 4]),
    "scatter_nd_add": lambda P, t, s: P.scatter_nd_add(
        t, _i(P, np.array([[0], [2]], np.int64)), s),
    "where": lambda P, a, b: P.where(_i(P, sweep._mask), a, b),
    "multiplex": lambda P, a, b: P.multiplex(
        [a, b], _i(P, np.array([0, 1, 0], np.int32))),
}
assert set(_SPECIAL_FN) == set(sweep._SPECIAL), \
    set(_SPECIAL_FN) ^ set(sweep._SPECIAL)


def grad_case(name):
    """(fn(P, *args, **kwargs), args, kwargs) of a GRAD name."""
    if name in sweep._SPECIAL:
        _, args, kwargs = sweep._SPECIAL[name]
        return _SPECIAL_FN[name], [np.copy(a) if isinstance(a, np.ndarray)
                                   else a for a in args], kwargs
    if name in GRAD_UNARY:
        return (lambda P, t: getattr(P, name)(t)), [X.copy()], {}
    return (lambda P, a, b: getattr(P, name)(a, b)), [X.copy(), Y.copy()], {}


GRAD = sorted(set(GRAD_UNARY) | set(GRAD_BINARY) | set(sweep._SPECIAL))
# gradients through factorizations and their inverses
GRAD_TOL = {name: LINALG_TOL for name in (
    "cholesky", "cholesky_solve", "cond", "det", "eigh", "eigvalsh", "inv",
    "inverse", "pinv", "qr", "slogdet", "solve", "svd", "triangular_solve",
    "corrcoef", "cov", "matrix_power")}
GRAD_TOL.update({name: SPECIAL_TOL for name in (
    "digamma", "lgamma", "polygamma", "erfinv", "i0", "i0e", "i1", "i1e")})


# more forward cases of GRAD names: other shapes, broadcasting, negative
# axes (forward only)
def _red(name):
    return [
        (lambda P, t: getattr(P, name)(t, axis=-1, keepdim=True), [n(2, 3, 5)]),
        (lambda P, t: getattr(P, name)(t, axis=[0, 2]), [n(2, 3, 5)]),
    ]


def _bin(name, lo=0.5, hi=1.5):
    return [
        (lambda P, a, b: getattr(P, name)(a, b), [u(2, 3, 4, lo=lo, hi=hi),
                                                u(4, lo=lo, hi=hi)]),
        (lambda P, a, b: getattr(P, name)(a, b), [u(3, 1, lo=lo, hi=hi),
                                                u(1, 4, lo=lo, hi=hi)]),
    ]


FORWARD = {}
for _name in ("sum", "mean", "prod", "max", "min", "amax", "amin", "nansum",
              "nanmean", "logsumexp"):
    FORWARD[_name] = _red(_name)
for _name in ("std", "var"):
    FORWARD[_name] = _red(_name) + [
        (lambda P, t, _n=_name: getattr(P, _n)(t, axis=1, unbiased=False),
         [n(4, 6)])]
for _name in ("add", "subtract", "multiply", "divide", "maximum", "minimum",
              "fmax", "fmin", "atan2", "hypot", "logaddexp", "copysign",
              "pow", "heaviside", "divide_no_nan"):
    FORWARD[_name] = _bin(_name)
for _name in ("mod", "remainder", "floor_mod", "floor_divide"):
    FORWARD[_name] = [
        (lambda P, a, b, _n=_name: getattr(P, _n)(a, b),
         [n(3, 4, scale=5.0), np.array([3.0, -3.0, 2.5, -2.5], np.float32)]),
        (lambda P, a, b, _n=_name: getattr(P, _n)(a, b),
         [np.array([7, -7, 7, -7], np.int64),
          np.array([3, 3, -3, -3], np.int64)])]
for _name in ("exp", "log", "sqrt", "sin", "tanh", "sigmoid", "abs", "round",
              "floor", "ceil", "sign", "square", "reciprocal", "rsqrt"):
    FORWARD[_name] = [(lambda P, t, _n=_name: getattr(P, _n)(t),
                       [u(2, 3, 5, lo=0.05, hi=3.0)])]
for _name in ("round", "floor", "ceil", "trunc", "sign", "abs", "frac"):
    FORWARD[_name] = FORWARD.get(_name, []) + [
        (lambda P, t, _n=_name: getattr(P, _n)(t),
         [np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, -0.2, 3.7], np.float32)])]
FORWARD.update({
    "median": [(lambda P, t: P.median(t), [n(6)]),
               (lambda P, t: P.median(t, axis=-1, keepdim=True), [n(3, 8)]),
               (lambda P, t: P.median(t, axis=0), [n(5, 4)])],
    "quantile": [(lambda P, t: P.quantile(t, q=0.3), [n(4, 20)]),
                 (lambda P, t: P.quantile(t, q=[0.25, 0.75], axis=1),
                  [n(4, 20)]),
                 (lambda P, t: P.quantile(t, q=0.5, axis=0, keepdim=True),
                  [n(4, 20)])],
    "nanquantile": [(lambda P, t: P.nanquantile(t, 0.5),
                     [np.where(R.rand(8) > 0.7, np.nan, n(8)).astype(
                         np.float32)])],
    "cumsum": [(lambda P, t: P.cumsum(t, axis=-1), [n(3, 5)]),
               (lambda P, t: P.cumsum(t), [n(3, 5)])],
    "cumprod": [(lambda P, t: P.cumprod(t, dim=1), [n(3, 5)])],
    "logcumsumexp": [(lambda P, t: P.logcumsumexp(t, axis=1), [n(3, 5)],
                      dict(rtol=1e-5, atol=1e-5))],
    "cummax": [(lambda P, t: P.cummax(t, axis=-1),
                [np.array([[1, 3, 3, 2, 3], [0, 0, -1, 5, 5]], np.float32)])],
    "cummin": [(lambda P, t: P.cummin(t, axis=0),
                [np.array([[3, 1], [1, 1], [2, 0], [0, 0]], np.float32)])],
    "transpose": [(lambda P, t: P.transpose(t, [2, 0, 1]), [n(2, 3, 4)])],
    "concat": [(lambda P, a, b: P.concat([a, b], axis=-1),
                [n(2, 3), n(2, 4)])],
    "stack": [(lambda P, a, b: P.stack([a, b], axis=-1), [n(2, 3), n(2, 3)])],
    "split": [(lambda P, t: P.split(t, [2, -1, 1], axis=-1), [n(3, 7)]),
              (lambda P, t: P.split(t, 3, axis=0), [n(6, 2)])],
    "gather": [(lambda P, t, i: P.gather(t, i, axis=-1),
                [n(3, 5), np.array([4, 0, 2, 2], np.int64)]),
               (lambda P, t, i: P.gather(t, i, axis=0),
                [n(4, 3), np.array([[1, 3], [0, 0]], np.int64)])],
    "pad": [(lambda P, t: P.pad(t, [1, 0, 2, 1, 0, 3]), [n(2, 3, 4)]),
            (lambda P, t: P.pad(t, [1, 2], mode="reflect",
                                data_format="NCL"), [n(1, 2, 5)]),
            (lambda P, t: P.pad(t, [2, 1, 1, 2], mode="replicate"),
             [n(1, 2, 3, 4)]),
            (lambda P, t: P.pad(t, [1, 1, 2, 0], mode="circular",
                                data_format="NHWC"), [n(1, 3, 4, 2)]),
            (lambda P, t: P.pad(t, [1, 2], value=7.0), [n(2, 3)])],
    "squeeze": [(lambda P, t: P.squeeze(t, axis=[-1, 0]), [n(1, 3, 1)]),
                (lambda P, t: P.squeeze(t), [n(1, 3, 1, 2)])],
    "unsqueeze": [(lambda P, t: P.unsqueeze(t, [-1, 0]), [n(2, 3)])],
    "flatten": [(lambda P, t: P.flatten(t, 1, -1), [n(2, 3, 4)])],
    "flip": [(lambda P, t: P.flip(t, axis=[0, -1]), [n(3, 5)])],
    "roll": [(lambda P, t: P.roll(t, shifts=2, axis=-1), [n(3, 5)]),
             (lambda P, t: P.roll(t, 3), [n(3, 5)])],
    "diff": [(lambda P, t: P.diff(t, axis=1), [n(3, 5)]),
             (lambda P, t: P.diff(t, n=2, axis=0, prepend=1.0), [n(4, 3)])],
    "where": [(lambda P, c, a, b: P.where(c, a, b),
               [R.rand(3, 1) > 0.5, n(1, 4), n(3, 4)])],
    "take_along_axis": [(lambda P, t, i: P.take_along_axis(t, i, axis=1),
                         [n(3, 4), np.array([[0, 3], [1, 2], [2, 0]],
                                            np.int64)])],
    "put_along_axis": [
        (lambda P, t, i, v: P.put_along_axis(t, i, v, axis=1),
         [n(3, 4), np.array([[0, 3], [1, 2], [2, 0]], np.int64),
          np.full((3, 2), 9.0, np.float32)]),
        (lambda P, t, i: P.put_along_axis(t, i, 2.0, axis=-1, reduce="add"),
         [n(3, 4), np.array([[0, 3], [1, 2], [2, 0]], np.int64)])],
    "index_add": [(lambda P, t, i, v: P.index_add(t, i, 0, v),
                   [n(4, 3), np.array([1, 3], np.int64),
                    np.ones((2, 3), np.float32)])],
    "topk": [(lambda P, t: P.topk(t, k=3, largest=lg), [n(3, 8)])
             for lg in (True, False)] + [
        (lambda P, t: P.topk(t, k=3, axis=0),
         [np.array([[1, 2], [3, 3], [3, 1], [0, 3]], np.float32)])],
    "sort": [(lambda P, t: P.sort(t, axis=-1, descending=True), [n(4, 6)]),
             (lambda P, t: P.sort(t, axis=0), [n(4, 6)])],
    "kthvalue": [(lambda P, t: P.kthvalue(t, k=3, axis=-1), [n(3, 7)]),
                 (lambda P, t: P.kthvalue(t, k=2, axis=0, keepdim=True),
                  [np.array([[2, 1], [1, 1], [2, 0]], np.float32)])],
    "norm": [(lambda P, t: P.norm(t, p=p, axis=-1), [n(3, 5)])
             for p in (1, 2, 3, float("inf"), float("-inf"), 0)] + [
        (lambda P, t: P.norm(t, p=p, axis=[0, 1]), [n(3, 5)])
        for p in ("fro", 1, 2, float("inf"), "nuc")],
    "einsum": [(lambda P, *ops, _p=pat: P.einsum(_p, *ops), args)
               for pat, args in (("bij,jk->bik", [n(2, 3, 4), n(4, 5)]),
                                 ("ij->ji", [n(3, 4)]),
                                 ("bij->b", [n(2, 3, 4)]),
                                 ("ij,ij->", [n(3, 4), n(3, 4)]))],
    "matmul": [(lambda P, a, b: P.matmul(a, b, transpose_y=True),
                [n(2, 3, 4), n(5, 4)]),
               (lambda P, a, b: P.matmul(a, b, transpose_x=True),
                [n(4, 3), n(4, 2)]),
               (lambda P, a, b: P.matmul(a, b), [n(4), n(4)])],
    "logit": [(lambda P, t: P.logit(t, eps=0.2), [u(8, lo=0.01, hi=0.99)])],
    "clip": [(lambda P, t: P.clip(t, -0.5, 0.5), [n(3, 4)]),
             (lambda P, t: P.clip(t, max=0.2), [n(3, 4)])],
    "scale": [(lambda P, t: P.scale(t, 2.0, 1.0, bias_after_scale=False),
               [n(3, 4)])],
    "nan_to_num": [(lambda P, t: P.nan_to_num(t, nan=1.0, posinf=2.0,
                                              neginf=-2.0),
                    [np.array([np.nan, np.inf, -np.inf, 1.0], np.float32)])],
    "trace": [(lambda P, t: P.trace(t, offset=1), [n(4, 5)])],
    "diagonal": [(lambda P, t: P.diagonal(t, offset=-1, axis1=1, axis2=2),
                  [n(2, 4, 3)])],
    "tril": [(lambda P, t: P.tril(t, -1), [n(4, 5)])],
    "triu": [(lambda P, t: P.triu(t, 1), [n(2, 4, 5)])],
    "diag": [(lambda P, t: P.diag(t, offset=1, padding_value=2.0), [n(3)])],
    "cross": [(lambda P, a, b: P.cross(a, b, axis=-1), [n(4, 3), n(4, 3)])],
    "cdist": [(lambda P, a, b: P.cdist(a, b, p=p), [n(2, 4, 3), n(2, 5, 3)])
              for p in (2.0, 1.0, float("inf"))],
    "tensordot": [(lambda P, a, b: P.tensordot(a, b, axes=[[1], [0]]),
                   [n(3, 4), n(4, 5)])],
    "repeat_interleave": [(lambda P, t: P.repeat_interleave(t, 2), [n(2, 3)])],
    "tensor_split": [(lambda P, t: P.tensor_split(t, 3, axis=-1),
                      [n(2, 7)])],
    "unfold": [(lambda P, t: P.unfold(t, 1, 3, 2), [n(2, 9)])],
    "index_put": [(lambda P, t, i, v: P.index_put(t, [i], v,
                                                   accumulate=True),
                   [n(4, 3), np.array([1, 1, 3], np.int64),
                    np.ones((3, 3), np.float32)])],
    "scatter": [(lambda P, t, i, v: P.scatter(t, i, v, overwrite=False),
                 [n(4, 3), np.array([1, 1, 3], np.int64),
                  np.ones((3, 3), np.float32)])],
    "masked_select": [(lambda P, t, m: P.masked_select(t, m),
                       [n(3, 4), R.rand(3, 4) > 0.5])],
})


# ---------------------------------------------------------------------------
# HELD: forward cases of the other ops
# ---------------------------------------------------------------------------
def _shape_only(P, t):
    return tuple(t.shape), str(t.dtype).split(".")[-1]


HELD = {
    # creation
    "zeros": [(lambda P: P.zeros([2, 3]), []),
              (lambda P: P.zeros([4], dtype="int32"), [])],
    "ones": [(lambda P: P.ones([2, 3], dtype="float32"), []),
             (lambda P: P.ones(3, dtype="bool"), [])],
    "full": [(lambda P: P.full([2, 2], 1.5), []),
             (lambda P: P.full([3], 7, dtype="int64"), []),
             (lambda P: P.full([2], True), [])],
    "empty": [(lambda P: _shape_only(P, P.empty([2, 3])), [])],
    "zeros_like": [(lambda P, t: P.zeros_like(t), [n(2, 3)]),
                   (lambda P, t: P.zeros_like(t, dtype="int32"), [n(3)])],
    "ones_like": [(lambda P, t: P.ones_like(t), [ints(2, 3)])],
    "full_like": [(lambda P, t: P.full_like(t, 2.5), [n(2, 3)])],
    "empty_like": [(lambda P, t: _shape_only(P, P.empty_like(t)), [n(2, 3)])],
    "arange": [(lambda P: P.arange(5), []),
               (lambda P: P.arange(1, 10, 3), []),
               (lambda P: P.arange(0.0, 1.0, 0.25), [])],
    "linspace": [(lambda P: P.linspace(0, 1, 5), []),
                 (lambda P: P.linspace(-2.0, 3.0, 7, dtype="float32"), [])],
    "logspace": [(lambda P: P.logspace(0, 2, 3), []),
                 (lambda P: P.logspace(0, 3, 4, base=2.0), [])],
    "eye": [(lambda P: P.eye(3), []), (lambda P: P.eye(2, 4), [])],
    "to_tensor": [(lambda P: P.to_tensor([[1.0, 2.0], [3.0, 4.0]]), []),
                  (lambda P: P.to_tensor([1, 2, 3]), []),
                  (lambda P: P.to_tensor(True), []),
                  (lambda P: P.to_tensor(np.arange(4, dtype=np.int32)), [])],
    "tril_indices": [(lambda P: P.tril_indices(4, 3, 0), []),
                     (lambda P: P.tril_indices(4, 4, -1), [])],
    "triu_indices": [(lambda P: P.triu_indices(4, 3, 1), []),
                     (lambda P: P.triu_indices(3), [])],
    "one_hot": [(lambda P, t: P.one_hot(t, 6), [ints(5)]),
                (lambda P, t: P.one_hot(t, 4), [ints(2, 3, hi=4)])],
    "complex": [(lambda P, a, b: P.complex(a, b), [n(3), n(3)]),
                (lambda P, a, b: P.complex(a, b), [n(2, 3), n(2, 3)])],
    "polar": [(lambda P, a, b: P.polar(a, b), [u(4, lo=0.5, hi=2.0), n(4)])],
    "create_tensor": [(lambda P: P.create_tensor("float32"), [])],
    # math without a gradient
    "all": [(lambda P, t: P.all(t), [R.rand(3, 4) > 0.1]),
            (lambda P, t: P.all(t, axis=-1, keepdim=True), [R.rand(3, 4) > .3]),
            (lambda P, t: P.all(t, axis=[0, 1]), [R.rand(2, 3, 4) > .2])],
    "any": [(lambda P, t: P.any(t), [R.rand(3, 4) > 0.9]),
            (lambda P, t: P.any(t, axis=-1), [R.rand(3, 4) > 0.8]),
            (lambda P, t: P.any(t, axis=0, keepdim=True), [n(3, 4)])],
    "count_nonzero": [(lambda P, t: P.count_nonzero(t), [ints(3, 4, hi=3)]),
                      (lambda P, t: P.count_nonzero(t, axis=-1, keepdim=True),
                       [ints(3, 4, hi=3)])],
    "frexp": [(lambda P, t: P.frexp(t),
               [np.array([0.0, 1.0, -3.5, 1024.0, 0.1, 7e-3], np.float32)]),
              (lambda P, t: P.frexp(t), [n(3, 4, scale=50.0)])],
    "gcd": [(lambda P, a, b: P.gcd(a, b), [ints(3, 4, hi=60), ints(4, hi=40)])],
    "lcm": [(lambda P, a, b: P.lcm(a, b), [ints(3, 4, lo=1, hi=20),
                                          ints(3, 1, lo=1, hi=20)])],
    "nextafter": [(lambda P, a, b: P.nextafter(a, b), [n(3, 4), n(4)])],
    "nanmedian": [(lambda P, t: P.nanmedian(t),
                   [np.array([1, np.nan, 3, 2, 8, np.nan], np.float32)]),
                  (lambda P, t: P.nanmedian(t, axis=-1, keepdim=True),
                   [np.where(R.rand(3, 6) > 0.7, np.nan, n(3, 6)).astype(
                       np.float32)])],
    # manipulation without a gradient check of its own
    "as_complex": [(lambda P, t: P.as_complex(t), [n(3, 2)]),
                   (lambda P, t: P.as_complex(t), [n(2, 4, 2)])],
    "broadcast_shape": [(lambda P: P.broadcast_shape([2, 1, 3], [4, 1]),
                         [])],
    "broadcast_tensors": [(lambda P, a, b: P.broadcast_tensors([a, b]),
                           [n(3, 1), n(1, 4)])],
    "cast": [(lambda P, t: P.cast(t, "int32"), [n(3, 4, scale=5.0)]),
             (lambda P, t: P.cast(t, "bool"), [ints(5, hi=2)]),
             (lambda P, t: P.cast(t, "float16"), [n(4)])],
    "numel": [(lambda P, t: P.numel(t), [n(3, 4)])],
    "rank": [(lambda P, t: P.rank(t), [n(2, 3, 4)])],
    "shape": [(lambda P, t: P.shape(t), [n(2, 3, 4)])],
    "shard_index": [(lambda P, t: P.shard_index(t, 20, 2, 1),
                     [ints(6, hi=20)]),
                    (lambda P, t: P.shard_index(t, 20, 4, 0, -2),
                     [ints(2, 3, hi=20)])],
    "unbind": [(lambda P, t: P.unbind(t, axis=-1), [n(2, 3)])],
    "unstack": [(lambda P, t: P.unstack(t, axis=1), [n(2, 3, 4)])],
    "view": [(lambda P, t: P.view(t, [4, 3]), [n(3, 4)]),
             (lambda P, t: P.view(t, "int32"), [n(3, 4)])],
    "view_as": [(lambda P, t, o: P.view_as(t, o), [n(3, 4), n(2, 6)])],
    # logic
    **{name: [(lambda P, a, b, _n=name: getattr(P, _n)(a, b),
               [ints(3, 4, hi=3).astype(np.float32),
                ints(4, hi=3).astype(np.float32)]),
              (lambda P, a, _n=name: getattr(P, _n)(a, 1.0),
               [ints(2, 3, hi=3).astype(np.float32)])]
       for name in ("equal", "not_equal", "greater_than", "greater_equal",
                    "less_than", "less_equal")},
    **{name: [(lambda P, a, b, _n=name: getattr(P, _n)(a, b),
               [R.rand(3, 4) > 0.5, R.rand(4) > 0.5])]
       for name in ("logical_and", "logical_or", "logical_xor")},
    "logical_not": [(lambda P, t: P.logical_not(t), [R.rand(3, 4) > 0.5])],
    **{name: [(lambda P, a, b, _n=name: getattr(P, _n)(a, b),
               [ints(3, 4, hi=16), ints(4, hi=16)]),
              (lambda P, a, b, _n=name: getattr(P, _n)(a, b),
               [R.rand(5) > 0.5, R.rand(5) > 0.5])]
       for name in ("bitwise_and", "bitwise_or", "bitwise_xor")},
    "bitwise_not": [(lambda P, t: P.bitwise_not(t), [ints(3, 4, hi=16)]),
                    (lambda P, t: P.bitwise_not(t), [R.rand(5) > 0.5])],
    **{name: [(lambda P, t, _n=name: getattr(P, _n)(t),
               [np.array([[1.0, np.nan, np.inf], [-np.inf, 0.0, -2.0]],
                         np.float32)])]
       for name in ("isnan", "isinf", "isfinite")},
    "equal_all": [(lambda P, a, b: P.equal_all(a, b), [ints(3), ints(3)]),
                  (lambda P, a: P.equal_all(a, a), [n(2, 3)])],
    "allclose": [(lambda P, a, b: P.allclose(a, b), [X, X + 1e-7]),
                 (lambda P, a, b: P.allclose(a, b, rtol=1e-3), [X, Y])],
    "isclose": [(lambda P, a, b: P.isclose(a, b, atol=0.3), [X, Y]),
                (lambda P, a, b: P.isclose(a, b, equal_nan=True),
                 [np.array([np.nan, 1.0], np.float32),
                  np.array([np.nan, 1.0 + 1e-7], np.float32)])],
    "is_empty": [(lambda P, t: P.is_empty(t), [n(0, 3)]),
                 (lambda P, t: P.is_empty(t), [n(2)])],
    "isin": [(lambda P, a, b: P.isin(a, b), [ints(3, 4, hi=10),
                                            ints(5, hi=10)]),
             (lambda P, a, b: P.isin(a, b, invert=True), [ints(6, hi=5),
                                                         ints(2, hi=5)])],
    "is_complex": [(lambda P, t: P.is_complex(t), [n(2)])],
    "is_floating_point": [(lambda P, t: P.is_floating_point(t), [n(2)]),
                          (lambda P, t: P.is_floating_point(t), [ints(2)])],
    "is_integer": [(lambda P, t: P.is_integer(t), [ints(2)]),
                   (lambda P, t: P.is_integer(t), [R.rand(2) > 0.5])],
    # search
    "argmax": [(lambda P, t: P.argmax(t), [n(3, 5)]),
               (lambda P, t: P.argmax(t, axis=-1, keepdim=True), [n(3, 5)]),
               (lambda P, t: P.argmax(t, axis=0),
                [np.array([[1, 3], [3, 3], [0, 1]], np.float32)])],
    "argmin": [(lambda P, t: P.argmin(t), [n(3, 5)]),
               (lambda P, t: P.argmin(t, axis=-1),
                [np.array([[1, 0, 0], [2, 2, 2]], np.float32)])],
    "argsort": [(lambda P, t: P.argsort(t, axis=-1, descending=True),
                 [n(4, 6)]),
                (lambda P, t: P.argsort(t, axis=0),
                 [np.array([[2, 1], [1, 1], [2, 0], [1, 1]], np.float32)]),
                (lambda P, t: P.argsort(t, descending=True),
                 [np.array([3, 1, 3, 2, 1, 3], np.float32)])],
    "bucketize": [(lambda P, t, s: P.bucketize(t, s),
                   [np.array([0.5, 3.0, 6.2, 7.0], np.float32),
                    np.array([1.0, 3.0, 5.0, 7.0], np.float32)]),
                  (lambda P, t, s: P.bucketize(t, s, right=True),
                   [np.array([[0.5, 3.0], [6.2, 7.0]], np.float32),
                    np.array([1.0, 3.0, 5.0, 7.0], np.float32)])],
    "mode": [(lambda P, t: P.mode(t, axis=-1),
              [np.array([[1, 2, 2, 3], [3, 3, 1, 1]], np.float32)]),
             (lambda P, t: P.mode(t, axis=0, keepdim=True),
              [ints(7, 3, hi=3).astype(np.float32)])],
    "nonzero": [(lambda P, t: P.nonzero(t), [ints(3, 4, hi=2)]),
                (lambda P, t: P.nonzero(t, as_tuple=True), [ints(5, hi=2)])],
    "searchsorted": [(lambda P, s, v: P.searchsorted(s, v, right=r),
                      [np.array([1.0, 2.0, 2.0, 3.0, 5.0], np.float32),
                       np.array([0.5, 2.0, 2.5, 5.0, 6.0], np.float32)])
                     for r in (False, True)],
    "unique": [(lambda P, t: P.unique(t), [ints(8)]),
               (lambda P, t: P.unique(t, return_index=True,
                                      return_inverse=True,
                                      return_counts=True),
                [np.array([3, 1, 2, 3, 1, 1], np.int64)]),
               (lambda P, t: P.unique(t, return_counts=True),
                [ints(3, 4, hi=4)])],
    "unique_consecutive": [
        (lambda P, t: P.unique_consecutive(t),
         [np.array([1, 1, 2, 2, 3, 1, 1, 2], np.int64)]),
        (lambda P, t: P.unique_consecutive(t, return_inverse=True,
                                           return_counts=True),
         [np.array([1, 1, 2, 2, 3, 1, 1, 2], np.int64)])],
    # linalg without a gradient check of its own
    "bincount": [(lambda P, t: P.bincount(t), [ints(10)]),
                 (lambda P, t, w: P.bincount(t, weights=w, minlength=8),
                  [ints(10), n(10)])],
    "histogram": [(lambda P, t: P.histogram(t, bins=5), [n(50)]),
                  (lambda P, t: P.histogram(t, bins=4, min=-1, max=1),
                   [n(40)])],
    "matrix_rank": [(lambda P, t: P.matrix_rank(t), [n(4, 4)]),
                    (lambda P, t: P.matrix_rank(t),
                     [(n(5, 2) @ n(2, 4)).astype(np.float32)])],
    "lu": [(lambda P, t: P.lu(t), [n(4, 4)], LINALG_TOL),
           (lambda P, t: P.lu(t, get_infos=True), [n(3, 3)], LINALG_TOL)],
    "lu_unpack": [(lambda P, t: P.lu_unpack(*P.lu(t)), [n(4, 4)],
                   LINALG_TOL)],
    "householder_product": [
        (lambda P, a, t: P.householder_product(a, t), [n(5, 3), n(3)],
         LINALG_TOL)],
}
HELD.update({
    "as_strided": [(lambda P, t: _raises(NotImplementedError, P.as_strided,
                                         t, [2, 2], [1, 1]), [n(4)])],
    "reshape_": [(lambda P, t: _inplace_shape(P.reshape_, t, [4, 3]),
                  [n(3, 4)]),
                 (lambda P, t: _inplace_shape(P.reshape_, t, [-1]),
                  [n(2, 3)])],
    "index_fill_": [(lambda P, t: _inplace_value(
        P.index_fill_, t, _i(P, np.array([2], np.int64)), 0, 5.0),
        [np.zeros((3, 3), np.float32)])],
})


def _raises(exc, fn, *args):
    try:
        fn(*args)
    except exc:
        return True
    return False


def _inplace_shape(fn, t, shape):
    """An in-place op returns its argument, now of the new shape."""
    out = fn(t, shape)
    return out is t, list(t.shape), t


def _inplace_value(fn, t, *args):
    out = fn(t, *args)
    return out is t, t


# linalg whose results hold only up to signs, phases or order, and lstsq:
# checked by reconstruction and invariants in test_torch_tensor_linalg.py
RECONSTRUCTED = ("eig", "eigvals", "lstsq")

RANDOM = ("rand", "randn", "randint", "randint_like", "randperm", "uniform",
          "normal", "standard_normal", "poisson", "bernoulli", "multinomial",
          "exponential_", "rand_like", "randn_like", "normal_like",
          "uniform_", "pca_lowrank")

# names of the JAX package the port leaves out, with the reason (ROADMAP's
# long-tail item, A14d, lists the same)
LEFT = {
    "core.random:trace_key_scope":
        "a traced key for paddle_tpu.jit: the port's jit.to_static hands "
        "its program a seed a call instead (core.random.push_trace_seed)",
    "core.autograd:GradNode":
        "the JAX eager tape's node: torch's autograd is the port's tape",
    "core.autograd:apply_op":
        "the JAX eager tape's op recorder: torch's autograd is the tape",
    "core.autograd:run_backward":
        "the JAX eager tape's traversal: torch.autograd.backward is the port's",
}


# ---------------------------------------------------------------------------
# running a case on both packages
# ---------------------------------------------------------------------------
def to_np(x):
    """An output of either package as numpy (nested lists for sequences)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy(force=True)
    if isinstance(x, paddle_tpu.Tensor):
        return np.asarray(x.value)
    if isinstance(x, (list, tuple)):
        return [to_np(v) for v in x]
    return np.asarray(x)


def run(P, fn, args, kwargs=None):
    ts = [P.to_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    return fn(P, *ts, **(kwargs or {}))


def _kind(a):
    return "f" if a.dtype.kind == "f" else a.dtype.kind.replace("u", "i")


def assert_same(got, want, tol=None, what=""):
    """got (the port's) against want (the JAX package's)."""
    got, want = to_np(got), to_np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, tol, f"{what}[{i}]")
        return
    assert not isinstance(got, list), what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert _kind(got) == _kind(want), (what, got.dtype, want.dtype)
    if _kind(want) in "fc":
        np.testing.assert_allclose(got, want, equal_nan=True,
                                   err_msg=what, **(tol or TOL))
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def check_forward(case, what=""):
    fn, args, *tol = case
    want = run(paddle_tpu, fn, args)
    got = run(paddle_tpu_torch, fn, args)
    assert_same(got, want, tol[0] if tol else None, what)
    return got


def check_grad(name):
    """The forward and the gradient of sum(out * w) with respect to every
    float input, through each package's ``grad``, on the sweep's probe
    inputs. An input a package's graph leaves unused counts as a zero
    gradient (the port's grad returns None there, the JAX tape zeros)."""
    fn, args, kwargs = grad_case(name)
    res = {}
    for P in (paddle_tpu, paddle_tpu_torch):
        ts, leaves = [], []
        for a in args:
            if isinstance(a, np.ndarray) and a.dtype.kind == "f":
                ts.append(P.to_tensor(a, stop_gradient=False))
                leaves.append(ts[-1])
            else:
                ts.append(P.to_tensor(a) if isinstance(a, np.ndarray) else a)
        out = fn(P, *ts, **kwargs)
        if isinstance(out, (tuple, list)):
            out = out[0]
        w = np.asarray(np.random.RandomState(0).randn(*to_np(out).shape),
                       np.float32)
        loss = P.sum(out * P.to_tensor(w))
        if P is paddle_tpu_torch and not loss.requires_grad:
            grads = [None] * len(leaves)
        else:
            grads = P.grad(loss, leaves, allow_unused=True)
        res[P] = out, [np.zeros_like(a) if g is None else to_np(g)
                       for a, g in zip([a for a in args
                                        if isinstance(a, np.ndarray)
                                        and a.dtype.kind == "f"], grads)]
    tol = GRAD_TOL.get(name, TOL)
    assert_same(res[paddle_tpu_torch][0], res[paddle_tpu][0], tol,
                f"{name} forward")
    assert_same(res[paddle_tpu_torch][1], res[paddle_tpu][1], tol,
                f"{name} grad")


def _module_of():
    from paddle_tpu_torch.ops import (creation, linalg, logic,
                                      manipulation, math, random, search)
    return {name: mod.__name__.rsplit(".", 1)[1]
            for mod in (creation, math, manipulation, logic, search, random,
                        linalg) for name in mod.__all__}


MODULE_OF = _module_of()


def cases_of(*modules):
    """The GRAD names, the HELD cases and the FORWARD cases of the ops of
    ``modules`` (ops module names), for parametrize."""
    grads = [n for n in GRAD if MODULE_OF[n] in modules]
    held = [(n, i) for n in sorted(HELD) if MODULE_OF[n] in modules
            for i in range(len(HELD[n]))]
    fwd = [(n, i) for n in sorted(FORWARD) if MODULE_OF[n] in modules
           for i in range(len(FORWARD[n]))]
    return grads, held, fwd
