"""paddle_tpu_torch's manipulation, logic and search ops against
paddle_tpu's, on the CPU, and the conventions where implementations diverge.

- Every op of the gradient sweep among them: its forward and its gradient
  through each package's ``grad`` on the sweep's probe inputs; the others by
  their forward; more forward cases at other shapes (broadcasting, negative
  axes, ties in sort, top-k, k-th value and mode).
- Every convention case of ``tests/test_tensor_ops_vs_torch.py``, held
  against the JAX package instead of torch, and the cases where a torch
  function of the same name means something else: ``gather`` (an
  ``index_select``), ``split`` with a -1 section, ``pad`` with a pad for
  every dim (the first dim first), the mean of the middle two for an even
  ``median``, ``mod`` and ``floor_divide`` by negative divisors.
- Index outputs (``argmax``, ``argsort``, ``topk``, ``nonzero``) are
  ``int64`` in the port.

fp32 throughout: rtol 1e-5, atol 1e-6; special functions rtol 1e-4, atol
1e-5 (``tests/torch_surface_cases.py``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
import torch_surface_cases as cases
from paddle_tpu_torch.core import place
from torch_surface_cases import SPECIAL_TOL, n

GRADS, HELD, FORWARD = cases.cases_of("manipulation", "logic", "search")


@pytest.fixture(autouse=True, scope="module")
def cpu_place_one_thread():
    """The CPU as the current place and one intra-op thread, both
    restored."""
    threads, prev = torch.get_num_threads(), place._current[0]
    torch.set_num_threads(1)
    place.set_device("cpu")
    yield
    place._current[0] = prev
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", GRADS)
def test_grad(name):
    cases.check_grad(name)


@pytest.mark.parametrize("name,i", HELD)
def test_forward(name, i):
    cases.check_forward(cases.HELD[name][i], f"{name}[{i}]")


@pytest.mark.parametrize("name,i", FORWARD)
def test_forward_more_shapes(name, i):
    cases.check_forward(cases.FORWARD[name][i], f"{name}[{i}]")


def _setitem(P, t):
    t[1:3, ::2] = 7.0
    return t


def _setitem_mask(P, t, m):
    t[m] = 0.0
    return t


# tests/test_tensor_ops_vs_torch.py's cases, and the same-name traps
_x48 = n(4, 5, 6)
CONVENTIONS = {
    "topk_values_and_indices": [
        (lambda P, t: P.topk(t, k=3, largest=lg), [n(3, 8)])
        for lg in (True, False)],
    "sort_descending_with_indices": [
        (lambda P, t: (P.sort(t, axis=-1, descending=True),
                       P.argsort(t, axis=-1, descending=True)), [n(4, 6)])],
    "kthvalue_and_mode": [
        (lambda P, t: P.kthvalue(t, k=3, axis=-1), [n(3, 7)]),
        (lambda P, t: P.mode(t, axis=-1),
         [np.array([[1, 2, 2, 3], [3, 3, 1, 2]], np.float32)])],
    "quantile_linear_and_axis": [
        (lambda P, t: (P.quantile(t, q=0.3),
                       P.quantile(t, q=[0.25, 0.75], axis=1),
                       P.quantile(t, q=0.5, axis=0, keepdim=True)),
         [n(4, 20)])],
    "median_even_count": [(lambda P, t: P.median(t), [n(6)])],
    "cumsum_cumprod_logcumsumexp": [
        (lambda P, t: (P.cumsum(t, axis=1), P.cumprod(t, dim=1),
                       P.logcumsumexp(t, axis=1)), [n(3, 5)],
         dict(rtol=1e-5, atol=1e-5))],
    "nanmean_nansum_nanquantile": [
        (lambda P, t: (P.nanmean(t), P.nansum(t), P.nanquantile(t, 0.5)),
         [np.where(np.arange(8) == 2, np.nan, n(8)).astype(np.float32)])],
    "searchsorted_sides": [
        (lambda P, s, q: P.searchsorted(s, q, right=r),
         [np.array([1.0, 2.0, 2.0, 3.0, 5.0], np.float32),
          np.array([0.5, 2.0, 2.5, 5.0, 6.0], np.float32)])
        for r in (False, True)],
    "unique_with_inverse_and_counts": [
        (lambda P, t: P.unique(t, return_inverse=True, return_counts=True),
         [np.array([3, 1, 2, 3, 1, 1], np.int64)])],
    "take_along_axis_put_along_axis": [
        (lambda P, t, i, v: (P.take_along_axis(t, i, axis=1),
                             P.put_along_axis(t, i, v, axis=1)),
         [n(3, 4), np.array([[0, 3], [1, 2], [2, 0]], np.int64),
          np.full((3, 2), 9.0, np.float32)])],
    "index_add_index_put": [
        (lambda P, t, i, v: P.index_add(t, i, 0, v),
         [n(4, 3), np.array([1, 3], np.int64), np.ones((2, 3), np.float32)])],
    "roll_flip_diff": [
        (lambda P, t: (P.roll(t, shifts=2, axis=1), P.flip(t, axis=[0, 1]),
                       P.diff(t, axis=1)), [n(3, 5)])],
    "erf_family": [
        (lambda P, t: P.erf(t), [n(64) * 2]),
        (lambda P, t: P.erfinv(t), [cases.u(32, lo=-0.9, hi=0.9)],
         SPECIAL_TOL)],
    "gamma_family": [
        (lambda P, t: (P.lgamma(t), P.digamma(t), P.polygamma(t, 1)),
         [cases.u(32, lo=0.2, hi=4.2)], SPECIAL_TOL)],
    "bessel_i0_i1": [
        (lambda P, t: (P.i0(t), P.i1(t), P.i0e(t)),
         [cases.u(32, lo=0.0, hi=3.0)], SPECIAL_TOL)],
    "logit": [(lambda P, t: P.logit(t), [cases.u(32, lo=0.05, hi=0.95)],
               SPECIAL_TOL)],
    "einsum_patterns": cases.FORWARD["einsum"],
    "setitem_slices_and_masks": [
        (_setitem, [n(4, 5)]),
        (_setitem_mask, [n(4, 5), n(4, 5) > 0.5])],
    "getitem_forms": [
        (lambda P, t: (t[::2, -1], t[..., 2], t[None, 1]), [_x48]),
        (lambda P, t, i: t[i], [_x48, np.array([2, 0, 3], np.int64)])],
    "broadcast_binary_ops": [
        (lambda P, a, b: (a + b, a * b, P.maximum(a, b)),
         [n(4, 1, 5), n(3, 1)])],
    # the same-name traps
    "gather_is_index_select": [
        (lambda P, t, i: P.gather(t, i, axis=1),
         [n(3, 5), np.array([4, 1, 1], np.int64)])],
    "split_with_minus_one": [
        (lambda P, t: P.split(t, [1, -1, 2], axis=-1), [n(2, 8)])],
    "pad_every_dim_first_dim_first": [
        (lambda P, t: P.pad(t, [1, 2, 0, 1]), [n(2, 3)]),
        (lambda P, t: P.pad(t, [0, 1, 2, 0, 1, 1]), [n(2, 3, 2)])],
    "median_even_mean_of_middle_two": [
        (lambda P, t: P.median(t, axis=1),
         [np.array([[4, 1, 3, 2], [0, 9, 9, 1]], np.float32)])],
    "mod_follows_the_divisor": [
        (lambda P, a, b: (P.mod(a, b), P.remainder(a, b),
                          P.floor_divide(a, b)),
         [np.array([7, -7, 7, -7, 0], np.float32),
          np.array([3, 3, -3, -3, -2], np.float32)])],
}


@pytest.mark.parametrize("name,i", [(k, i) for k, v in CONVENTIONS.items()
                                    for i in range(len(v))])
def test_convention(name, i):
    cases.check_forward(CONVENTIONS[name][i], f"{name}[{i}]")


@pytest.mark.parametrize("op", ["argmax", "argmin", "argsort", "topk",
                                "nonzero", "kthvalue", "mode", "cummax",
                                "searchsorted", "unique"])
def test_index_outputs_are_int64(op):
    x = paddle_tpu_torch.to_tensor(n(3, 6))
    out = {"argmax": lambda: paddle_tpu_torch.argmax(x, axis=1),
           "argmin": lambda: paddle_tpu_torch.argmin(x),
           "argsort": lambda: paddle_tpu_torch.argsort(x),
           "topk": lambda: paddle_tpu_torch.topk(x, 2)[1],
           "nonzero": lambda: paddle_tpu_torch.nonzero(x > 0),
           "kthvalue": lambda: paddle_tpu_torch.kthvalue(x, 2)[1],
           "mode": lambda: paddle_tpu_torch.mode(x)[1],
           "cummax": lambda: paddle_tpu_torch.cummax(x, axis=1)[1],
           "searchsorted": lambda: paddle_tpu_torch.searchsorted(
               paddle_tpu_torch.sort(x[0]), x[1]),
           "unique": lambda: paddle_tpu_torch.unique(
               x, return_inverse=True)[1]}[op]()
    assert out.dtype == torch.int64
    # the JAX package narrows int64 to int32 (x64 off)
    assert paddle_tpu.int64 == np.int32
