"""paddle_tpu_torch's convolutions, pooling and sequence losses against
paddle_tpu's, on the CPU: every function of the reference's
``nn/functional/conv.py``, ``pooling.py`` and ``sequence_loss.py`` and
``loss.py``'s ``ctc_loss`` (a name without a case fails), and every layer
of ``nn/layer/conv.py``, ``pooling.py`` and the four loss layers over
them, on the same seeded numpy inputs: the output and the gradients of
``sum(out * ct)`` for every floating input (and, for a layer, every
parameter, the JAX layer's ``state_dict`` carried across), in fp32 and
again in bf16.

The cases cover the edges of the reference's arithmetic: channel-last
formats, groups and depthwise convolutions, dilation, padding as an int,
a list of ``nd`` and of ``2 nd`` values, ``"SAME"`` with stride 2 and
``"VALID"``; ``ceil_mode``, ``exclusive`` both ways and
``divisor_override``; adaptive pooling at sizes that do and do not
divide; ``max_unpool`` from a pooling mask; the transposes'
``output_padding`` and ``"SAME"``; RNN-T with and without FastEmit; CTC
over ragged lengths. The max-pool masks are held equal, on inputs without
ties and on ties (both take a window's first maximum in row-major order).

Tolerances (``tests/torch_nn_cases.py``): fp32 rtol 1e-5 / atol 1e-6,
except the cases of ``TOLS`` (rtol 1e-5 / atol 1e-5: the recursions of
``rnnt_loss`` and ``ctc_loss`` add terms of order 10 in log space, and the
convolutions' weight gradients sum a few hundred products of order 1,
where both sides round partial sums in other orders); bf16 atol 2^-6 of
the compared array's largest magnitude, except the cases of ``BF16_TOPS``:
``conv1d_transpose`` 2^-5 (the reference's bf16 gradient of the bias, a
sum of 20 cotangent elements, lands 2.5 bf16 steps from the exactly
rounded sum, which the port returns) and ``ctc_loss`` 2^-4 (both run the
recursion in bf16 over T steps, the reference rounding the max, the exp
and the log1p of each ``logaddexp`` to bf16, torch once).
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
import torch_nn_cases as C
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)


def _ints(*v):
    return np.asarray(v, np.int64)


def _unpool_inputs(shape, k, seed):
    """(values, flat indices) of a tie-free max pool with kernel = stride
    ``k`` over a random input of ``shape`` [N, C, *sp]: the indices are
    the reference's mask, computed here in numpy."""
    rng = np.random.RandomState(seed)
    nd = len(shape) - 2
    sp = shape[2:]
    x = rng.randn(*shape).astype(np.float32)
    out_sp = tuple(s // k for s in sp)
    flat = np.arange(int(np.prod(sp))).reshape(sp)
    vals = np.zeros(shape[:2] + out_sp, np.float32)
    idx = np.zeros(shape[:2] + out_sp, np.int64)
    for pos in np.ndindex(*out_sp):
        sl = tuple(slice(p * k, p * k + k) for p in pos)
        win = x[(slice(None), slice(None)) + sl].reshape(shape[:2] + (-1,))
        f = flat[sl].reshape(-1)
        a = win.argmax(-1)
        vals[(slice(None), slice(None)) + pos] = win.max(-1)
        idx[(slice(None), slice(None)) + pos] = f[a]
    assert nd in (1, 2, 3)
    return vals, idx


_U1 = _unpool_inputs((2, 3, 8), 2, 1)
_U2 = _unpool_inputs((1, 2, 6, 6), 2, 2)
_U3 = _unpool_inputs((1, 2, 4, 4, 4), 2, 3)
_COS = np.random.RandomState(5).uniform(-0.9, 0.9, (4, 6)).astype(np.float32)

# case id -> (reference function name, call(F, *tensors), input specs)
CASES = {
    "conv1d": ("conv1d", lambda F, x, w, b: F.conv1d(x, w, b, 2, 1),
               [(2, 3, 9), (4, 3, 3), (4,)]),
    "conv1d_nlc": ("conv1d", lambda F, x, w: F.conv1d(
        x, w, padding=[1, 2], data_format="NLC"), [(2, 9, 3), (4, 3, 3)]),
    "conv2d": ("conv2d", lambda F, x, w, b: F.conv2d(
        x, w, b, 1, [1, 2], 2, 2), [(2, 4, 7, 8), (6, 2, 3, 3), (6,)]),
    "conv2d_same_stride2": ("conv2d", lambda F, x, w: F.conv2d(
        x, w, stride=2, padding="SAME"), [(1, 3, 9, 8), (4, 3, 3, 3)]),
    "conv2d_valid": ("conv2d", lambda F, x, w: F.conv2d(
        x, w, stride=[2, 1], padding="VALID"), [(1, 3, 8, 7), (4, 3, 2, 3)]),
    "conv2d_nhwc_pairs": ("conv2d", lambda F, x, w, b: F.conv2d(
        x, w, b, padding=[0, 1, 1, 2], data_format="NHWC"),
        [(1, 6, 7, 3), (4, 3, 3, 3), (4,)]),
    "conv2d_depthwise": ("conv2d", lambda F, x, w: F.conv2d(
        x, w, stride=2, padding=1, groups=4), [(1, 4, 7, 7), (4, 1, 3, 3)]),
    "conv3d": ("conv3d", lambda F, x, w, b: F.conv3d(
        x, w, b, (1, 2, 2), 1), [(1, 2, 4, 5, 5), (3, 2, 2, 3, 3), (3,)]),
    "conv3d_ndhwc_same": ("conv3d", lambda F, x, w: F.conv3d(
        x, w, stride=2, padding="SAME", data_format="NDHWC"),
        [(1, 5, 4, 5, 2), (3, 2, 3, 2, 3)]),
    "conv1d_transpose": ("conv1d_transpose", lambda F, x, w, b:
                         F.conv1d_transpose(x, w, b, 2, 1, 1),
                         [(2, 4, 5), (4, 3, 3), (3,)]),
    "conv2d_transpose": ("conv2d_transpose", lambda F, x, w, b:
                         F.conv2d_transpose(x, w, b, 2, [1, 0], 1, 2),
                         [(1, 4, 4, 5), (4, 2, 3, 3), (4,)]),
    "conv2d_transpose_same_dilated": (
        "conv2d_transpose", lambda F, x, w: F.conv2d_transpose(
            x, w, stride=2, padding="SAME", dilation=2),
        [(1, 3, 4, 4), (3, 2, 3, 3)]),
    "conv2d_transpose_nhwc": ("conv2d_transpose", lambda F, x, w:
                              F.conv2d_transpose(x, w, stride=2, padding=1,
                                                 data_format="NHWC"),
                              [(1, 4, 5, 3), (3, 2, 3, 3)]),
    "conv3d_transpose": ("conv3d_transpose", lambda F, x, w, b:
                         F.conv3d_transpose(x, w, b, 2, 1, 1),
                         [(1, 2, 3, 3, 3), (2, 3, 3, 3, 3), (3,)]),
    "avg_pool1d": ("avg_pool1d", lambda F, x: F.avg_pool1d(x, 3, 2, 1),
                   [(2, 3, 9)]),
    "avg_pool1d_ceil": ("avg_pool1d", lambda F, x: F.avg_pool1d(
        x, 3, 2, 1, ceil_mode=True), [(2, 3, 10)]),
    "avg_pool2d_inclusive": ("avg_pool2d", lambda F, x: F.avg_pool2d(
        x, 3, 2, 1, exclusive=False), [(2, 3, 7, 7)]),
    "avg_pool2d_ceil_exclusive": ("avg_pool2d", lambda F, x: F.avg_pool2d(
        x, 3, 2, [1, 0], ceil_mode=True), [(1, 3, 8, 7)]),
    "avg_pool2d_divisor": ("avg_pool2d", lambda F, x: F.avg_pool2d(
        x, 2, 1, 1, divisor_override=3), [(1, 2, 5, 5)]),
    "avg_pool2d_nhwc": ("avg_pool2d", lambda F, x: F.avg_pool2d(
        x, [3, 2], [2, 1], [1, 0, 0, 1], data_format="NHWC"),
        [(1, 6, 5, 3)]),
    "avg_pool2d_same": ("avg_pool2d", lambda F, x: F.avg_pool2d(
        x, 3, 2, "SAME"), [(1, 2, 7, 8)]),
    "avg_pool3d": ("avg_pool3d", lambda F, x: F.avg_pool3d(
        x, 2, 2, 1, ceil_mode=True), [(1, 2, 5, 4, 5)]),
    "max_pool1d": ("max_pool1d", lambda F, x: F.max_pool1d(x, 3, 2, 1),
                   [(2, 3, 9)]),
    "max_pool2d": ("max_pool2d", lambda F, x: F.max_pool2d(x, 3, 2, 1),
                   [(2, 3, 7, 7)]),
    "max_pool2d_ceil": ("max_pool2d", lambda F, x: F.max_pool2d(
        x, 3, 2, 0, ceil_mode=True), [(1, 3, 8, 6)]),
    "max_pool2d_nhwc_same": ("max_pool2d", lambda F, x: F.max_pool2d(
        x, 3, 2, "SAME", data_format="NHWC"), [(1, 7, 6, 3)]),
    "max_pool3d": ("max_pool3d", lambda F, x: F.max_pool3d(
        x, [2, 3, 2], 2, [0, 1, 1]), [(1, 2, 4, 5, 4)]),
    "adaptive_avg_pool1d": ("adaptive_avg_pool1d", lambda F, x:
                            F.adaptive_avg_pool1d(x, 4), [(2, 3, 9)]),
    "adaptive_avg_pool2d": ("adaptive_avg_pool2d", lambda F, x:
                            F.adaptive_avg_pool2d(x, [3, 2]),
                            [(1, 3, 7, 6)]),
    "adaptive_avg_pool2d_nhwc": ("adaptive_avg_pool2d", lambda F, x:
                                 F.adaptive_avg_pool2d(x, 3, "NHWC"),
                                 [(1, 5, 7, 2)]),
    "adaptive_avg_pool3d": ("adaptive_avg_pool3d", lambda F, x:
                            F.adaptive_avg_pool3d(x, [2, 3, 1]),
                            [(1, 2, 4, 5, 3)]),
    "adaptive_max_pool1d": ("adaptive_max_pool1d", lambda F, x:
                            F.adaptive_max_pool1d(x, 4), [(2, 3, 10)]),
    "adaptive_max_pool2d": ("adaptive_max_pool2d", lambda F, x:
                            F.adaptive_max_pool2d(x, [3, 4]),
                            [(1, 3, 7, 8)]),
    "adaptive_max_pool3d": ("adaptive_max_pool3d", lambda F, x:
                            F.adaptive_max_pool3d(x, 2),
                            [(1, 2, 5, 4, 3)]),
    "max_unpool1d": ("max_unpool1d", lambda F, x, i: F.max_unpool1d(
        x, i, 2), [_U1[0], _U1[1]]),
    "max_unpool2d": ("max_unpool2d", lambda F, x, i: F.max_unpool2d(
        x, i, 2, output_size=[6, 6]), [_U2[0], _U2[1]]),
    "max_unpool3d": ("max_unpool3d", lambda F, x, i: F.max_unpool3d(
        x, i, 2, 2), [_U3[0], _U3[1]]),
    "hsigmoid_loss": ("hsigmoid_loss", lambda F, x, y, w, b:
                      F.hsigmoid_loss(x, y, 7, w, b),
                      [(4, 6), ("ids", (4,), 7), (6, 6), (6,)]),
    "hsigmoid_loss_custom": (
        "hsigmoid_loss", lambda F, x, y, w, t, c: F.hsigmoid_loss(
            x, y, 5, w, path_table=t, path_code=c),
        [(3, 4), ("ids", (3,), 5), (4, 4),
         np.asarray([[0, 1, 3], [0, 2, 0], [0, 1, 0]], np.int64),
         np.asarray([[1, 0, 1], [0, 1, -1], [1, 1, -1]], np.int64)]),
    "rnnt_loss": ("rnnt_loss", lambda F, x, y, il, ll: F.rnnt_loss(
        x, y, il, ll), [(2, 5, 4, 6), ("ids", (2, 3), 6), _ints(5, 4),
                        _ints(3, 2)]),
    "rnnt_loss_plain_none": (
        "rnnt_loss", lambda F, x, y, il, ll: F.rnnt_loss(
            x, y, il, ll, blank=5, fastemit_lambda=0.0, reduction="none"),
        [(2, 4, 3, 6), ("ids", (2, 2), 5), _ints(4, 3), _ints(2, 1)]),
    "multi_margin_loss": ("multi_margin_loss", lambda F, x, y:
                          F.multi_margin_loss(x, y), [(4, 5),
                                                      ("ids", (4,), 5)]),
    "multi_margin_loss_p2_weight": (
        "multi_margin_loss", lambda F, x, y, w: F.multi_margin_loss(
            x, y, p=2, margin=0.5, weight=w, reduction="sum"),
        [(4, 5), ("ids", (4,), 5), ("constpos", (5,))]),
    "margin_cross_entropy": ("margin_cross_entropy", lambda F, x, y:
                             F.margin_cross_entropy(x, y, 1.0, 0.3, 0.1,
                                                    8.0),
                             [_COS, ("ids", (4,), 6)]),
    "ctc_loss": ("ctc_loss", lambda F, x, y, il, ll: F.ctc_loss(
        x, y, il, ll), [(8, 2, 5), np.asarray([[1, 2, 2], [3, 1, 0]],
                                              np.int64),
                        _ints(8, 6), _ints(3, 2)]),
    "ctc_loss_sum": ("ctc_loss", lambda F, x, y, il, ll: F.ctc_loss(
        x, y, il, ll, blank=4, reduction="sum"),
        [(7, 3, 5), np.asarray([[0, 1], [2, 2], [3, 0]], np.int64),
         _ints(7, 5, 6), _ints(2, 2, 1)]),
}
# the recursions over time (values of order 10 in log space) and the
# convolutions' weight gradients (a few hundred products a term)
TOLS = {fn: dict(rtol=1e-5, atol=1e-5) for fn in (
    "rnnt_loss", "ctc_loss", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose")}
MODULES = ("conv", "pooling", "sequence_loss")
BF16_TOPS = {"conv1d_transpose": 2.0 ** -5, "ctc_loss": 2.0 ** -4}


def test_every_reference_function_has_a_case():
    covered = {fn for fn, _, _ in CASES.values()}
    for m in MODULES:
        ref = importlib.import_module(f"paddle_tpu.nn.functional.{m}")
        port = importlib.import_module(f"paddle_tpu_torch.nn.functional.{m}")
        assert sorted(port.__all__) == sorted(ref.__all__), m
        assert set(ref.__all__) <= covered | {"gather_tree"}, m
        assert set(ref.__all__) <= set(TF.__all__)
    assert "ctc_loss" in covered and "ctc_loss" in TF.__all__


def _run(case_id, dtype="float32"):
    fn, call, specs = CASES[case_id]
    arrays = C.make_inputs(specs, seed=len(case_id))
    want, wg, _ = C.run_jax(lambda *t: call(JF, *t), arrays, len(case_id),
                            dtype=dtype)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got, gg, _ = C.run_port(lambda *t: call(TF, *t), arrays, len(case_id),
                            dtype=tdtype)
    return fn, want, wg, got, gg


@pytest.mark.parametrize("case_id", sorted(CASES))
def test_function_matches_reference(case_id):
    fn, want, wg, got, gg = _run(case_id)
    tol = TOLS.get(fn)
    C.close(got, want, tol=tol, what="out")
    assert len(gg) == len(wg)
    for i, (g, w) in enumerate(zip(gg, wg)):
        C.close(g, w, tol=tol, what=f"grad {i}")


def _close_bf16(got, want, top, what):
    """``C.close``'s bf16 rule at ``top`` (default 2^-6) of the largest
    finite magnitude: ``avg_pool3d``'s ceil-mode case has windows of
    padding alone, 0 / 0 on both sides, and the NaNs must match."""
    top = C.BF16_REL if top is None else top
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.nanmax(np.abs(want))), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=top * scale,
                               err_msg=what)


@pytest.mark.parametrize("case_id", sorted(CASES))
def test_function_matches_reference_bf16(case_id):
    fn, want, wg, got, gg = _run(case_id, "bfloat16")
    top = BF16_TOPS.get(case_id)
    _close_bf16(got, want, top, "out")
    assert len(gg) == len(wg)
    for i, (g, w) in enumerate(zip(gg, wg)):
        _close_bf16(g, w, top, f"grad {i}")


def test_gather_tree_matches_reference():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 9, (5, 2, 3)).astype(np.int64)
    parents = rng.randint(0, 3, (5, 2, 3)).astype(np.int64)
    want = JF.gather_tree(paddle_tpu.to_tensor(ids),
                          paddle_tpu.to_tensor(parents))
    got = TF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


@pytest.mark.parametrize("nd,shape,k,s,p,ceil,ties", [
    (1, (2, 3, 9), 3, 2, 1, False, False),
    (2, (2, 3, 7, 7), 3, 2, 1, False, False),
    (2, (1, 2, 8, 7), 2, 2, [0, 1], True, False),
    (3, (1, 2, 4, 5, 4), 2, 2, 1, False, False),
    (2, (1, 2, 6, 6), 3, 2, 1, False, True),
])
def test_max_pool_mask_matches_reference(nd, shape, k, s, p, ceil, ties):
    """``return_mask``: values and flat indices equal to the reference's;
    on ties (an input of few distinct values) both take the first
    maximum of the window in row-major order."""
    rng = np.random.RandomState(nd)
    x = (rng.randint(0, 3, shape) if ties else rng.randn(*shape)).astype(
        np.float32)
    jf, tf = (getattr(m, f"max_pool{nd}d") for m in (JF, TF))
    jo, jm = jf(paddle_tpu.to_tensor(x), k, s, p, return_mask=True,
                ceil_mode=ceil)
    to, tm = tf(torch.from_numpy(x), k, s, p, return_mask=True,
                ceil_mode=ceil)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo.numpy()))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm.numpy()))
    assert tm.dtype == torch.int32


# -- layers ---------------------------------------------------------------

# name -> (ctor args, ctor kwargs, input specs[, forward kwargs])
LAYERS = {
    "Conv1D": ((3, 4, 3), {"stride": 2, "padding": 1}, [(2, 3, 9)]),
    "Conv2D": ((4, 6, 3), {"padding": "SAME", "stride": 2, "groups": 2,
                           "data_format": "NHWC"}, [(1, 7, 6, 4)]),
    "Conv3D": ((2, 3, [2, 3, 3]), {"padding": 1, "dilation": [1, 2, 1],
                                   "bias_attr": False},
               [(1, 2, 4, 6, 5)]),
    "Conv1DTranspose": ((4, 3, 3), {"stride": 2, "padding": 1,
                                    "output_padding": 1}, [(2, 4, 5)]),
    "Conv2DTranspose": ((4, 6, 3), {"stride": 2, "groups": 2,
                                    "padding": [1, 0]}, [(1, 4, 4, 5)]),
    "Conv3DTranspose": ((2, 3, 2), {"stride": 2}, [(1, 2, 3, 2, 3)]),
    "AvgPool1D": ((3, 2, 1), {"ceil_mode": True}, [(2, 3, 10)]),
    "AvgPool2D": ((3, 2, 1), {"exclusive": False}, [(2, 3, 7, 7)]),
    "AvgPool3D": ((2, 2), {"divisor_override": 3}, [(1, 2, 4, 4, 4)]),
    "MaxPool1D": ((3, 2, 1), {}, [(2, 3, 9)]),
    "MaxPool2D": ((3, 2, 1), {"ceil_mode": True}, [(1, 3, 8, 8)]),
    "MaxPool3D": ((2,), {}, [(1, 2, 4, 4, 4)]),
    "AdaptiveAvgPool1D": ((4,), {}, [(2, 3, 9)]),
    "AdaptiveAvgPool2D": (((1, 1),), {}, [(2, 8, 7, 7)]),
    "AdaptiveAvgPool3D": ((2,), {}, [(1, 2, 5, 4, 3)]),
    "AdaptiveMaxPool1D": ((3,), {}, [(2, 3, 8)]),
    "AdaptiveMaxPool2D": (([3, 2],), {}, [(1, 3, 7, 5)]),
    "AdaptiveMaxPool3D": ((2,), {}, [(1, 2, 4, 5, 3)]),
    "MaxUnPool1D": ((2,), {}, [_U1[0], _U1[1]]),
    "MaxUnPool2D": ((2,), {"output_size": [6, 6]}, [_U2[0], _U2[1]]),
    "MaxUnPool3D": ((2, 2), {}, [_U3[0], _U3[1]]),
    "CTCLoss": ((), {"blank": 0}, [(8, 2, 5), np.asarray(
        [[1, 2, 2], [3, 1, 0]], np.int64), _ints(8, 6), _ints(3, 2)]),
    "HSigmoidLoss": ((6, 7), {}, [(4, 6), ("ids", (4,), 7)]),
    "MultiMarginLoss": ((), {"p": 2, "margin": 0.7}, [(4, 5),
                                                      ("ids", (4,), 5)]),
    "RNNTLoss": ((), {"fastemit_lambda": 0.01},
                 [(2, 5, 4, 6), ("ids", (2, 3), 6), _ints(5, 4),
                  _ints(3, 2)]),
}
LAYER_MODULES = {"conv": None, "pooling": None}
NEW_LOSSES = ("CTCLoss", "HSigmoidLoss", "MultiMarginLoss", "RNNTLoss")


def test_every_reference_layer_has_a_case():
    names = set(NEW_LOSSES)
    for m in LAYER_MODULES:
        ref = importlib.import_module(f"paddle_tpu.nn.layer.{m}")
        port = importlib.import_module(f"paddle_tpu_torch.nn.layer.{m}")
        assert sorted(port.__all__) == sorted(ref.__all__), m
        names |= set(ref.__all__)
    assert names == set(LAYERS)
    ref_loss = importlib.import_module("paddle_tpu.nn.layer.loss")
    assert sorted(pt.nn.layer.loss.__all__) == sorted(ref_loss.__all__)


def _build(name, dtype="float32"):
    args, kwargs, specs = LAYERS[name]
    paddle_tpu.set_default_dtype(dtype)
    pt.set_default_dtype(dtype)
    paddle_tpu.seed(3)
    jl = getattr(paddle_tpu.nn, name)(*args, **kwargs)
    tl = getattr(pt.nn, name)(*args, **kwargs)
    C.carry(jl, tl)
    return jl, tl, specs


def _tol(name):
    if name.startswith("Conv"):
        return TOLS["conv2d"]
    return TOLS.get({"CTCLoss": "ctc_loss", "RNNTLoss": "rnnt_loss"}
                    .get(name))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name):
    jl, tl, specs = _build(name)
    arrays = C.make_inputs(specs, seed=len(name))
    want, wg, wp = C.run_jax(jl, arrays, len(name),
                             params=list(jl.named_parameters()))
    got, gg, gp = C.run_port(tl, arrays, len(name),
                             params=list(tl.named_parameters()))
    assert [(k, tuple(v.shape)) for k, v in tl.state_dict().items()] == [
        (k, tuple(v.shape)) for k, v in jl.state_dict().items()]
    tol = _tol(name)
    C.close(got, want, tol=tol, what="out")
    for g, w in zip(gg, wg):
        C.close(g, w, tol=tol, what="input grad")
    assert set(gp) == set(wp)
    for k in wp:
        C.close(gp[k], wp[k], tol=tol, what=f"grad of {k}")


@pytest.mark.parametrize("name", ["Conv2D", "Conv2DTranspose", "MaxPool2D",
                                  "AvgPool2D", "AdaptiveAvgPool2D",
                                  "HSigmoidLoss"])
def test_layer_matches_reference_bf16(name):
    jl, tl, specs = _build(name, "bfloat16")
    arrays = C.make_inputs(specs, seed=len(name))
    want, wg, wp = C.run_jax(jl, arrays, len(name), dtype="bfloat16",
                             params=list(jl.named_parameters()))
    got, gg, gp = C.run_port(tl, arrays, len(name), dtype=torch.bfloat16,
                             params=list(tl.named_parameters()))
    assert all(p.dtype == torch.bfloat16 for p in tl.parameters())
    C.close(got, want, "bfloat16", what="out")
    for g, w in zip(gg, wg):
        C.close(g, w, "bfloat16", what="input grad")
    for k in wp:
        C.close(gp[k], wp[k], "bfloat16", what=f"grad of {k}")


def test_conv_layer_initializer():
    """The default weight is Uniform(-1/sqrt(fan_in), +) with fan_in =
    in / groups * prod(k) (a transpose: the same formula over its
    [in, out / groups, *k] weight), the bias zeros, ``bias_attr=False``
    none; the draws come from the port's generator."""
    pt.seed(7)
    a = pt.nn.Conv2D(8, 6, 3, groups=2)
    pt.seed(7)
    b = pt.nn.Conv2D(8, 6, 3, groups=2)
    assert torch.equal(a.weight, b.weight)
    bound = 1.0 / np.sqrt(4 * 9)
    assert a.weight.abs().max() <= bound and a.weight.abs().max() > 0.8 * bound
    assert not a.bias.any()
    t = pt.nn.Conv2DTranspose(6, 4, 3, bias_attr=False)
    assert tuple(t.weight.shape) == (6, 4, 3, 3) and t.bias is None
    assert list(t.state_dict()) == ["weight"]
