"""The rest of paddle.incubate and paddle.geometric in paddle_tpu_torch
against paddle_tpu, on the CPU: ``geometric`` (segment ops, message
passing, sampling, reindexing), ``incubate._api`` (the fused softmax masks,
``identity_loss``, ``graph_khop_sampler``, ``LookAhead``, ``ModelAverage``),
``incubate.asp`` (the masks bitwise the reference's, ``prune_model``,
``decorate``), ``incubate.autograd`` (``Jacobian``, ``Hessian``, ``jvp``,
``vjp``, the prim toggles) and ``DistributedFusedLamb`` (the single-device
case against ``Lamb``), mirroring ``tests/test_op_longtail.py:277-340``,
``tests/test_parity_surface2.py:15-90``,
``tests/test_incubate_autograd.py`` and
``tests/test_coverage_tail.py:246``.

Tolerances: float32 on both sides (the JAX side at matmul precision
"highest"); the segment reductions and message passing add the same
float32 values in another order, rtol 1e-5 / atol 1e-6; max and min pick
an element, exact; the softmaxes rtol 1e-5 / atol 1e-7; the autograd
functionals rtol 1e-5 / atol 1e-6; optimizer steps as
``tests/test_coverage_tail.py`` holds them, rtol 1e-5 / atol 1e-6. Max and
min are held on tie-free data: on ties the port's gradient is split evenly
among the tied elements (``scatter_reduce``'s rule). ``sample_neighbors``
draws from an unseeded generator in both packages: it is held exactly where
the sample keeps every neighbour and by its properties elsewhere.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import torch_nn_cases as C
from paddle_tpu import incubate as jinc
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch import optimizer as topt
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

F32 = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "value", x))


def _graph(n=12, e=40, f=5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    src = rng.randint(0, n, e).astype(np.int64)
    dst = rng.randint(0, n - 2, e).astype(np.int64)   # 2 nodes get nothing
    return x, src, dst


def _grad_pair(fn_j, fn_t, x, *rest):
    """(out, d sum(out * ct) / dx) through both packages."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = fn_j(jx, *[paddle.to_tensor(r) for r in rest])
    ct = np.random.RandomState(9).randn(*_np(jout).shape).astype(np.float32)
    (jout * paddle.to_tensor(ct)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = fn_t(tx, *[torch.from_numpy(r) for r in rest])
    (tout * torch.from_numpy(ct)).sum().backward()
    return (_np(tout), _np(jout)), (_np(tx.grad), _np(jx.grad))


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_segment_ops_match_jax(op):
    rng = np.random.RandomState(1)
    data = rng.randn(10, 3).astype(np.float32)        # no ties
    ids = np.array([0, 0, 1, 3, 3, 3, 4, 4, 6, 6], np.int64)  # 2, 5 empty
    name = f"segment_{op}"
    (o, jo), (g, jg) = _grad_pair(getattr(paddle.geometric, name),
                                  getattr(pt.geometric, name), data, ids)
    exact = op in ("max", "min")
    tol = dict(rtol=0, atol=0) if exact else F32
    np.testing.assert_allclose(o, jo, **tol)
    if exact:                        # the empty segments keep -inf / +inf
        assert np.isinf(o[[2, 5]]).all()
    np.testing.assert_allclose(g, jg, **tol)


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_send_u_recv_matches_jax(reduce_op):
    x, src, dst = _graph()
    (o, jo), (g, jg) = _grad_pair(
        lambda a, s, d: paddle.geometric.send_u_recv(a, s, d, reduce_op),
        lambda a, s, d: pt.geometric.send_u_recv(a, s, d, reduce_op),
        x, src, dst)
    np.testing.assert_allclose(o, jo, **F32)
    np.testing.assert_allclose(g, jg, **F32)


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
def test_send_ue_recv_and_uv_match_jax(message_op):
    x, src, dst = _graph(seed=2)
    e = (np.random.RandomState(3).rand(len(src), x.shape[1]) + 0.5).astype(
        np.float32)
    want = paddle.geometric.send_ue_recv(
        paddle.to_tensor(x), paddle.to_tensor(e), paddle.to_tensor(src),
        paddle.to_tensor(dst), message_op=message_op, reduce_op="mean",
        out_size=14)
    got = pt.geometric.send_ue_recv(
        torch.from_numpy(x), torch.from_numpy(e), torch.from_numpy(src),
        torch.from_numpy(dst), message_op=message_op, reduce_op="mean",
        out_size=14)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    uv_j = paddle.geometric.send_uv(paddle.to_tensor(x), paddle.to_tensor(x),
                                    paddle.to_tensor(src),
                                    paddle.to_tensor(dst), message_op)
    uv_t = pt.geometric.send_uv(torch.from_numpy(x), torch.from_numpy(x),
                                torch.from_numpy(src), torch.from_numpy(dst),
                                message_op)
    np.testing.assert_allclose(_np(uv_t), _np(uv_j), **F32)


def _csc():
    # 0 <- {1, 2}, 1 <- {2}, 2 <- {0, 1, 3}, 3 <- {0}
    colptr = np.array([0, 2, 3, 6, 7], np.int64)
    row = np.array([1, 2, 2, 0, 1, 3, 0], np.int64)
    return row, colptr


def test_sampling_and_reindex_match_jax():
    row, colptr = _csc()
    nodes = np.array([0, 2], np.int64)
    outs = []
    for P, T in ((paddle, paddle.to_tensor), (pt, torch.from_numpy)):
        nb, cnt, eids = P.geometric.sample_neighbors(
            T(row), T(colptr), T(nodes), sample_size=-1,
            eids=T(np.arange(7, dtype=np.int64) * 10), return_eids=True)
        src, dst, out_nodes = P.geometric.reindex_graph(T(nodes), nb, cnt)
        outs.append([_np(a) for a in (nb, cnt, eids, src, dst, out_nodes)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    # below the degree: sample_size distinct neighbours of each node
    nb, cnt = pt.geometric.sample_neighbors(
        torch.from_numpy(row), torch.from_numpy(colptr),
        torch.from_numpy(np.array([2], np.int64)), sample_size=2)
    assert _np(cnt).tolist() == [2]
    assert set(_np(nb).tolist()) <= {0, 1, 3} and len(set(_np(nb))) == 2
    nb, cnt = pt.geometric.weighted_sample_neighbors(
        torch.from_numpy(row), torch.from_numpy(colptr),
        torch.from_numpy(np.array([1, 0, 0, 0, 0, 1, 0], np.float32)),
        torch.from_numpy(np.array([2], np.int64)), sample_size=1)
    assert _np(nb).tolist() == [3]            # the only weighted neighbour
    js, jd, jn = paddle.geometric.reindex_heter_graph(
        paddle.to_tensor(nodes), [paddle.to_tensor(row[:2])],
        [paddle.to_tensor(np.array([1, 1], np.int32))])
    ts, td, tn = pt.geometric.reindex_heter_graph(
        torch.from_numpy(nodes), [torch.from_numpy(row[:2])],
        [torch.from_numpy(np.array([1, 1], np.int32))])
    np.testing.assert_array_equal(_np(ts[0]), _np(js[0]))
    np.testing.assert_array_equal(_np(td[0]), _np(jd[0]))
    np.testing.assert_array_equal(_np(tn), _np(jn))


def test_khop_sampler_matches_jax_at_full_fanout():
    row, colptr = _csc()
    outs = []
    for P, T in ((jinc, paddle.to_tensor), (tinc, torch.from_numpy)):
        outs.append([_np(a) for a in P.graph_khop_sampler(
            T(row), T(colptr), T(np.array([0], np.int64)),
            sample_sizes=[-1, -1])])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(2, 3, 8), (1, 2, 6, 6)])
def test_softmax_masks_match_jax(shape):
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    mask = np.where(rng.rand(*shape) < 0.3, -1e9, 0.0).astype(np.float32)
    want = jinc.softmax_mask_fuse(paddle.to_tensor(x),
                                  paddle.to_tensor(mask))
    got = tinc.softmax_mask_fuse(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-7)
    sq = x[..., :shape[-2], :shape[-2]] if len(shape) == 4 else x
    want = jinc.softmax_mask_fuse_upper_triangle(paddle.to_tensor(sq))
    got = tinc.softmax_mask_fuse_upper_triangle(torch.from_numpy(sq))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-7)
    if sq.shape[-1] == sq.shape[-2]:
        assert (np.triu(_np(got)[..., :, :], 1) == 0).all()


def test_identity_loss_matches_jax():
    x = np.asarray([1.0, 3.0], np.float32)
    for red in ("none", "sum", "mean"):
        np.testing.assert_allclose(
            _np(tinc.identity_loss(torch.from_numpy(x), red)),
            _np(jinc.identity_loss(paddle.to_tensor(x), red)), rtol=0)


def _linears(i, o):
    jm, tm = jnn.Linear(i, o), tnn.Linear(i, o)
    C.carry(jm, tm)
    return jm, tm


def _data(rng, n, i, o):
    return (rng.randn(n, i).astype(np.float32),
            rng.randn(n, o).astype(np.float32))


def _jloss(m, x, y):
    return paddle.mean((m(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2)


def _tloss(m, x, y):
    return torch.mean((m(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2)


def test_lookahead_matches_jax():
    jm, tm = _linears(4, 2)
    jla = jinc.LookAhead(jopt.SGD(learning_rate=0.5,
                                  parameters=jm.parameters()), alpha=0.5, k=2)
    tla = tinc.LookAhead(topt.SGD(learning_rate=0.5,
                                  parameters=tm.parameters()), alpha=0.5, k=2)
    x, y = _data(np.random.RandomState(2), 4, 4, 2)
    for _ in range(5):
        _jloss(jm, x, y).backward()
        jla.step()
        jla.clear_grad()
        _tloss(tm, x, y).backward()
        tla.step()
        tla.clear_grad()
        np.testing.assert_allclose(_np(tm.weight), _np(jm.weight), **F32)


def test_model_average_matches_jax():
    jm, tm = _linears(3, 2)
    jma = jinc.ModelAverage(0.15, parameters=list(jm.parameters()),
                            max_average_window=3)
    tma = tinc.ModelAverage(0.15, parameters=list(tm.parameters()),
                            max_average_window=3)
    for i in range(5):
        jm.weight.set_value(jm.weight.value + 1.0)
        with torch.no_grad():
            tm.weight.add_(1.0)
        jma.step()
        tma.step()
    now = _np(tm.weight).copy()
    with jma.apply(), tma.apply():
        np.testing.assert_allclose(_np(tm.weight), _np(jm.weight), **F32)
        assert not np.allclose(_np(tm.weight), now)
    np.testing.assert_allclose(_np(tm.weight), now, rtol=0)


@pytest.mark.parametrize("algo", ["mask_1d", "mask_2d_greedy",
                                  "mask_2d_best"])
def test_asp_masks_bitwise_and_decorate(algo):
    from paddle_tpu.incubate import asp as jasp
    from paddle_tpu_torch.incubate import asp as tasp

    rng = np.random.RandomState(5)
    w = rng.randn(12, 10).astype(np.float32)
    for fn in ("get_mask_1d", "get_mask_2d_greedy", "get_mask_2d_best"):
        np.testing.assert_array_equal(getattr(tasp, fn)(w, 2, 4),
                                      getattr(jasp, fn)(w, 2, 4))
    t3 = rng.randn(2, 4, 8).astype(np.float32)
    np.testing.assert_array_equal(
        tasp.create_mask(torch.from_numpy(t3), tasp.MaskAlgo.MASK_1D),
        jasp.create_mask(t3, jasp.MaskAlgo.MASK_1D))
    jm, tm = jnn.Sequential(jnn.Linear(8, 16), jnn.Linear(16, 4)), \
        tnn.Sequential(tnn.Linear(8, 16), tnn.Linear(16, 4))
    C.carry(jm, tm)
    jasp.set_excluded_layers(jm, ["1.weight"])
    tasp.set_excluded_layers(tm, ["1.weight"])
    jmasks = jasp.prune_model(jm, 2, 4, mask_algo=algo)
    tmasks = tasp.prune_model(tm, 2, 4, mask_algo=algo)
    assert list(tmasks) == list(jmasks) == ["0.weight"]
    np.testing.assert_array_equal(tmasks["0.weight"], jmasks["0.weight"])
    check = tasp.CheckMethod.get_checking_method(
        tasp.MaskAlgo(f"get_{algo}"))
    assert tasp.check_sparsity(tm[0].weight, check, 2, 4)
    assert tasp.calculate_density(tm[0].weight) == pytest.approx(0.5)
    tdec = tasp.decorate(topt.SGD(learning_rate=0.1,
                                  parameters=tm.parameters()), tm)
    jdec = jasp.decorate(jopt.SGD(learning_rate=0.1,
                                  parameters=jm.parameters()), jm)
    x, y = _data(np.random.RandomState(6), 4, 8, 4)
    for _ in range(2):
        _jloss(jm, x, y).backward()
        jdec.step()
        jdec.clear_grad()
        _tloss(tm, x, y).backward()
        tdec.step()
        tdec.clear_grad()
        assert tasp.check_sparsity(tm[0].weight, check, 2, 4)
        np.testing.assert_allclose(_np(tm[0].weight), _np(jm[0].weight),
                                   **F32)
    with pytest.raises(ValueError, match="model"):
        tasp.decorate(tdec)


def test_jacobian_hessian_jvp_vjp_match_jax():
    from paddle_tpu.incubate import autograd as jiag
    from paddle_tpu_torch.incubate import autograd as tiag

    rng = np.random.RandomState(7)
    a = rng.randn(3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    xb = rng.randn(4, 3).astype(np.float32)
    J, T = paddle.to_tensor, torch.from_numpy

    def fj(x):
        return paddle.tanh(x * 2.0) ** 2

    def ft(x):
        return torch.tanh(x * 2.0) ** 2

    def gj(x, y):
        return (x * y).sum() + (x ** 3).sum()

    def gt(x, y):
        return (x * y).sum() + (x ** 3).sum()

    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tiag.Jacobian(ft, T(a))[:]),
                               _np(jiag.Jacobian(fj, J(a))[:]), **tol)
    np.testing.assert_allclose(
        _np(tiag.Jacobian(lambda x, y: x * y, [T(a), T(b)])[:]),
        _np(jiag.Jacobian(lambda x, y: x * y, [J(a), J(b)])[:]), **tol)
    jb = tiag.Jacobian(ft, T(xb), batch_axis=0)
    assert jb.shape == (4, 3, 3)
    np.testing.assert_allclose(
        _np(jb[:]), _np(jiag.Jacobian(fj, J(xb), batch_axis=0)[:]), **tol)
    np.testing.assert_allclose(_np(tiag.Hessian(gt, [T(a), T(b)])[:]),
                               _np(jiag.Hessian(gj, [J(a), J(b)])[:]), **tol)
    for (to, tt), (jo, jt) in (
            (tiag.jvp(ft, T(a), T(b)), jiag.jvp(fj, J(a), J(b))),
            (tiag.vjp(ft, T(a), T(b)), jiag.vjp(fj, J(a), J(b)))):
        np.testing.assert_allclose(_np(to), _np(jo), **tol)
        np.testing.assert_allclose(_np(tt), _np(jt), **tol)
    out, (ga, gb) = tiag.vjp(lambda x, y: x * y, [T(a), T(b)])
    np.testing.assert_allclose(_np(ga), b, **tol)
    with pytest.raises(TypeError, match="scalar-output"):
        tiag.Hessian(ft, T(a))[:]
    with pytest.raises(ValueError, match="batch_axis"):
        tiag.Jacobian(ft, T(a), batch_axis=1)
    with pytest.raises(NotImplementedError, match="jvp"):
        tiag.forward_grad(None, None)
    assert tiag.prim_enabled() is False
    tiag.enable_prim()
    assert tiag.prim_enabled() is True
    tiag.disable_prim()
    assert tiag.prim2orig() is None and tiag.prim_enabled() is False


@pytest.mark.parametrize("acc", [1, 2])
def test_distributed_fused_lamb_matches_jax(acc):
    from paddle_tpu.incubate.optimizer import DistributedFusedLamb as JDFL
    from paddle_tpu_torch.incubate.optimizer import DistributedFusedLamb

    jm, tm = _linears(4, 3)
    jd = JDFL(learning_rate=0.01, parameters=jm.parameters(),
              gradient_accumulation_steps=acc)
    td = DistributedFusedLamb(learning_rate=0.01,
                              parameters=tm.parameters(),
                              gradient_accumulation_steps=acc)
    lm = tnn.Linear(4, 3)
    lm.load_dict(tm.state_dict())
    lamb = topt.Lamb(learning_rate=0.01, parameters=lm.parameters())
    rng = np.random.RandomState(12)
    for step in range(4):
        x, y = _data(rng, 16, 4, 3)
        _jloss(jm, x, y).backward()
        jd.step()
        jd.clear_grad()
        _tloss(tm, x, y).backward()
        td.step()
        td.clear_grad()
        np.testing.assert_allclose(_np(tm.weight), _np(jm.weight), **F32)
        if acc == 1:                    # the single-device case is Lamb
            _tloss(lm, x, y).backward()
            lamb.step()
            lamb.clear_grad()
            assert torch.equal(tm.weight, lm.weight)
