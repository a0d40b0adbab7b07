"""The port's quantization against the JAX package's
(``paddle_tpu_torch.quantization`` / ``static.quantization`` /
``static.amp`` vs ``paddle_tpu``'s), on the same seeded numpy inputs.

- ``quant`` / ``dequant`` and ``fake_quant``'s forward: bitwise (the same
  fp32 ops in the same order; both round half to even);
- ``fake_quant``'s straight-through gradient: bitwise against
  ``jax.vjp`` of the reference's ``_fake_quant``;
- the observers' scales (``AbsmaxObserver``, ``FakeQuanterWithAbsMax``'s
  first-batch seed and moving average): equal to fp32 rounding;
- ``QuantedLinear``, ``QAT`` and ``PTQ`` over a small MLP with the
  reference's weights: outputs allclose (``QTOL``), before and after
  ``convert``, and after two QAT training steps on both sides;
- ``QAT`` / ``PTQ`` over the tiny Llama's linears (the port swaps the
  column/row-parallel linears, which the reference's map leaves out):
  every decoder linear swapped, logits within int8 error of the plain
  model's, QAT training steps finite and decreasing on a repeated batch;
- ``static.quantization``'s transform and freeze passes over recorded
  programs, case for case with ``tests/test_static_quantization.py``,
  against the reference's programs;
- ``static.amp``: ``cast_model_to_bf16`` / ``fp16`` outputs, ``decorate``'s
  training losses and ``cast_parameters_to_*``, against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import quantization as jq
import paddle_tpu_torch as pt
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch import static as tstatic

from torch_jax_state import jax_reference_state, one_thread  # noqa: F401

# QAT/PTQ forwards: the two sides' fp32 matmuls differ in the last bits,
# which can move a value across a rounding boundary of the int8 grid:
# one step of the grid (scale / 127) is the most one element can differ
QTOL = dict(rtol=1e-4, atol=5e-2)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def cpu_place():
    from paddle_tpu_torch.core import place

    saved = place._current[0]
    pt.set_device("cpu")
    yield
    place._current[0] = saved


def _np(t):
    return t.detach().cpu().numpy()


def _val(t):
    return np.asarray(t.value if hasattr(t, "value") else t)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_dequant_equal_the_reference(bits):
    x = np.random.RandomState(bits).randn(64, 9).astype(np.float32)
    s = float(np.abs(x).max())
    tqx = tq.quant(torch.from_numpy(x), s, bits)
    jqx = jq.quant(paddle.to_tensor(x), s, bits)
    np.testing.assert_array_equal(_np(tqx), _val(jqx))
    np.testing.assert_array_equal(_np(tq.dequant(tqx, s, bits)),
                                  _val(jq.dequant(jqx, s, bits)))


@pytest.mark.parametrize("bits,frac", [(8, 1.0), (8, 0.5), (4, 0.7)])
def test_fake_quant_and_its_gradient_equal_the_reference(bits, frac):
    rng = np.random.RandomState(bits)
    x = rng.randn(32, 16).astype(np.float32)
    g = rng.randn(32, 16).astype(np.float32)
    s = float(np.abs(x).max()) * frac
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tq.fake_quant(tx, s, bits)
    (tg,) = torch.autograd.grad(ty, tx, torch.from_numpy(g))
    qmax = float(2 ** (bits - 1) - 1)
    jy, vjp = jax.vjp(lambda v: jq._fake_quant(v, jnp.asarray(s), qmax),
                      jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(_np(ty), np.asarray(jy))
    np.testing.assert_array_equal(_np(tg), np.asarray(jg))
    np.testing.assert_array_equal(
        _np(ty), _val(jq.fake_quant(paddle.to_tensor(x), s, bits)))


def test_observers_equal_the_reference():
    rng = np.random.RandomState(0)
    tobs, jobs = tq.AbsmaxObserver(), jq.AbsmaxObserver()
    tfq, jfq = tq.FakeQuanterWithAbsMax(), jq.FakeQuanterWithAbsMax()
    for i in range(4):
        x = (rng.randn(8, 5) * (i + 1)).astype(np.float32)
        tobs(torch.from_numpy(x))
        jobs(paddle.to_tensor(x))
        ty = tfq(torch.from_numpy(x))
        jy = jfq(paddle.to_tensor(x))
        np.testing.assert_allclose(_np(ty), _val(jy), rtol=1e-6, atol=1e-6)
        assert float(tobs.scales()) == float(_val(jobs.scales()))
        assert tfq._scale == pytest.approx(jfq._scale, rel=1e-6)
    assert tobs.bit_length() == jobs.bit_length() == 8


def _mlp_pair(seed=0):
    paddle.seed(seed)
    jm = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                              paddle.nn.Linear(32, 8))
    tm = pt.nn.Sequential(pt.nn.Linear(16, 32), pt.nn.ReLU(),
                          pt.nn.Linear(32, 8))
    with torch.no_grad():
        for (_, jp), tp in zip(jm.named_parameters(), tm.parameters()):
            tp.copy_(torch.from_numpy(np.array(jp.value)))
    return jm, tm


def _x(n=8, seed=1):
    return np.random.RandomState(seed).randn(n, 16).astype(np.float32)


def test_quanted_linear_equals_the_reference():
    jm, tm = _mlp_pair()
    jl = jq.QuantedLinear(jm[0])
    tl = tq.QuantedLinear(tm[0])
    for seed in (1, 2):
        x = _x(seed=seed)
        np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                                   _val(jl(paddle.to_tensor(x))), **QTOL)


def test_qat_over_mlp_equals_the_reference():
    jm, tm = _mlp_pair()
    cfg_t, cfg_j = tq.QuantConfig(), jq.QuantConfig()
    tqm = tq.QAT(cfg_t).quantize(tm)
    jqm = jq.QAT(cfg_j).quantize(jm)
    assert isinstance(tqm[0], tq.QuantedLinear)
    assert isinstance(tm[0], pt.nn.Linear)          # not in place
    x, y = _x(), np.random.RandomState(2).randn(8, 8).astype(np.float32)
    np.testing.assert_allclose(_np(tqm(torch.from_numpy(x))),
                               _val(jqm(paddle.to_tensor(x))), **QTOL)
    from paddle_tpu.optimizer import SGD as JSGD
    from paddle_tpu_torch.optimizer import SGD

    topt = SGD(learning_rate=0.05, parameters=tqm.parameters())
    jopt = JSGD(learning_rate=0.05, parameters=jqm.parameters())
    for _ in range(2):
        tl = ((tqm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
        tl.backward()
        topt.step()
        topt.clear_grad()
        jl = ((jqm(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    tc = tq.QAT(cfg_t).convert(tqm)
    jc = jq.QAT(cfg_j).convert(jqm)
    np.testing.assert_allclose(_np(tc(torch.from_numpy(x))),
                               _val(jc(paddle.to_tensor(x))), **QTOL)


def test_ptq_over_mlp_equals_the_reference():
    jm, tm = _mlp_pair(seed=3)
    tp, jp = tq.PTQ(), jq.PTQ()
    tqm, jqm = tp.quantize(tm), jp.quantize(jm)
    calib = _x(32, seed=4)
    tqm(torch.from_numpy(calib))
    jqm(paddle.to_tensor(calib))
    assert [o._max for o in tp._observers] == pytest.approx(
        [o._max for o in jp._observers], rel=1e-6)
    tc, jc = tp.convert(tqm), jp.convert(jqm)
    assert isinstance(tc[2], tq.QuantedLinear)
    assert tc[2].activation_quanter._scale == pytest.approx(
        jc[2].activation_quanter._scale, rel=1e-6)
    x = _x(seed=5)
    np.testing.assert_allclose(_np(tc(torch.from_numpy(x))),
                               _val(jc(paddle.to_tensor(x))), **QTOL)


def _tiny_llama():
    m = pt.LlamaForCausalLM(pt.llama_config("tiny"), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 256, (2, 16)).astype(np.int64))
    return m, ids


def test_qat_over_tiny_llama_linears():
    m, ids = _tiny_llama()
    qm = tq.QAT(tq.QuantConfig()).quantize(m)
    quanted = [n for n, s in qm.named_modules()
               if isinstance(s, tq.QuantedLinear)]
    assert len(quanted) == 2 * 7 + 1            # 7 a layer + the lm head
    with torch.no_grad():
        ref, got = m(ids), qm(ids)
    err = (got - ref).abs().max() / ref.abs().max()
    assert torch.isfinite(got).all() and 0 < float(err) < 0.05
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=1e-2, parameters=qm.parameters())
    losses = []
    for _ in range(3):
        loss = qm(ids, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_ptq_over_tiny_llama_linears():
    m, ids = _tiny_llama()
    ptq = tq.PTQ()
    qm = ptq.quantize(m)
    assert len(ptq._observers) == 15
    with torch.no_grad():
        qm(ids)                                 # calibration
        conv = ptq.convert(qm)
        got, ref = conv(ids), m(ids)
    assert all(o._max > 1e-3 for o in ptq._observers)
    err = (got - ref).abs().max() / ref.abs().max()
    assert 0 < float(err) < 0.05


# -- static.quantization (tests/test_static_quantization.py, both packages) --


@pytest.fixture
def static_mode():
    from paddle_tpu.static.program import Program as JP
    from paddle_tpu.static.program import static_state as js
    from paddle_tpu_torch.static.program import Program as TP
    from paddle_tpu_torch.static.program import static_state as ts

    paddle.enable_static()
    tstatic.enable_static()
    js.main_program, js.startup_program = JP(), JP()
    ts.main_program, ts.startup_program = TP(), TP()
    try:
        yield
    finally:
        paddle.disable_static()
        tstatic.disable_static()


def _pair_prog(h=8, o=4):
    """The same Linear + tanh program recorded in both packages, the
    port's layer holding the reference's weights."""
    jl = paddle.nn.Linear(h, o)
    tl = pt.nn.Linear(h, o)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight.value)))
        tl.bias.copy_(torch.from_numpy(np.array(jl.bias.value)))
    jout = paddle.tanh(jl(paddle.static.data("x", [None, h])))
    tout = torch.tanh(tl(tstatic.data("x", [None, h])))
    return ((paddle.static, jout, paddle.static.default_main_program()),
            (tstatic, tout, tstatic.default_main_program()))


def _exe(st):
    return st.Executor() if st is paddle.static \
        else st.Executor(pt.CPUPlace())


def test_transform_pass_inserts_fake_quant_nodes(static_mode):
    from paddle_tpu.static.quantization import quant_aware as jqa
    from paddle_tpu_torch.static.quantization import quant_aware as tqa

    (_, _, jprog), (_, _, tprog) = _pair_prog()
    jqp, tqp = jqa(jprog), tqa(tprog)
    assert tqp._quant_inserted == jqp._quant_inserted == 3
    assert len(tqp.nodes) == len(tprog.nodes) + 3
    assert [n.name for n in tqp.nodes].count(
        "fake_quantize_dequantize_absmax") == 3


def test_quantized_forward_equals_the_reference(static_mode):
    from paddle_tpu.static.quantization import quant_aware as jqa
    from paddle_tpu_torch.static.quantization import quant_aware as tqa

    X = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    outs = []
    for (st, out, prog), qa in zip(_pair_prog(), (jqa, tqa)):
        qprog = qa(prog)
        exe = _exe(st)
        (ref,) = exe.run(prog, feed={"x": X}, fetch_list=[out])
        (q,) = exe.run(qprog, feed={"x": X}, fetch_list=[out])
        assert 0 < np.abs(q - ref).max() < 0.1
        outs.append(q)
    np.testing.assert_allclose(outs[1], outs[0], **QTOL)


def test_non_quantizable_ops_untouched(static_mode):
    from paddle_tpu_torch.static.quantization import quant_aware

    x = tstatic.data("x", [None, 4])
    torch.tanh(torch.exp(x))
    prog = tstatic.default_main_program()
    qprog = quant_aware(prog)
    assert qprog._quant_inserted == 0
    assert len(qprog.nodes) == len(prog.nodes)


def test_minimize_through_fake_quant_equals_the_reference(static_mode):
    from paddle_tpu.optimizer import SGD as JSGD
    from paddle_tpu.static.quantization import quant_aware as jqa
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static.quantization import quant_aware as tqa

    jl, tl = paddle.nn.Linear(8, 1), pt.nn.Linear(8, 1)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight.value)))
        tl.bias.copy_(torch.from_numpy(np.array(jl.bias.value)))
    rng = np.random.RandomState(0)
    X = rng.randn(32, 8).astype(np.float32)
    Y = X @ rng.randn(8, 1).astype(np.float32)
    curves = []
    for st, lin, qa, opt, mean in ((paddle.static, jl, jqa, JSGD,
                                    paddle.mean),
                                   (tstatic, tl, tqa, SGD, torch.mean)):
        x, y = st.data("x", [None, 8]), st.data("y", [None, 1])
        loss = mean((lin(x) - y) ** 2)
        qprog = qa(st.default_main_program())
        with st.program_guard(qprog):
            opt(learning_rate=0.1).minimize(loss)
        exe = _exe(st)
        curves.append([float(exe.run(qprog, feed={"x": X, "y": Y},
                                     fetch_list=[loss])[0])
                       for _ in range(25)])
    np.testing.assert_allclose(curves[1], curves[0], rtol=2e-2)
    assert curves[1][-1] < curves[1][0] * 0.5


def test_freeze_pass_equals_the_reference(static_mode):
    from paddle_tpu.static.quantization import convert as jconv
    from paddle_tpu.static.quantization import quant_aware as jqa
    from paddle_tpu_torch.static.quantization import convert as tconv
    from paddle_tpu_torch.static.quantization import quant_aware as tqa

    X = np.random.RandomState(1).randn(4, 8).astype(np.float32)
    res = []
    for (st, out, prog), qa, conv in zip(_pair_prog(), (jqa, tqa),
                                         (jconv, tconv)):
        qprog = qa(prog)
        exe = _exe(st)
        exe.run(qprog, feed={"x": X}, fetch_list=[out])
        fprog = conv(qprog)
        names = [n.name for n in fprog.nodes]
        assert names.count("fake_quantize_dequantize_frozen") == 2
        assert names.count("fake_quantize_dequantize_absmax") == 1
        (q,) = exe.run(qprog, feed={"x": X}, fetch_list=[out])
        (f,) = exe.run(fprog, feed={"x": X}, fetch_list=[out])
        np.testing.assert_allclose(f, q, rtol=1e-5, atol=1e-6)
        res.append((sorted(fprog._quant_scales.values()), f))
    assert res[1][0] == pytest.approx(res[0][0], rel=1e-6)
    np.testing.assert_allclose(res[1][1], res[0][1], **QTOL)


def test_shared_input_quantized_once(static_mode):
    from paddle_tpu_torch.static.quantization import quant_aware

    x = tstatic.data("x", [None, 8])
    pt.nn.Linear(8, 4)(x) + pt.nn.Linear(8, 4)(x)
    qprog = quant_aware(tstatic.default_main_program())
    assert qprog._quant_inserted == 5


# -- static.amp ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cast_model_equals_the_reference(static_mode, dtype):
    from paddle_tpu.static import amp as jamp
    from paddle_tpu_torch.static import amp as tamp

    X = np.random.RandomState(0).randn(6, 8).astype(np.float32)
    outs = []
    for (st, out, prog), amp in zip(_pair_prog(), (jamp, tamp)):
        cast = (amp.cast_model_to_bf16(prog) if dtype == "bfloat16"
                else amp.cast_model_to_fp16(prog))
        (o,) = _exe(st).run(cast, feed={"x": X}, fetch_list=[out])
        assert o.dtype == np.float32
        outs.append(o)
    np.testing.assert_allclose(outs[1], outs[0], **BF16)


def test_decorate_trains_like_the_reference(static_mode):
    from paddle_tpu.optimizer import SGD as JSGD
    from paddle_tpu.static import amp as jamp
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import amp as tamp

    jl, tl = paddle.nn.Linear(8, 1), pt.nn.Linear(8, 1)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight.value)))
        tl.bias.copy_(torch.from_numpy(np.array(jl.bias.value)))
    rng = np.random.RandomState(0)
    X = rng.randn(32, 8).astype(np.float32)
    Y = X @ rng.randn(8, 1).astype(np.float32)
    curves = []
    for st, lin, amp, opt in ((paddle.static, jl, jamp, JSGD),
                              (tstatic, tl, tamp, SGD)):
        x, y = st.data("x", [None, 8]), st.data("y", [None, 1])
        loss = ((lin(x) - y) ** 2).mean()
        dec = amp.decorate(opt(learning_rate=0.1),
                           amp.AutoMixedPrecisionLists(dtype="bfloat16"))
        dec.minimize(loss)
        assert dec.get_loss_scaling() == 1.0
        exe = _exe(st)
        curves.append([float(exe.run(feed={"x": X, "y": Y},
                                     fetch_list=[loss])[0])
                       for _ in range(10)])
    np.testing.assert_allclose(curves[1], curves[0], rtol=5e-2)
    assert curves[1][-1] < curves[1][0]


def test_cast_parameters(static_mode):
    from paddle_tpu_torch.static import amp as tamp

    (_, _, _), (st, out, prog) = _pair_prog()
    tamp.cast_parameters_to_bf16(program=prog)
    assert all(p.dtype == torch.bfloat16 for p in prog.param_objs.values())
    tamp.cast_parameters_to_fp16(program=prog)
    assert all(p.dtype == torch.float16 for p in prog.param_objs.values())
    lists = tamp.AutoMixedPrecisionLists(custom_white_list=["tanh"],
                                         custom_black_list=["linear"])
    assert "tanh" in lists.white_list and "linear" not in lists.white_list


def test_all_names_equal_the_reference():
    from paddle_tpu.static import amp as jamp
    from paddle_tpu.static import quantization as jsq
    from paddle_tpu_torch.static import amp as tamp
    from paddle_tpu_torch.static import quantization as tsq

    for mine, ref in ((tq, jq), (tamp, jamp), (tsq, jsq)):
        assert sorted(mine.__all__) == sorted(ref.__all__)
        for name in ref.__all__:
            assert hasattr(mine, name), name
