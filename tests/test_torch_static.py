"""The port's static mode against the JAX package's
(``paddle_tpu_torch.static`` vs ``paddle_tpu.static``).

Every case of ``tests/test_static.py`` runs in both packages on the same
seeded numpy inputs and the same weights (copied from the JAX layer into
the port's), with outputs, losses and fetched gradients allclose at
``TOL`` (fp32; the JAX side computes its matmuls at "highest" precision):
record and run, multiple fetches, layer parameters as state, a dynamic
batch dim, eager after ``disable_static``, SGD and AdamW ``minimize``, an
LR change between runs, parameter objects kept in sync,
``append_backward``'s gradient fetch, ``program_guard``,
``clone(for_test=True)``, ``scope_guard``, the mode flags, ``save`` /
``load`` and ``gradients`` with respect to a feed.

Beyond those:

- the ``"tiny"`` Llama with labels, recorded in both packages from the
  same weights (``load_paddle_params``) and trained 3 AdamW steps through
  ``Executor.run``: losses allclose at ``LLAMA_TOL``;
- the port's static step is bitwise its own eager step (losses and the
  parameters after 3 steps), and launches (on the CPU: calls the plain
  versions of) the same kernels as many times;
- a kernel node records as one node named after its kernel, its output's
  shape from the library op's registered fake;
- a recorded dropout draws a fresh mask on each run, repeated under
  ``paddle.seed``;
- ``save_inference_model`` / ``load_inference_model`` (the Predictor over
  a ``.pt2``), ``set_program_state`` / ``save_program_state`` /
  ``load_program_state``, ``serialize_*`` / ``deserialize_*``, ``py_func``,
  ``Print``, ``accuracy``, ``auc``, ``ctr_metric_bundle``,
  ``create_global_var``, ``exponential_decay``, EMA, and the names of
  ``static.__all__`` against the reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_config
import paddle_tpu_torch as pt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.ops import flash_attention_kernel as fk
from paddle_tpu_torch.ops import fused_kernels

from torch_jax_state import jax_reference_state, one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
# 3 AdamW steps of the tiny Llama (fp32): the two packages agree to the
# last bits on the CPU; the bar leaves room for another BLAS's order
LLAMA_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def cpu_place():
    from paddle_tpu_torch.core import place

    saved = place._current[0]
    pt.set_device("cpu")
    yield
    place._current[0] = saved


@pytest.fixture
def static_mode():
    """Both packages in static mode with fresh default programs."""
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
    assert torch._C._len_torch_function_stack() == 0


def _np(t):
    return t.detach().cpu().numpy()


def _linear_pair(i, o, bias=True):
    """A JAX Linear and a port Linear holding its weights."""
    jl = paddle.nn.Linear(i, o, bias_attr=None if bias else False)
    tl = pt.nn.Linear(i, o, bias_attr=None if bias else False)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight.value)))
        if bias:
            tl.bias.copy_(torch.from_numpy(np.array(jl.bias.value)))
    return jl, tl


def _exes():
    return paddle.static.Executor(), tstatic.Executor(pt.CPUPlace())


# -- TestRecordRun -----------------------------------------------------------


def test_simple_forward(static_mode):
    X = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    jy = paddle.tanh(paddle.static.data("x", [None, 4]))
    ty = torch.tanh(tstatic.data("x", [None, 4]))
    je, te = _exes()
    (jo,) = je.run(feed={"x": X}, fetch_list=[jy])
    (to,) = te.run(feed={"x": X}, fetch_list=[ty])
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(to, np.tanh(X), rtol=1e-6)


def test_multiple_fetches(static_mode):
    X = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    ja = paddle.exp(paddle.static.data("x", [None, 4]))
    ta = torch.exp(tstatic.data("x", [None, 4]))
    jb, tb = ja + 1.0, ta + 1.0
    je, te = _exes()
    for j, t in zip(je.run(feed={"x": X}, fetch_list=[ja, jb]),
                    te.run(feed={"x": X}, fetch_list=[ta, tb])):
        np.testing.assert_allclose(t, j, **TOL)


def test_layer_params_become_state(static_mode):
    jl, tl = _linear_pair(8, 2)
    jo = jl(paddle.static.data("x", [None, 8]))
    to = tl(tstatic.data("x", [None, 8]))
    assert len(tstatic.default_main_program().param_vars) == \
        len(paddle.static.default_main_program().param_vars) == 2
    X = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    je, te = _exes()
    (j,) = je.run(feed={"x": X}, fetch_list=[jo])
    (t,) = te.run(feed={"x": X}, fetch_list=[to])
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(
        t, X @ _np(tl.weight) + _np(tl.bias), rtol=1e-5)


def test_dynamic_batch_dim(static_mode):
    jy = paddle.static.data("x", [None, 4]) * 2.0
    ty = tstatic.data("x", [None, 4]) * 2.0
    je, te = _exes()
    for bs in (2, 5):
        X = np.random.RandomState(bs).randn(bs, 4).astype(np.float32)
        (j,) = je.run(feed={"x": X}, fetch_list=[jy])
        (t,) = te.run(feed={"x": X}, fetch_list=[ty])
        assert t.shape == j.shape == (bs, 4)
        np.testing.assert_allclose(t, j, **TOL)


def test_eager_unaffected_after_disable(static_mode):
    tstatic.disable_static()
    assert torch._C._len_torch_function_stack() == 0
    t = pt.tanh(pt.ones([2]))
    assert not t.is_meta and float(t.sum()) > 0
    tstatic.enable_static()
    assert torch._C._len_torch_function_stack() == 1


# -- TestStaticTraining --------------------------------------------------------


def _train(opt, lr, steps=40):
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt

    jl, tl = _linear_pair(13, 1)
    losses = []
    for pkg, st, lin, om in ((paddle, paddle.static, jl, jopt),
                             (pt, tstatic, tl, topt)):
        x = st.data("x", [None, 13])
        y = st.data("y", [None, 1])
        loss = ((lin(x) - y) ** 2).mean()
        getattr(om, opt)(learning_rate=lr).minimize(loss)
        exe = st.Executor() if pkg is paddle else st.Executor(pt.CPUPlace())
        exe.run(st.default_startup_program())
        rng = np.random.RandomState(0)
        X = rng.randn(32, 13).astype(np.float32)
        Y = X @ rng.randn(13, 1).astype(np.float32)
        losses.append([float(exe.run(feed={"x": X, "y": Y},
                                     fetch_list=[loss])[0])
                       for _ in range(steps)])
    return losses


@pytest.mark.parametrize("opt,lr,drop", [("SGD", 0.05, 0.2),
                                         ("AdamW", 0.05, 0.5)])
def test_minimize(static_mode, opt, lr, drop):
    jl, tl = _train(opt, lr)
    np.testing.assert_allclose(tl, jl, **TRAIN_TOL)
    assert tl[-1] < tl[0] * drop


def test_lr_change_takes_effect(static_mode):
    """set_lr between runs changes the update without re-recording."""
    from paddle_tpu_torch.optimizer import SGD

    x = tstatic.data("x", [None, 4])
    lin = pt.nn.Linear(4, 1, bias_attr=False)
    loss = (lin(x) ** 2).mean()
    opt = SGD(learning_rate=0.1)
    opt.minimize(loss)
    exe = tstatic.Executor(pt.CPUPlace())
    exe.run(tstatic.default_startup_program())
    X = np.ones((2, 4), np.float32)
    w0 = _np(tstatic.global_scope().vars.get(lin.weight.name,
                                             lin.weight)).copy()
    exe.run(feed={"x": X}, fetch_list=[loss])
    step1 = np.abs(_np(lin.weight) - w0).max()
    opt.set_lr(0.0)  # freeze
    w1 = _np(lin.weight).copy()
    exe.run(feed={"x": X}, fetch_list=[loss])
    assert step1 > 0
    np.testing.assert_array_equal(_np(lin.weight), w1)


def test_param_objs_stay_synced(static_mode):
    from paddle_tpu_torch.optimizer import SGD

    x = tstatic.data("x", [None, 4])
    lin = pt.nn.Linear(4, 1)
    w0 = _np(lin.weight).copy()
    loss = (lin(x) ** 2).mean()
    SGD(learning_rate=0.1).minimize(loss)
    exe = tstatic.Executor(pt.CPUPlace())
    exe.run(tstatic.default_startup_program())
    exe.run(feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[loss])
    assert not np.allclose(_np(lin.weight), w0)


# -- TestAppendBackward --------------------------------------------------------


def test_grad_fetch(static_mode):
    jl, tl = _linear_pair(4, 1, bias=False)
    out = []
    X = np.random.RandomState(3).randn(8, 4).astype(np.float32)
    for st, lin in ((paddle.static, jl), (tstatic, tl)):
        loss = (lin(st.data("x", [None, 4])) ** 2).mean()
        pg = st.append_backward(loss)
        assert len(pg) == 1
        exe = st.Executor() if st is paddle.static \
            else st.Executor(pt.CPUPlace())
        out.append(exe.run(feed={"x": X}, fetch_list=[loss, pg[0][1]]))
    (jl_, jg), (tl_, tg) = out
    np.testing.assert_allclose(tl_, jl_, **TOL)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    W = _np(tl.weight)
    np.testing.assert_allclose(tg, 2.0 * X.T @ (X @ W) / X.shape[0],
                               rtol=1e-4)


# -- TestProgramGuard / TestScopeGuard / TestStaticIO --------------------------


def test_program_guard_isolation(static_mode):
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data("x", [None, 2])
        x + 1.0
    assert len(main.nodes) == 1
    assert len(tstatic.default_main_program().nodes) == 0


def test_clone_for_test_drops_train_config(static_mode):
    from paddle_tpu_torch.optimizer import SGD

    x = tstatic.data("x", [None, 2])
    loss = (pt.nn.Linear(2, 1)(x) ** 2).mean()
    SGD(learning_rate=0.1).minimize(loss)
    prog = tstatic.default_main_program()
    test_prog = prog.clone(for_test=True)
    assert prog.train_config is not None
    assert test_prog.train_config is None
    assert test_prog.id != prog.id and test_prog._origin_id == prog.id
    X = np.ones((3, 2), np.float32)
    exe = tstatic.Executor(pt.CPUPlace())
    w = _np(prog.param_objs[next(iter(prog.param_objs))]).copy()
    exe.run(test_prog, feed={"x": X}, fetch_list=[loss])   # no step
    np.testing.assert_array_equal(
        _np(prog.param_objs[next(iter(prog.param_objs))]), w)


def test_scope_isolation(static_mode):
    x = tstatic.data("x", [None, 4])
    lin = pt.nn.Linear(4, 1, bias_attr=False)
    out = lin(x)
    exe = tstatic.Executor(pt.CPUPlace())
    X = np.ones((2, 4), np.float32)
    s1, s2 = tstatic.Scope(), tstatic.Scope()
    with tstatic.scope_guard(s1):
        exe.run(feed={"x": X}, fetch_list=[out])
    with tstatic.scope_guard(s2):
        exe.run(feed={"x": X}, fetch_list=[out])
    assert s1.var(lin.weight.name) is not None
    assert s2.var(lin.weight.name) is not None
    assert tstatic.global_scope().var(lin.weight.name) is None


def test_mode_flags(static_mode):
    assert not pt.in_dynamic_mode() and not paddle.in_dynamic_mode()
    pt.disable_static()
    assert pt.in_dynamic_mode()
    pt.enable_static()
    assert tstatic.in_static_mode()


def test_save_load_roundtrip(static_mode, tmp_path):
    x = tstatic.data("x", [None, 4])
    lin = pt.nn.Linear(4, 2)
    lin(x)
    prog = tstatic.default_main_program()
    exe = tstatic.Executor(pt.CPUPlace())
    exe.run(tstatic.default_startup_program())
    path = str(tmp_path / "model")
    tstatic.save(prog, path)
    w0 = _np(lin.weight).copy()
    with torch.no_grad():
        lin.weight.zero_()
    tstatic.global_scope().set(lin.weight.name, np.zeros_like(w0))
    tstatic.load(prog, path)
    np.testing.assert_array_equal(_np(lin.weight), w0)
    assert tstatic.global_scope().var(lin.weight.name) is lin.weight
    # the JAX package reads the port's file the other way round too
    state = tstatic.load_program_state(path)
    np.testing.assert_array_equal(state[lin.weight.name], w0)


def test_static_input_gradients(static_mode):
    jl, tl = _linear_pair(3, 2, bias=False)
    xv = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    res = []
    for st, lin, summ in ((paddle.static, jl, paddle.sum),
                          (tstatic, tl, torch.sum)):
        x = st.data("xg", [4, 3], "float32")
        y = lin(x)
        out = summ(y * y)
        (gx,) = st.gradients([out], [x])
        exe = st.Executor() if st is paddle.static \
            else st.Executor(pt.CPUPlace())
        exe.run(st.default_startup_program())
        res.append(exe.run(feed={"xg": xv}, fetch_list=[out, gx]))
    (jo, jg), (to, tg) = res
    np.testing.assert_allclose(to, jo, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    wv = _np(tl.weight)
    np.testing.assert_allclose(tg, 2 * (xv @ wv) @ wv.T, rtol=1e-4,
                               atol=1e-5)


# -- the Llama as a static program ---------------------------------------------


B, S, STEPS = 2, 16, 3


def _batches(vocab):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, vocab, (B, S)).astype(np.int64),
             rng.randint(0, vocab, (B, S)).astype(np.int64))
            for _ in range(STEPS)]


def _port_static(weights, batches, count=None):
    from paddle_tpu_torch.optimizer import AdamW

    ids = tstatic.data("ids", [B, S], "int64")
    labels = tstatic.data("labels", [B, S], "int64")
    tm = pt.LlamaForCausalLM(pt.llama_config("tiny"), device="cpu")
    pt.load_paddle_params(tm, weights)
    loss = tm(ids, labels)
    AdamW(learning_rate=1e-3).minimize(loss)
    exe = tstatic.Executor(pt.CPUPlace())
    exe.run(tstatic.default_startup_program())
    losses = []
    for a, b in batches:
        if count is not None:
            count.clear()
        (l,) = exe.run(feed={"ids": a, "labels": b}, fetch_list=[loss],
                       return_numpy=False)
        losses.append(l)
    return tm, losses


def test_llama_static_training_matches_the_reference(static_mode):
    from paddle_tpu.optimizer import AdamW as JAdamW

    paddle.seed(0)
    ids = paddle.static.data("ids", [B, S], "int64")
    labels = paddle.static.data("labels", [B, S], "int64")
    jm = JaxLlama(jax_config("tiny"))
    weights = {k: np.asarray(p.value) for k, p in jm.named_parameters()}
    jloss = jm(ids, labels)
    JAdamW(learning_rate=1e-3).minimize(jloss)
    jexe = paddle.static.Executor()
    jexe.run(paddle.static.default_startup_program())
    batches = _batches(256)
    jl = [float(jexe.run(feed={"ids": a.astype(np.int32),
                               "labels": b.astype(np.int32)},
                         fetch_list=[jloss])[0]) for a, b in batches]
    _, tl = _port_static(weights, batches)
    np.testing.assert_allclose([float(t) for t in tl], jl, **LLAMA_TOL)


def _counting(monkeypatch):
    """Count the kernels' calls on the CPU (their plain versions)."""
    calls = {}

    def wrap(mod, name, key):
        real = getattr(mod, name)

        def counted(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    wrap(fused_kernels, "_rms_norm_fwd", "rms_norm")
    wrap(fused_kernels, "_rope_fwd", "fused_rope")
    wrap(fk, "flash_attention_bshd_ref", "flash_fwd")
    wrap(fk, "flash_attention_bwd_ref", "flash_bwd")
    return calls


def test_static_step_is_bitwise_the_eager_step(static_mode, monkeypatch):
    from paddle_tpu_torch.optimizer import AdamW

    tstatic.disable_static()
    torch.manual_seed(0)
    ref = pt.LlamaForCausalLM(pt.llama_config("tiny"), device="cpu",
                              generator=torch.Generator().manual_seed(3))
    weights = {k: _np(v).copy() for k, v in ref.state_dict().items()}
    batches = _batches(256)
    calls = _counting(monkeypatch)
    opt = AdamW(learning_rate=1e-3, parameters=ref.parameters())
    eager_losses, eager_calls = [], []
    for a, b in batches:
        calls.clear()
        loss = ref(torch.from_numpy(a), torch.from_numpy(b))
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager_losses.append(loss.detach())
        eager_calls.append(dict(calls))
    tstatic.enable_static()
    tm, static_losses = _port_static(weights, batches, calls)
    assert dict(calls) == eager_calls[-1]
    assert eager_calls[-1] == {"rms_norm": 5, "fused_rope": 8,
                               "flash_fwd": 2, "flash_bwd": 2}
    for s, e in zip(static_losses, eager_losses):
        assert torch.equal(s, e)
    for (n, p), (_, q) in zip(tm.named_parameters(),
                              ref.named_parameters()):
        assert torch.equal(p, q), n


def test_kernel_node_records_as_one_node(static_mode):
    x = tstatic.data("x", [2, 6, 3, 16])
    w = pt.nn.Parameter(torch.ones(16))
    cos = tstatic.data("cos", [6, 8])
    sin = tstatic.data("sin", [6, 8])
    y = pt.ops.fused_rope(pt.ops.rms_norm(x, w, 1e-6), cos, sin)
    q = tstatic.data("q", [1, 8, 2, 16], "bfloat16")
    o = pt.ops.flash_attention(q, q, q, causal=True)
    prog = tstatic.default_main_program()
    assert [n.name for n in prog.nodes] == ["rms_norm", "fused_rope",
                                            "flash_attention"]
    assert y.is_meta and tuple(y.shape) == (2, 6, 3, 16)
    assert o.is_meta and o.dtype == torch.bfloat16 \
        and tuple(o.shape) == (1, 8, 2, 16)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(2, 6, 3, 16).astype(np.float32),
            "cos": rng.randn(6, 8).astype(np.float32),
            "sin": rng.randn(6, 8).astype(np.float32),
            "q": rng.randn(1, 8, 2, 16).astype(np.float32)}
    got_y, got_o = tstatic.Executor(pt.CPUPlace()).run(
        feed=feed, fetch_list=[y, o], return_numpy=False)
    t = {k: torch.from_numpy(v) for k, v in feed.items()}
    want_y = fused_kernels.fused_rope(
        fused_kernels.rms_norm(t["x"], w.detach(), 1e-6), t["cos"], t["sin"])
    qb = t["q"].to(torch.bfloat16)
    assert torch.equal(got_y, want_y)
    assert torch.equal(got_o, pt.ops.flash_attention(qb, qb, qb,
                                                     causal=True))


def test_recorded_dropout_is_fresh_per_run(static_mode):
    q = tstatic.data("q", [1, 64, 2, 16])
    out, _ = pt.nn.functional.flash_attention(q, q, q, dropout=0.5,
                                              causal=True)
    assert [n.name for n in tstatic.default_main_program().nodes] == \
        ["seed", "flash_attention"]
    exe = tstatic.Executor(pt.CPUPlace())
    feed = {"q": np.random.RandomState(0).randn(1, 64, 2, 16)
            .astype(np.float32)}

    def run():
        return exe.run(feed=feed, fetch_list=[out])[0]

    pt.seed(7)
    a, b = run(), run()
    pt.seed(7)
    c = run()
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, c)


# -- the rest of the surface ---------------------------------------------------


def test_all_names_equal_the_reference():
    assert sorted(tstatic.__all__) == sorted(paddle.static.__all__)
    for name in paddle.static.__all__:
        assert hasattr(tstatic, name), name


def test_inference_model_round_trip(static_mode, tmp_path):
    x = tstatic.data("x", [None, 8])
    lin = pt.nn.Linear(8, 3)
    out = torch.tanh(lin(x))
    exe = tstatic.Executor(pt.CPUPlace())
    path = str(tmp_path / "infer")
    tstatic.save_inference_model(path, [x], [out], exe)
    pred, feeds, fetches = tstatic.load_inference_model(path, exe)
    assert len(feeds) == 1 and fetches == ["out0"]
    for bs in (2, 5):
        X = np.random.RandomState(bs).randn(bs, 8).astype(np.float32)
        (got,) = pred.run([X])
        (want,) = exe.run(feed={"x": X}, fetch_list=[out])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_program_state_round_trips(static_mode, tmp_path):
    x = tstatic.data("x", [None, 4])
    lin = pt.nn.Linear(4, 2)
    out = lin(x)
    prog = tstatic.default_main_program()
    state = tstatic.save_program_state(prog)
    assert set(state) == set(prog.param_vars)
    new = {k: np.full_like(v, 0.25) for k, v in state.items()}
    tstatic.set_program_state(prog, new)
    (o,) = tstatic.Executor(pt.CPUPlace()).run(
        feed={"x": np.ones((1, 4), np.float32)}, fetch_list=[out])
    np.testing.assert_allclose(o, np.full((1, 2), 1.25), rtol=1e-6)
    blob = tstatic.serialize_persistables([x], [out], prog)
    tstatic.set_program_state(prog, state)
    tstatic.deserialize_persistables(prog, blob)
    np.testing.assert_array_equal(_np(lin.weight), new[lin.weight.name])
    desc = tstatic.deserialize_program(tstatic.serialize_program([x], [out]))
    assert desc["nodes"] == 1 and desc["ops"] == ["linear"]
    tstatic.save_to_file(str(tmp_path / "p.bin"), blob)
    assert tstatic.load_from_file(str(tmp_path / "p.bin")) == blob


def test_py_func_and_print_run_in_the_program(static_mode, capsys):
    x = tstatic.data("x", [2, 3])
    like = tstatic.create_global_var([2, 3], 0.0, "float32")
    y = tstatic.py_func(lambda a: np.sin(a), x, like,
                        backward_func=lambda a, g: g * np.cos(a))
    z = tstatic.Print(y * 2.0, message="z:")
    X = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    (got,) = tstatic.Executor(pt.CPUPlace()).run(feed={"x": X},
                                                  fetch_list=[z])
    np.testing.assert_allclose(got, 2 * np.sin(X), rtol=1e-6)
    assert "z:" in capsys.readouterr().out


def test_metrics_equal_the_reference(static_mode):
    rng = np.random.RandomState(0)
    logits = rng.randn(16, 5).astype(np.float32)
    label = rng.randint(0, 5, (16, 1)).astype(np.int64)
    probs = rng.rand(64, 2).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    blab = rng.randint(0, 2, (64, 1)).astype(np.int64)
    j = [paddle.static.data(n, s, d) for n, s, d in
         (("lg", [16, 5], "float32"), ("lb", [16, 1], "int32"),
          ("pr", [64, 2], "float32"), ("bl", [64, 1], "int32"))]
    t = [tstatic.data(n, s, d) for n, s, d in
         (("lg", [16, 5], "float32"), ("lb", [16, 1], "int64"),
          ("pr", [64, 2], "float32"), ("bl", [64, 1], "int64"))]
    outs = []
    for st, (lg, lb, pr, bl) in ((paddle.static, j), (tstatic, t)):
        acc = st.accuracy(lg, lb, k=2)
        auc, _, _ = st.auc(pr, bl, num_thresholds=255)
        bundle = st.ctr_metric_bundle(pr, bl)
        exe = st.Executor() if st is paddle.static \
            else st.Executor(pt.CPUPlace())
        feed = {"lg": logits, "lb": label, "pr": probs, "bl": blab}
        if st is paddle.static:
            feed = {k: v.astype(np.int32) if v.dtype == np.int64 else v
                    for k, v in feed.items()}
        outs.append(exe.run(feed=feed, fetch_list=[acc, auc, *bundle]))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_exponential_decay_and_ema_equal_the_reference(static_mode):
    jd = paddle.static.exponential_decay(0.1, 3, 0.5, staircase=True)
    td = tstatic.exponential_decay(0.1, 3, 0.5, staircase=True)
    for _ in range(7):
        assert td() == pytest.approx(jd(), rel=1e-12)
        jd.step()
        td.step()
    jl, tl = _linear_pair(3, 2)
    jema = paddle.static.ExponentialMovingAverage(0.9)
    tema = tstatic.ExponentialMovingAverage(0.9)
    for k in range(3):
        for (jp, tp) in ((jl.weight, tl.weight), (jl.bias, tl.bias)):
            v = np.full(tuple(tp.shape), float(k), np.float32)
            jp.set_value(v)
            with torch.no_grad():
                tp.copy_(torch.from_numpy(v))
        jema.update([jl.weight, jl.bias])
        tema.update([tl.weight, tl.bias])
    with tema.apply(), jema.apply():
        np.testing.assert_allclose(_np(tl.weight),
                                   np.asarray(jl.weight.value), rtol=1e-6)
    np.testing.assert_array_equal(_np(tl.weight), np.full((3, 2), 2.0))


def test_executor_follows_its_place(monkeypatch):
    """``Executor(place)`` runs on ``place``; without one it takes the
    current place, the CUDA card unless ``set_device("cpu")``, and raises
    where CUDA is missing (no fallback to the CPU)."""
    from paddle_tpu_torch.core import place

    assert tstatic.Executor(pt.CPUPlace()).device == torch.device("cpu")
    assert tstatic.Executor().device == torch.device("cpu")  # set_device
    monkeypatch.setattr(place, "_current", [None])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstatic.Executor()
