"""paddle_tpu_torch.jit against paddle_tpu.jit: ``to_static`` with the
dy2static pass, on the CPU.

- Every case of ``tests/test_dy2static.py`` runs through both packages'
  ``to_static`` on the same inputs: the same outputs, the same
  ``RuntimeError`` naming "Supported rewrites" where the JAX package
  raises, the same plain-Python semantics of the converted functions.
- ``to_static`` of a 2-layer tiny Llama (full recompute) and of a
  BatchNorm layer, on weights carried from the JAX models: outputs,
  parameter gradients through the compiled forward and the running
  statistics after a training call, against the JAX package's
  ``to_static``; the compiled Llama step's kernel calls equal the eager
  step's (each kernel's plain version counted), one compile, no
  recompile.
- Dropout under ``to_static``: the masks repeat under ``seed``, are fresh
  on every call, keep about 1 - p, and compile once.
- ``StaticFunction.code``, ``enable_to_static(False)``, ``not_to_static``
  and the "CINN" backend's ``ValueError``.

The port compiles with ``backend="aot_eager"`` (AOT autograd without
inductor's C++ code generation: seconds a program on the CPU instead of
half a minute); the card's programs use inductor.

Tolerances: the control-flow cases compute a few float32 ops of small
integers and compare exactly (rtol 1e-6). The Llama and BatchNorm cases run
float32 on both sides (the JAX side at matmul precision "highest"): atol =
rtol = 1e-5 on outputs and the running statistics, as
``tests/test_torch_llama.py`` holds the forward; 1e-4 on parameter
gradients, which sum over the batch and the sequence.
"""
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import torch_nn_cases as C
from paddle_tpu.jit import to_static as jax_to_static
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_config
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import load_paddle_params
from paddle_tpu_torch.jit.dy2static import convert_to_static
from paddle_tpu_torch.ops import fused_kernels, flash_attention_kernel
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

BACKEND = "aot_eager"
EXACT = dict(rtol=1e-6, atol=0)
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _j(x):
    return paddle.to_tensor(np.asarray(x, np.float32))


def _np(x):
    return np.asarray(getattr(x, "value", x)) if not isinstance(
        x, torch.Tensor) else x.detach().numpy()


# the cases below name the package they run on ``P``; ``_on`` binds it.
# They are module-level functions (no closure), as dy2static rewrites
# only functions whose source it can rebuild without cells.
P = pt


_MODULES = {}


def _on(pkg, fn):
    """``fn`` with ``P`` bound to ``pkg``: its globals are those of a module
    of its own (registered, as the compiler finds a function's globals
    through its module)."""
    name = f"{__name__}_on_{pkg.__name__}"
    mod = _MODULES.get(name)
    if mod is None:
        mod = _MODULES[name] = types.ModuleType(name)
        mod.__dict__.update({k: v for k, v in globals().items()
                             if not k.startswith("__")})
        mod.P = pkg
        sys.modules[name] = mod
    return types.FunctionType(fn.__code__, mod.__dict__, fn.__name__)


def _both(fn):
    """(the JAX package's to_static of ``fn`` on ``paddle``, the port's on
    ``pt``)."""
    return (jax_to_static(_on(paddle, fn)),
            tjit.to_static(_on(pt, fn), backend=BACKEND))


# -- the control-flow cases of tests/test_dy2static.py --------------------------


def _ifelse(x):
    if P.sum(x) > 0:
        y = x * 2
    else:
        y = x - 10
    return y


def _update_existing(x):
    y = x + 1
    if P.max(x) > 3:
        y = y * 10
    return y


def _nested(x):
    if P.sum(x) > 0:
        if P.max(x) > 10:
            y = x * 100
        else:
            y = x * 2
    else:
        y = x * 0
    return y


def _trip_count(x):
    s = P.zeros([1])
    while P.sum(s) < P.sum(x):
        s = s + 1.0
    return s


def _carried(n):
    i = P.zeros([])
    acc = P.zeros([])
    while i < n:
        acc = acc + i
        i = i + 1
    return acc


def _logical(x):
    i = P.zeros([])
    while (i < 10) and (i < x):
        i = i + 1
    return i


@pytest.mark.parametrize("make,inputs", [
    (_ifelse, ([1.0, 2.0], [-5.0, 2.0])),
    (_update_existing, ([5.0], [1.0])),
    (_nested, ([20.0], [1.0], [-1.0])),
    (_trip_count, ([7.3], [2.0])),
    (_carried, (5.0,)),
    (_logical, (4.0, 99.0)),
], ids=["ifelse", "update_existing", "nested_if", "tensor_trip_count",
        "carried_vars", "logical_ops"])
def test_control_flow_matches_jax(make, inputs):
    jf, tf = _both(make)
    for x in inputs:
        np.testing.assert_allclose(_np(tf(_t(x))), _np(jf(_j(x))), **EXACT)
    assert tf.compiles == 1          # one program for every predicate


def _python_flag(x, flag):
    if flag:                       # a Python bool: no torch.cond
        return x * 2
    return x


def test_python_predicate_keeps_python_semantics():
    jf, tf = _both(_python_flag)
    np.testing.assert_allclose(_np(tf(_t([3.0]), True)),
                               _np(jf(_j([3.0]), True)), **EXACT)
    # the other flag is another program here (the compiler guards on the
    # bool); the JAX package's cache key leaves Python scalars out and
    # reuses the first program (ROADMAP C-ref-5), so only the port is
    # held to Python's answer
    np.testing.assert_allclose(_np(tf(_t([3.0]), False)), [3.0], **EXACT)


def _break_in_while(x):
    i = P.zeros([])
    while i < P.sum(x):
        i = i + 1
        if float(i) > 3:        # concretizes mid-trace
            break
    return i


def _bool_outside_if(x):
    flags = [bool(v > 0) for v in [P.sum(x)]]
    return x if flags[0] else -x


@pytest.mark.parametrize("make", [_break_in_while, _bool_outside_if],
                         ids=["break_in_tensor_while", "tensor_bool"])
def test_unconvertible_patterns_raise_like_jax(make):
    jf, tf = _both(make)
    with pytest.raises(RuntimeError, match="Supported rewrites"):
        jf(_j([10.0]))
    with pytest.raises(RuntimeError, match="Supported rewrites") as ei:
        tf(_t([10.0]))
    assert "dy2static" in str(ei.value)


def test_runtime_converters_concrete():
    from paddle_tpu_torch.jit.dy2static import (convert_ifelse,
                                                convert_while)

    assert convert_ifelse(True, lambda a: a + 1, lambda a: a - 1, (5,)) == 6
    assert convert_while(lambda i: i < 3, lambda i: (i + 1,), (0,)) == (3,)
    assert convert_to_static(len) is len     # no source: unchanged


def _asymmetric(flag, x):
    if flag:
        msg = x + 1  # noqa: F841
    return x


def _loop_born(n):
    i = 0
    while i < n:
        out = i * 2
        i = i + 1
    return out


def _use_before_assign(flag):
    if flag:
        v = 1
    return v + 1


def test_concrete_semantics_preserved():
    from paddle_tpu.jit.dy2static import convert_to_static as jconv

    for conv in (jconv, convert_to_static):
        g = conv(_asymmetric)
        assert g(False, 3) == 3 and g(True, 3) == 3
        assert conv(_loop_born)(3) == 4
        u = conv(_use_before_assign)
        assert u(True) == 2
        with pytest.raises(UnboundLocalError, match="'v'"):
            u(False)


# -- gradients through torch.cond, against the JAX tape ------------------------


def _cond_forward(self, x):
    h = self.fc(x)
    if P.sum(h) > 0:
        out = h * 3
    else:
        out = h * 5
    return P.sum(out)


def _cond_layer(pkg, nn):
    class M(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4)

    M.forward = _on(pkg, _cond_forward)
    return M()


def test_grad_through_cond_matches_jax():
    jm, tm = _cond_layer(paddle, jnn), _cond_layer(pt, tnn)
    C.carry(jm, tm)
    jm, tm = jax_to_static(jm), tjit.to_static(tm, backend=BACKEND)
    for x in (np.ones((2, 4)), -np.ones((2, 4))):
        jm.fc.clear_gradients()
        tm.fc.weight.grad = tm.fc.bias.grad = None
        jl, tl = jm(_j(x)), tm(_t(x))
        jl.backward()
        tl.backward()
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_allclose(tm.fc.weight.grad.numpy(),
                                   _np(jm.fc.weight.grad), **GRAD_TOL)


# -- a tiny Llama and BatchNorm under to_static ---------------------------------


def _plain_calls(monkeypatch):
    """Count the kernels' plain versions as the card counts launches: K1
    and K2 (forward and K2's backward) a call each, K3 a forward, K5 and K6
    a backward each (the eager backward computes both in one plain call,
    the compiled one calls each op's own)."""
    calls = {"rms_norm": 0, "fused_rope": 0, "flash_fwd": 0,
             "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def counted(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    spy(fused_kernels, "rms_norm_ref", "rms_norm")
    spy(fused_kernels, "fused_rope_ref", "fused_rope")
    spy(flash_attention_kernel, "flash_attention_bshd_ref", "flash_fwd")
    real_bwd = flash_attention_kernel._bwd_ref

    def bwd(*a, want_dq=True, want_dkv=True):
        calls["flash_bwd_dq"] += int(want_dq)
        calls["flash_bwd_dkv"] += int(want_dkv)
        return real_bwd(*a, want_dq=want_dq, want_dkv=want_dkv)
    monkeypatch.setattr(flash_attention_kernel, "_bwd_ref", bwd)
    return calls


def test_llama_to_static_matches_jax_and_eager(monkeypatch):
    L = 2
    paddle.seed(3)
    jcfg = jax_config("tiny", num_hidden_layers=L, recompute="full")
    jm = JaxLlama(jcfg)
    tm = pt.LlamaForCausalLM(pt.llama_config(
        "tiny", num_hidden_layers=L, recompute="full"), device="cpu")
    load_paddle_params(tm, {k: np.asarray(p.value)
                            for k, p in jm.named_parameters()})
    rng = np.random.RandomState(5)
    ids = rng.randint(0, jcfg.vocab_size, (2, 12)).astype(np.int64)
    labels = rng.randint(0, jcfg.vocab_size, (2, 12)).astype(np.int64)

    # eager port step: its plain-version calls and gradients
    calls = _plain_calls(monkeypatch)
    loss_e = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    loss_e.backward()
    eager_calls = dict(calls)
    eager_grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    tm.zero_grad()
    assert eager_calls == {"rms_norm": 4 * L + 1, "fused_rope": 6 * L,
                           "flash_fwd": 2 * L, "flash_bwd_dq": L,
                           "flash_bwd_dkv": L}

    # the JAX package's to_static step
    js = jax_to_static(jm)
    jl = js(paddle.Tensor(ids.astype(np.int32)),
            paddle.Tensor(labels.astype(np.int32)))
    jl.backward()
    jgrads = {k: _np(p.grad) for k, p in jm.named_parameters()}

    ts = tjit.to_static(tm, backend=BACKEND)
    for step in range(2):
        for k in calls:
            calls[k] = 0
        tl = ts(torch.from_numpy(ids), torch.from_numpy(labels))
        tl.backward()
        assert calls == eager_calls, (step, calls)
        np.testing.assert_allclose(tl.item(), float(_np(jl)), **TOL)
        np.testing.assert_allclose(tl.item(), loss_e.item(), **TOL)
        for k, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), jgrads[k],
                                       err_msg=k, **GRAD_TOL)
            np.testing.assert_allclose(p.grad.numpy(),
                                       eager_grads[k].numpy(), err_msg=k,
                                       **GRAD_TOL)
        tm.zero_grad()
    assert ts.forward.compiles == 1      # no recompile on the second step
    tm.eval()
    with torch.no_grad():
        logits = ts(torch.from_numpy(ids))
    jm.eval()
    np.testing.assert_allclose(logits.numpy(),
                               _np(jm(paddle.Tensor(ids.astype(np.int32)))),
                               **TOL)
    assert ts.forward.compiles == 2      # eval is its own program


def test_batchnorm_to_static_buffers_match_jax():
    def make(nn):
        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.conv = nn.Conv2D(3, 4, 3, padding=1)
                self.bn = nn.BatchNorm2D(4)

            def forward(self, x):
                return self.bn(self.conv(x)).sum()
        return Net()

    jm, tm = make(jnn), make(tnn)
    C.carry(jm, tm)
    jm, tm = jax_to_static(jm), tjit.to_static(tm, backend=BACKEND)
    x = np.random.RandomState(2).randn(2, 3, 5, 5).astype(np.float32)
    for _ in range(2):
        jl, tl = jm(_j(x)), tm(_t(x))
        jl.backward()
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(_np(jl)), **TOL)
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(tm.bn, name).numpy(),
                                   _np(getattr(jm.bn, name)), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(tm.conv.weight.grad.numpy(),
                               _np(jm.conv.weight.grad), **GRAD_TOL)


# -- random draws ------------------------------------------------------------------


def test_dropout_reproducible_fresh_and_at_rate():
    class D(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tnn.Linear(64, 64)

        def forward(self, x):
            return tnn.functional.dropout(self.fc(x), 0.25)

    d = tjit.to_static(D(), backend=BACKEND)
    x = torch.ones(16, 64)
    pt.seed(7)
    a, b = d(x), d(x)
    pt.seed(7)
    a2 = d(x)
    assert torch.equal(a, a2)                 # repeats under seed
    assert not torch.equal(a == 0, b == 0)    # fresh on every call
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.05, kept      # 1024 draws: 4 sigma ~ 0.054
    assert d.forward.compiles == 1            # no recompile per seed


def _flash_dropout(q, k, v):
    return pt.nn.functional.flash_attention(q, k, v, dropout=0.25,
                                            causal=True)[0]


def _flash_dropout_ref(q, k, v):
    return paddle.nn.functional.flash_attention(q, k, v, dropout=0.25,
                                                causal=True)[0]


def _causal_kept(out):
    """The kept share of the causal positions of ``out`` = P_drop (v the
    identity over the keys)."""
    s = out.shape[1]
    causal = np.tril(np.ones((s, s), bool))[None, :, None, :]
    causal = np.broadcast_to(causal, out.shape)
    return float((out[causal] != 0).mean())


def test_flash_dropout_compiles_fresh_and_at_rate():
    """C-port-7: the flash kernels' dropout seed is a value of the compiled
    program (from the seed to_static hands each call), not a constant
    frozen into it. With v the identity over the 64 keys the output is
    P_drop itself: masks repeat under seed, differ from call to call, and
    dv = P_drop^T dO shows the backward ops regenerate the forward's mask.
    The JAX package's to_static of the same function keeps the same share
    (threefry is not Philox: distributions, not masks)."""
    rng = np.random.RandomState(0)
    q = rng.randn(1, 64, 2, 64).astype(np.float32)
    k = rng.randn(1, 64, 2, 64).astype(np.float32)
    eye = np.broadcast_to(np.eye(64, dtype=np.float32)[None, :, None, :],
                          (1, 64, 2, 64)).copy()
    g = rng.randn(1, 64, 2, 64).astype(np.float32)
    f = tjit.to_static(_flash_dropout, backend=BACKEND)

    def call():
        v = torch.from_numpy(eye).requires_grad_(True)
        out = f(torch.from_numpy(q), torch.from_numpy(k), v)
        out.backward(torch.from_numpy(g))
        return out.detach(), v.grad

    pt.seed(11)
    (a, dva), (b, _) = call(), call()
    pt.seed(11)
    a2, _ = call()
    assert torch.equal(a, a2)                       # repeats under seed
    assert not torch.equal(a == 0, b == 0)          # fresh on every call
    want = torch.einsum("bqhk,bqhd->bkhd", a, torch.from_numpy(g))
    torch.testing.assert_close(dva, want, rtol=1e-5, atol=1e-5)
    assert f.compiles == 1                          # no recompile per seed
    kept = [_causal_kept(x.numpy()) for x in (a, b)]
    jf = jax_to_static(_flash_dropout_ref)
    paddle.seed(11)
    ref = [_causal_kept(_np(jf(_j(q), _j(k), _j(eye)))) for _ in range(2)]
    # 2 x 2080 causal draws a call: 4 sigma of the kept share is ~0.038
    for share in kept + ref:
        assert abs(share - 0.75) < 0.04, (kept, ref)


# -- the rest of the surface ----------------------------------------------------------


def test_code_enable_and_not_to_static():
    f = tjit.to_static(_on(pt, _ifelse), backend=BACKEND)
    assert "convert_ifelse" in f.code and "def _ifelse(x)" in f.code
    tjit.enable_to_static(False)
    try:
        out = f(_t([1.0, 2.0]))           # the raw, unconverted function
        assert f.compiles == 0
    finally:
        tjit.enable_to_static(True)
    np.testing.assert_allclose(out.numpy(), [2.0, 4.0])

    @tjit.not_to_static
    def g(x):
        if x > 0:
            return 1
        return 2

    assert convert_to_static(g) is g
    with pytest.raises(ValueError, match="CINN"):
        tjit.to_static(_on(pt, _ifelse), backend="CINN")
    assert pt.device.is_compiled_with_cinn() is True
    assert tjit.ignore_module([np]) == ["numpy"]
