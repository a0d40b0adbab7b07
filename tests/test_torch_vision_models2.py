"""paddle_tpu_torch's ``classic2`` models, ``summary`` and ``flops``
against paddle_tpu's, on the CPU.

- Structure: every model function of the reference's ``classic2.py`` has
  the reference's ``state_dict`` keys in order, shapes and parameter count
  (both sides built with empty initial values: the check reads names and
  shapes only).
- Every model function but the DenseNets (``test_torch_vision_densenet.py``
  holds those: the reference's jitted DenseNets take most of a minute to
  compile) in eval mode at a small input (InceptionV3 at 75 x 75, its
  smallest; the rest at 2 x 3 x 32 x 32, 10 classes): the port's model
  with random weights and random BatchNorm statistics, those carried into
  the reference's, the logits held by ``near()`` against the port's fp64
  twin (the JAX forward runs as one ``jax.jit`` program).
- DenseNet-121, MobileNetV3-Small and ShuffleNetV2 x0.25 in training mode
  at 4 x 3 x 64 x 64 (``training_step_matches``, run by
  ``test_torch_vision_train.py``): the cross-entropy loss and the
  gradients of the input and every parameter, both sides in float64,
  within 1e-8 of each gradient's largest magnitude (its docstring says
  why float64).
- ``summary`` and ``flops`` of ResNet-18 and MobileNetV3-Small: the
  totals equal the reference's (with ``custom_ops`` for flops, and the
  table's rows), on the net's device.

Tolerances: ``near()`` of ``test_torch_vision_models.py`` (each side at
most 3 times as far from the port's fp64 twin as the other, plus 1e-6 of
its largest magnitude).
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
import torch_nn_cases as C
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import initializer as j_init
from paddle_tpu.nn.functional_call import substituted_state
from paddle_tpu.vision.models import classic2 as JM
from paddle_tpu_torch.nn import initializer as t_init
from paddle_tpu_torch.vision.models import classic2 as TM
from test_torch_vision_models import near
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

MODEL_FNS = [n for n in JM.__all__ if n[0].islower()]
DENSENETS = [n for n in MODEL_FNS if n.startswith("densenet")]


def test_every_name_is_ported():
    assert sorted(TM.__all__) == sorted(JM.__all__)
    for n in TM.__all__:
        assert hasattr(pt.vision.models, n), n
    assert len(MODEL_FNS) == 16


@contextlib.contextmanager
def jax_zero_init(dtype=np.float32):
    """The reference's initializers give numpy zeros (its random draws cost
    seconds a model, and the weights are carried in from the port)."""
    prev = j_init.Initializer.__call__
    j_init.Initializer.__call__ = (
        lambda self, shape, dtype_=None, key=None: np.zeros(
            tuple(int(s) for s in shape), dtype))
    try:
        yield
    finally:
        j_init.Initializer.__call__ = prev


@pytest.mark.parametrize("name", MODEL_FNS)
def test_model_state_dict_matches_reference(monkeypatch, name):
    monkeypatch.setattr(t_init.Initializer, "__call__",
                        lambda self, shape, dtype=None, generator=None,
                        device=None: torch.empty(tuple(int(s)
                                                       for s in shape)))
    with jax_zero_init():
        jm = getattr(JM, name)()
    tm = getattr(TM, name)()
    want = [(k, tuple(v.shape)) for k, v in jm.state_dict().items()]
    got = [(k, tuple(v.shape)) for k, v in tm.state_dict().items()]
    assert got == want
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(p.shape)) for p in jm.parameters())


def randomize_stats(model, seed):
    """Random BatchNorm running statistics (mean ~ 0.1 N(0, 1), variance in
    [0.5, 1.5]), so eval mode normalizes by something other than 0 / 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("_mean"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.1)
            elif k.endswith("_variance"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)


def pair(name, seed, **kw):
    """The port's model (random weights from ``seed``) and the reference's
    with those weights carried in."""
    pt.seed(seed)
    tm = getattr(TM, name)(**kw)
    randomize_stats(tm, seed)
    with jax_zero_init():
        jm = getattr(JM, name)(**kw)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    assert jm.set_state_dict(sd) == ([], [])
    return jm, tm


def jax_eval(jm, x):
    """The reference model's eval-mode forward as one jitted program."""
    names = [k for k, _ in jm.named_parameters()]

    def fwd(pv, xv):
        with no_grad(), substituted_state(jm, dict(zip(names, pv))):
            return jm(Tensor(xv)).value

    return np.asarray(jax.jit(fwd)([p.value for _, p in
                                    jm.named_parameters()], jnp.asarray(x)))


def eval_matches(name, size, seed):
    jm, tm = pair(name, seed, num_classes=10)
    jm.eval()
    tm.eval()
    t64 = copy.deepcopy(tm).double()
    x = np.random.RandomState(seed).randn(2, 3, size, size).astype(
        np.float32)
    want = jax_eval(jm, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        ex = t64(torch.from_numpy(x).double()).numpy()
    assert got.shape == (2, 10)
    near(got, want, ex, f"{name} logits")


@pytest.mark.parametrize("name", [n for n in MODEL_FNS
                                  if n not in DENSENETS])
def test_model_eval_matches_reference(name):
    eval_matches(name, 75 if name == "inception_v3" else 32,
                 MODEL_FNS.index(name))


def test_googlenet_training_outputs_and_heads():
    tm = TM.googlenet(num_classes=10)
    out = tm(torch.randn(2, 3, 64, 64))
    assert isinstance(out, tuple) and [tuple(o.shape) for o in out] == [
        (2, 10)] * 3
    tm.eval()
    assert tuple(tm(torch.randn(2, 3, 64, 64)).shape) == (2, 10)
    m = TM.GoogLeNet(num_classes=0, with_pool=False)
    assert not hasattr(m, "fc") and not hasattr(m, "aux1")
    assert tuple(m(torch.randn(1, 3, 64, 64)).shape) == (1, 1024, 2, 2)
    m = TM.InceptionV3(num_classes=0)
    assert tuple(m(torch.randn(1, 3, 75, 75)).shape) == (1, 2048, 1, 1)


def test_channel_shuffle_order():
    x = torch.arange(2 * 6 * 1 * 1.0).reshape(2, 6, 1, 1)
    got = TM._channel_shuffle(x, 2)[0, :, 0, 0].tolist()
    assert got == [0, 3, 1, 4, 2, 5]
    want = C._np(JM._channel_shuffle(paddle_tpu.to_tensor(x.numpy()), 2))
    np.testing.assert_array_equal(TM._channel_shuffle(x, 3).numpy(),
                                  C._np(JM._channel_shuffle(
                                      paddle_tpu.to_tensor(x.numpy()), 3)))
    np.testing.assert_array_equal(TM._channel_shuffle(x, 2).numpy(), want)


# the training steps run in test_torch_vision_train.py
TRAIN = ["densenet121", "mobilenet_v3_small", "shufflenet_v2_x0_25"]
GRAD_F64_REL = 1e-8


@contextlib.contextmanager
def jax_float64():
    """The reference in float64: jax's x64 mode and float64 parameters."""
    jax.config.update("jax_enable_x64", True)
    paddle_tpu.set_default_dtype("float64")
    try:
        yield
    finally:
        paddle_tpu.set_default_dtype("float32")
        jax.config.update("jax_enable_x64", False)


def no_dropout(model):
    """Dropout's masks come from each side's own generator: identity."""
    for sub in model.sublayers():
        if type(sub).__name__ == "Dropout":
            sub.eval()
    return model


def jax_train(jm, x, y):
    """The reference's training-mode cross entropy of ``jm`` on ``(x,
    y)`` and its gradients in the input and every parameter (by name), as
    one jitted program."""
    names = [k for k, _ in jm.named_parameters()]
    labels = jnp.asarray(y)

    def loss(pv, xv):
        with no_grad(), substituted_state(jm, dict(zip(names, pv))):
            return paddle_tpu.nn.CrossEntropyLoss()(
                jm(Tensor(xv)), Tensor(labels)).value

    pv = [p.value for _, p in jm.named_parameters()]
    val, (pg, xg) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        pv, jnp.asarray(x))
    return float(val), np.asarray(xg), {k: np.asarray(g)
                                        for k, g in zip(names, pg)}


def port_train(model, x, y):
    xs = torch.from_numpy(x).requires_grad_()
    loss = pt.nn.CrossEntropyLoss()(model(xs), torch.from_numpy(y))
    loss.backward()
    return (float(loss.detach()), xs.grad.numpy(),
            {k: p.grad.numpy() for k, p in model.named_parameters()})


def training_step_matches(name):
    """Training mode (batch statistics; dropout held at identity), both
    sides in float64: the loss and every gradient within GRAD_F64_REL of
    the tensor's largest magnitude (floored at 1e-4 of the largest of all:
    a bias ahead of a batch norm has a gradient of exactly 0, which each
    side computes as rounding noise). In fp32 a unit whose pre-activation
    lies within a rounding of 0 takes either side of the ReLU, and each
    side flips its own few units: against an fp64 twin by ``near()`` those
    flips read as 1-25% of a gradient on one side and nothing on the
    other (DenseNet-121's transition batch norms, on the port's side, at
    this seed). In float64 no unit lies that close. The fp32 forwards are
    held in eval mode above."""
    seed = MODEL_FNS.index(name)
    pt.seed(seed)
    tm = no_dropout(getattr(TM, name)(num_classes=10)).double()
    randomize_stats(tm, seed)
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 3, 64, 64)
    y = rng.randint(0, 10, (4,)).astype(np.int64)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    with jax_float64():
        with jax_zero_init(np.float64):
            jm = no_dropout(getattr(JM, name)(num_classes=10))
        assert jm.set_state_dict(sd) == ([], [])
        assert jm.parameters()[0].dtype == jnp.float64
        want, wxg, wgrads = jax_train(jm, x, y)
    loss, xg, grads = port_train(tm, x, y)
    assert abs(loss - want) <= GRAD_F64_REL * abs(want)
    assert set(grads) == set(wgrads) == {k for k, _ in tm.named_parameters()}
    pairs = [("input", xg, wxg)] + [(k, grads[k], wgrads[k])
                                    for k in wgrads]
    top = max(float(np.abs(w).max()) for _, _, w in pairs)
    for k, g, w in pairs:
        assert g.dtype == w.dtype == np.float64, k
        scale = max(float(np.abs(w).max()), 1e-4 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_F64_REL * scale,
                                   err_msg=k)


def _abstract(fn):
    """Run ``fn`` of the reference where its ops are only traced (shapes,
    no values): summary's and flops' counts read shapes alone."""
    box = []
    jax.make_jaxpr(lambda: box.append(fn()) or jnp.zeros(()))()
    return box[0]


def _relu_ops(layer, inp, out):
    return 7


@pytest.mark.parametrize("name", ["resnet18", "mobilenet_v3_small"])
def test_summary_and_flops_match_reference(name, capsys):
    from paddle_tpu.vision import models as JV

    tm = getattr(pt.vision.models, name)()
    with jax_zero_init():
        jm = getattr(JV, name)()
    size = (1, 3, 64, 64)
    want = _abstract(lambda: paddle_tpu.summary(jm, size))
    jtable = capsys.readouterr().out
    got = pt.summary(tm, size)
    table = capsys.readouterr().out
    assert got == want
    assert got["total_params"] == sum(p.numel() for p in tm.parameters())
    assert table == jtable and len(table.splitlines()) > 20
    assert _abstract(lambda: paddle_tpu.flops(jm, list(size))) == pt.flops(
        tm, list(size)) > 0
    custom = _abstract(lambda: paddle_tpu.flops(
        jm, [1, 3, 64, 64], custom_ops={paddle_tpu.nn.ReLU: _relu_ops},
        print_detail=True))
    capsys.readouterr()
    assert pt.flops(tm, [-1, 3, 64, 64], custom_ops={pt.nn.ReLU: _relu_ops},
                    print_detail=True) == custom
    assert "Total FLOPs" in capsys.readouterr().out
    # an explicit input instead of a size
    x = torch.zeros(size)
    assert pt.flops(tm, inputs=x) == pt.flops(tm, list(size))
    assert pt.summary(tm, input=x) == got
