"""paddle_tpu_torch's ``vision.models`` against paddle_tpu's, on the CPU.

- Structure: every ResNet model function of the reference's ``resnet.py``
  (ResNeXt and wide ResNet included) and every model function of ``classic.py``
  (VGG with and without ``batch_norm``) has the reference's
  ``state_dict`` keys in the reference's order, the same shapes and the
  same parameter count (ResNet-50: 25,557,032 at 1000 classes). The
  models for this check are built with both packages' initializers
  replaced by empty values (the random draws cost seconds a model on the
  CPU and the check reads only names and shapes); the numeric tests below
  build with the real ones.
- ResNet-18 at 2 x 3 x 32 x 32, its weights and BatchNorm statistics
  carried across: logits, the cross-entropy loss, the input gradient and
  every parameter gradient in training mode, the updated running means
  and variances of every BatchNorm, and every parameter after one
  ``Momentum`` step (lr 0.1, momentum 0.9, ``L2Decay(1e-4)``).
- A ``BottleneckBlock`` with a strided downsample and one with groups and
  a base width (ResNeXt's), against the JAX blocks the same way.
- LeNet (2 x 1 x 28 x 28) and MobileNetV1 / V2 at scale 0.25 (2 x 3 x
  64 x 64) in eval mode, and SqueezeNet's Fire module: outputs and
  gradients. (The whole SqueezeNet at random initialization ends in
  logits of order 1e-7, all signal lost on the way in both packages, so
  its numbers would hold only rounding noise; its structure is held
  above and its forward on the card in ``chip_smoke.py``.)

The JAX ResNet-50 is not run end to end here (its eager forward and
backward alone take tens of seconds on the CPU); the card's phase of
``chip_smoke.py`` holds ResNet-50 against the CPU.

Tolerances: an fp64 twin of the port's model (the same weights, run in
float64) is the yardstick. Each compared tensor of the port is at most 3
times as far from the yardstick as the reference's is (max norm), and the
reference's at most 3 times as far as the port's, each plus 1e-6 of the
yardstick's largest magnitude. The second bound is what holds the port
against the reference: a fault of the port's model is also in its fp64
twin, so it leaves the port near the yardstick and moves the reference
away from it. A fixed fp32 tolerance does
not fit these models: in training mode ResNet-18's last stage normalizes
2 values a channel (1 x 1 spatial at a batch of 2), which turns fp32
roundings into errors of up to 3e-2 of the input gradient's top on both
sides alike (measured against fp64: the port 0.96, the reference 1.04, at
a top of 33.6; the largest ratio of the two over all gradients and
statistics 1.5). The loss of each side is within twice that side's
largest logit error of the fp64 loss, plus 1e-6 of it: a mean cross
entropy moves by at most twice its largest logit error.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
import torch_nn_cases as C
from paddle_tpu.nn import initializer as j_init
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.nn import initializer as t_init
from paddle_tpu_torch.vision import models as TM
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

RESNETS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext101_32x8d", "resnext152_32x4d",
           "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2"]
CLASSIC = [("LeNet", {}), ("alexnet", {}), ("vgg11", {}),
           ("vgg13", {}), ("vgg16", {}), ("vgg19", {}),
           ("vgg11", {"batch_norm": True}), ("vgg19", {"batch_norm": True}),
           ("mobilenet_v1", {}), ("mobilenet_v2", {}),
           ("mobilenet_v1", {"scale": 0.5}), ("mobilenet_v2", {"scale": 0.5}),
           ("squeezenet1_0", {}), ("squeezenet1_1", {})]
FACTOR, FLOOR = 3.0, 1e-6


def near(got, ref, exact, what):
    """``got`` (the port, fp32) and ``ref`` (the reference) are each at
    most FACTOR times as far from ``exact`` (the port's fp64 twin) as the
    other is, plus FLOOR of ``exact``'s largest magnitude. Returns the two
    distances."""
    got, ref, exact = (np.asarray(a, np.float64) for a in (got, ref, exact))
    assert got.shape == ref.shape == exact.shape, what
    e_got = float(np.abs(got - exact).max())
    e_ref = float(np.abs(ref - exact).max())
    scale = max(float(np.abs(exact).max()), 1e-30)
    assert e_got <= FACTOR * e_ref + FLOOR * scale, (what, e_got, e_ref,
                                                     scale)
    assert e_ref <= FACTOR * e_got + FLOOR * scale, (what, e_got, e_ref,
                                                     scale)
    return e_got, e_ref


def _twin(layer):
    return copy.deepcopy(layer).double()


def test_every_reference_model_function_is_covered():
    from paddle_tpu.vision.models import classic, resnet

    ours = set(RESNETS) | {n for n, _ in CLASSIC}
    assert set(resnet.__all__) - {"ResNet"} <= ours
    functions = {n for n in classic.__all__ if n[0].islower()}
    assert functions | {"LeNet"} <= ours
    assert sorted(TM.resnet.__all__) == sorted(resnet.__all__)
    assert sorted(TM.classic.__all__) == sorted(classic.__all__)
    for n in RESNETS + [n for n, _ in CLASSIC] + ["BasicBlock",
                                                 "BottleneckBlock"]:
        assert hasattr(TM, n) and hasattr(pt.vision.models, n), n


@pytest.fixture
def zero_init(monkeypatch):
    """Both packages' initializers give empty values of the asked shape
    (zeros on the reference's side)."""
    monkeypatch.setattr(j_init.Initializer, "__call__",
                        lambda self, shape, dtype=None, key=None: jnp.zeros(
                            tuple(int(s) for s in shape), jnp.float32))
    monkeypatch.setattr(t_init.Initializer, "__call__",
                        lambda self, shape, dtype=None, generator=None,
                        device=None: torch.empty(tuple(int(s)
                                                       for s in shape)))


@pytest.mark.parametrize("name,kw", [(n, {}) for n in RESNETS] + CLASSIC,
                         ids=lambda v: v if isinstance(v, str) else
                         "_".join(f"{k}{w}" for k, w in v.items()))
def test_model_state_dict_matches_reference(zero_init, name, kw):
    jm = getattr(JM, name)(**kw)
    tm = getattr(TM, name)(**kw)
    want = [(k, tuple(v.shape)) for k, v in jm.state_dict().items()]
    got = [(k, tuple(v.shape)) for k, v in tm.state_dict().items()]
    assert got == want
    n_j = sum(int(np.prod(p.shape)) for p in jm.parameters())
    n_t = sum(p.numel() for p in tm.parameters())
    assert n_t == n_j
    if name == "resnet50":
        assert n_t == 25_557_032


def test_resnet_options_and_pretrained():
    m = TM.resnet18(num_classes=0, with_pool=False)
    assert not hasattr(m, "fc") and not hasattr(m, "avgpool")
    out = m(torch.randn(1, 3, 64, 64))
    assert tuple(out.shape) == (1, 512, 2, 2)
    with pytest.raises(NotImplementedError):
        TM.resnet50(pretrained=True)
    b = TM.resnet50().layer2[0]
    assert b.conv2._stride == 2 and b.conv1._stride == 1   # v1.5


def _step_models():
    paddle_tpu.seed(0)
    jm = JM.resnet18(num_classes=10)
    tm = TM.resnet18(num_classes=10)
    C.carry(jm, tm)
    return jm, tm


def _port_step(tm, x, y, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    out = tm(tx)
    loss = pt.nn.CrossEntropyLoss()(out, torch.from_numpy(y))
    loss.backward()
    opt = pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=tm.parameters(),
        weight_decay=pt.optimizer.L2Decay(1e-4))
    grads = {k: p.grad.double().numpy() for k, p in tm.named_parameters()}
    opt.step()
    state = {k: v.detach().double().numpy()
             for k, v in tm.state_dict().items()}
    return (out.detach().double().numpy(), float(loss.detach()),
            tx.grad.double().numpy(), grads, state)


def test_resnet18_step_matches_reference():
    jm, tm = _step_models()
    t64 = _twin(tm)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, (2,)).astype(np.int64)
    # the JAX model on its own tape (training mode: the batch norms
    # update their statistics), then one Momentum step
    jx = paddle_tpu.to_tensor(x, stop_gradient=False)
    jout = jm(jx)
    jloss = paddle_tpu.nn.CrossEntropyLoss()(jout, paddle_tpu.to_tensor(y))
    jloss.backward()
    jopt = paddle_tpu.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=jm.parameters(),
        weight_decay=paddle_tpu.regularizer.L2Decay(1e-4))
    jgrads = {k: C._np(p.grad) for k, p in jm.named_parameters()}
    jopt.step()
    jstate = {k: C._np(v) for k, v in jm.state_dict().items()}

    out, loss, xg, grads, state = _port_step(tm, x, y, torch.float32)
    out64, loss64, xg64, grads64, state64 = _port_step(t64, x, y,
                                                       torch.float64)
    e_logits = near(out, C._np(jout), out64, "logits")
    # a mean cross entropy moves by at most twice the largest logit error
    for lv, e in zip((loss, float(C._np(jloss))), e_logits):
        assert abs(lv - loss64) <= 2 * e + FLOOR * abs(loss64), (lv, loss64)
    near(xg, C._np(jx.grad), xg64, "input grad")
    assert set(grads) == set(jgrads)
    for k in jgrads:
        near(grads[k], jgrads[k], grads64[k], f"grad of {k}")
    assert list(state) == list(jstate)
    for k in jstate:        # updated weights and running statistics
        near(state[k], jstate[k], state64[k], k)


def _block(nn, kind):
    if kind == "downsample":
        down = nn.Sequential(nn.Conv2D(16, 32, 1, stride=2, bias_attr=False),
                             nn.BatchNorm2D(32))
        return _bottleneck(nn)(16, 8, 2, down)
    return _bottleneck(nn)(32, 8, 1, None, groups=4, base_width=16)


def _bottleneck(nn):
    return (TM if nn is pt.nn else JM).resnet.BottleneckBlock


@pytest.mark.parametrize("kind,shape", [("downsample", (2, 16, 8, 8)),
                                        ("groups", (2, 32, 6, 6))])
def test_bottleneck_block_matches_reference(kind, shape):
    paddle_tpu.seed(1)
    jb = _block(paddle_tpu.nn, kind)
    tb = _block(pt.nn, kind)
    C.carry(jb, tb)
    t64 = _twin(tb)
    arrays = C.make_inputs([shape], seed=len(kind))
    want, wg, wp = C.run_jax(jb, arrays, len(kind), tape=True,
                             params=list(jb.named_parameters()))
    got, gg, gp = C.run_port(tb, arrays, len(kind),
                             params=list(tb.named_parameters()))
    ex, eg, ep = C.run_port(t64, arrays, len(kind), dtype=torch.float64,
                            params=list(t64.named_parameters()))
    near(got, want, ex, "out")
    near(gg[0], wg[0], eg[0], "input grad")
    assert set(gp) == set(wp)
    for k in wp:
        near(gp[k], wp[k], ep[k], f"grad of {k}")
    for k, v in jb.state_dict().items():        # the running statistics
        near(tb.state_dict()[k].detach().numpy(), C._np(v),
             t64.state_dict()[k].detach().numpy(), k)


@pytest.mark.parametrize("name,kw,shape", [
    ("LeNet", {}, (2, 1, 28, 28)),
    ("mobilenet_v1", {"scale": 0.25, "num_classes": 10}, (2, 3, 64, 64)),
    ("mobilenet_v2", {"scale": 0.25, "num_classes": 10}, (2, 3, 64, 64)),
    ("_Fire", (8, 4, 6, 6), (2, 8, 9, 9)),
])
def test_classic_model_matches_reference(name, kw, shape):
    paddle_tpu.seed(2)
    if name == "_Fire":
        jm, tm = JM.classic._Fire(*kw), TM.classic._Fire(*kw)
    else:
        jm, tm = getattr(JM, name)(**kw), getattr(TM, name)(**kw)
    C.carry(jm, tm)
    jm.eval()
    tm.eval()
    t64 = _twin(tm)
    arrays = C.make_inputs([shape], seed=len(name))
    want, wg, wp = C.run_jax(jm, arrays, len(name),
                             params=list(jm.named_parameters()))
    got, gg, gp = C.run_port(tm, arrays, len(name),
                             params=list(tm.named_parameters()))
    ex, eg, ep = C.run_port(t64, arrays, len(name), dtype=torch.float64,
                            params=list(t64.named_parameters()))
    near(got, want, ex, "out")
    near(gg[0], wg[0], eg[0], "input grad")
    assert set(gp) == set(wp)
    for k in wp:
        near(gp[k], wp[k], ep[k], f"grad of {k}")
