"""paddle_tpu_torch's ``paddle.nn`` layers and ``Layer`` API against
paddle_tpu's, on the CPU.

- Every layer of the reference's ``nn/layer/activation.py``, ``common.py``
  and ``norm.py`` (parametrized over each module's ``__all__``; a name
  without a case fails): the JAX layer is built, its ``state_dict()`` is
  carried across as numpy through the port's ``set_state_dict`` (the same
  keys in the same order), and the output, the input gradients and the
  parameter gradients of ``sum(out * ct)`` are compared on the same seeded
  inputs. The batch norms run in training mode, so their updated running
  statistics are compared too. The layers whose training forward draws
  random numbers (the dropouts, ``RReLU``) are compared in eval mode here
  and held by their statistics in training mode.
- A subset again in bf16, both packages' layers built under
  ``set_default_dtype("bfloat16")``.
- The containers and the ``Layer`` API on the same tree on both sides:
  ``state_dict`` keys and order, persistable and non-persistable buffers,
  forward pre/post hooks and their removal, ``train``/``eval``,
  ``to``/``astype``, ``create_parameter`` with a ``ParamAttr`` and with a
  global initializer, ``functional_call``, ``full_name``, indexing and
  slicing, and ``Parameter``'s metadata through ``deepcopy`` and
  ``torch.save``.

Tolerances (``tests/torch_nn_cases.py``): fp32 rtol 1e-5 / atol 1e-6;
bf16 atol 2^-6 of the compared array's largest magnitude.
"""
import copy
import io

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
import torch_nn_cases as C
from paddle_tpu.nn.layer import activation as j_act
from paddle_tpu.nn.layer import common as j_common
from paddle_tpu.nn.layer import norm as j_norm
from paddle_tpu_torch import nn

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

# name -> (ctor args, ctor kwargs, input specs[, eval-mode only])
ACTIVATION = {
    "CELU": ((0.8,), {}, [(2, 3, 4)]),
    "ELU": ((0.7,), {}, [(2, 3, 4)]),
    "GELU": ((), {}, [(2, 3, 4)]),
    "GLU": ((-1,), {}, [(2, 3, 8)]),
    "Hardshrink": ((0.4,), {}, [(2, 3, 4)]),
    "Hardsigmoid": ((), {}, [(2, 3, 4)]),
    "Hardswish": ((), {}, [(2, 3, 4)]),
    "Hardtanh": ((-0.5, 0.7), {}, [(2, 3, 4)]),
    "LeakyReLU": ((0.1,), {}, [(2, 3, 4)]),
    "LogSigmoid": ((), {}, [(2, 3, 4)]),
    "LogSoftmax": ((1,), {}, [(2, 3, 4)]),
    "Maxout": ((2, 1), {}, [(2, 4, 3, 3)]),
    "Mish": ((), {}, [(2, 3, 4)]),
    "PReLU": ((3, 0.2), {}, [(2, 3, 4, 4)]),
    "ReLU": ((), {}, [(2, 3, 4)]),
    "ReLU6": ((), {}, [np.linspace(-9, 9, 24, dtype=np.float32) + 0.01]),
    "RReLU": ((0.1, 0.3), {}, [(2, 3, 4)], "eval"),
    "SELU": ((), {}, [(2, 3, 4)]),
    "Sigmoid": ((), {}, [(2, 3, 4)]),
    "Silu": ((), {}, [(2, 3, 4)]),
    "Softmax": ((1,), {}, [(2, 3, 4)]),
    "Softplus": ((2.0, 3.0), {}, [(2, 3, 4)]),
    "Softshrink": ((0.3,), {}, [(2, 3, 4)]),
    "Softsign": ((), {}, [(2, 3, 4)]),
    "Swish": ((), {}, [(2, 3, 4)]),
    "Tanh": ((), {}, [(2, 3, 4)]),
    "Tanhshrink": ((), {}, [(2, 3, 4)]),
    "ThresholdedReLU": ((0.5,), {}, [(2, 3, 4)]),
    "Softmax2D": ((), {}, [(2, 3, 4, 4)]),
}
COMMON = {
    "Linear": ((4, 6), {}, [(2, 3, 4)]),
    "LinearCompress": ((4, 6), {}, [(2, 3, 4)]),
    "Dropout": ((0.3,), {}, [(2, 3, 4)], "eval"),
    "Dropout2D": ((0.3,), {}, [(2, 3, 4, 4)], "eval"),
    "Dropout3D": ((0.3,), {}, [(2, 3, 2, 2, 2)], "eval"),
    "AlphaDropout": ((0.3,), {}, [(2, 3, 4)], "eval"),
    "Embedding": ((10, 4), {"padding_idx": 1}, [("ids", (2, 5), 10)]),
    "Flatten": ((), {}, [(2, 3, 4)]),
    "Unflatten": ((1, [2, 3]), {}, [(2, 6, 4)]),
    "Identity": ((), {}, [(2, 3)]),
    "Upsample": ((), {"size": [6, 7], "mode": "bilinear"}, [(1, 2, 3, 4)]),
    "UpsamplingBilinear2D": ((), {"scale_factor": 2}, [(1, 2, 3, 4)]),
    "UpsamplingNearest2D": ((), {"scale_factor": 2}, [(1, 2, 3, 4)]),
    "Pad1D": (([1, 2],), {"mode": "reflect"}, [(2, 3, 5)]),
    "Pad2D": (([1, 0, 2, 1],), {"mode": "replicate"}, [(1, 2, 4, 5)]),
    "Pad3D": ((1,), {"mode": "circular"}, [(1, 1, 3, 3, 3)]),
    "ZeroPad2D": (([1, 1, 2, 0],), {}, [(1, 2, 3, 3)]),
    "Bilinear": ((3, 4, 5), {}, [(2, 3), (2, 4)]),
    "CosineSimilarity": ((), {"axis": 1}, [(3, 5), (3, 5)]),
    "PairwiseDistance": ((), {}, [(3, 5), (3, 5)]),
    "PixelShuffle": ((2,), {}, [(1, 8, 3, 3)]),
    "PixelUnshuffle": ((2,), {}, [(1, 2, 4, 6)]),
    "ChannelShuffle": ((2,), {}, [(1, 4, 3, 3)]),
    "Fold": (([4, 5], 2), {}, [(1, 12, 12)]),
    "Unfold": ((2,), {"paddings": 1}, [(1, 2, 4, 4)]),
}
NORM = {
    "BatchNorm": ((3,), {}, [(4, 3, 2, 2)]),
    "BatchNorm1D": ((3,), {}, [(4, 3, 5)]),
    "BatchNorm2D": ((3,), {}, [(4, 3, 2, 2)]),
    "BatchNorm3D": ((3,), {}, [(2, 3, 2, 2, 2)]),
    "SyncBatchNorm": ((3,), {}, [(4, 3, 2, 2)]),
    "LayerNorm": (([4],), {}, [(2, 3, 4)]),
    "GroupNorm": ((2, 4), {}, [(2, 4, 3, 3)]),
    "InstanceNorm1D": ((3,), {}, [(2, 3, 6)]),
    "InstanceNorm2D": ((3,), {}, [(2, 3, 4, 4)]),
    "InstanceNorm3D": ((3,), {}, [(2, 3, 2, 3, 3)]),
    "LocalResponseNorm": ((3,), {}, [(2, 5, 3, 3)]),
    "SpectralNorm": (([4, 6],), {"power_iters": 2}, [(4, 6)]),
    "RMSNorm": ((4,), {}, [(2, 3, 4)]),
}
MODULES = {"activation": (j_act, ACTIVATION), "common": (j_common, COMMON),
           "norm": (j_norm, NORM)}
CASES = [(m, n) for m, (_, table) in MODULES.items() for n in sorted(table)]
BF16 = ["Linear", "LayerNorm", "GELU", "Silu", "Softmax", "Embedding",
        "GroupNorm", "BatchNorm2D", "Bilinear", "PReLU"]


@pytest.mark.parametrize("module", sorted(MODULES))
def test_every_reference_layer_has_a_case(module):
    ref, table = MODULES[module]
    assert set(table) == set(ref.__all__)
    port = getattr(pt.nn.layer, module)
    assert sorted(port.__all__) == sorted(ref.__all__)


def _build(module, name, dtype="float32"):
    ref, table = MODULES[module]
    args, kwargs, specs = table[name][:3]
    paddle_tpu.set_default_dtype(dtype)
    pt.set_default_dtype(dtype)
    paddle_tpu.seed(3)
    jl = getattr(ref, name)(*args, **kwargs)
    tl = getattr(getattr(pt.nn.layer, module), name)(*args, **kwargs)
    if name == "RMSNorm":         # the model's module: torch's own loader
        tl.load_state_dict({k: torch.from_numpy(C._np(v)) for k, v in
                            jl.state_dict().items()})
    else:
        C.carry(jl, tl)
    if len(table[name]) > 3:
        jl.eval()
        tl.eval()
    return jl, tl, specs


@pytest.mark.parametrize("module,name", CASES)
def test_layer_matches_reference(module, name):
    jl, tl, specs = _build(module, name)
    arrays = C.make_inputs(specs, seed=len(name))
    want, wg, wp = C.run_jax(jl, arrays, len(name),
                             params=list(jl.named_parameters()),
                             tape="BatchNorm" in name)
    got, gg, gp = C.run_port(tl, arrays, len(name),
                             params=list(tl.named_parameters()))
    C.close(got, want, what="out")
    for g, w in zip(gg, wg):
        C.close(g, w, what="input grad")
    for k in set(gp) | set(wp):   # a parameter without a gradient: zeros
        C.close(gp.get(k), wp.get(k), what=f"grad of {k}")
    if module == "norm" and "BatchNorm" in name:   # the running statistics
        for k, v in jl.state_dict().items():
            C.close(C._np(tl.state_dict()[k].detach()), C._np(v), what=k)


@pytest.mark.parametrize("name", BF16)
def test_layer_matches_reference_bf16(name):
    module = next(m for m, n in CASES if n == name)
    jl, tl, specs = _build(module, name, "bfloat16")
    arrays = C.make_inputs(specs, seed=len(name))
    want, wg, wp = C.run_jax(jl, arrays, len(name), dtype="bfloat16",
                             params=list(jl.named_parameters()),
                             tape="BatchNorm" in name)
    got, gg, gp = C.run_port(tl, arrays, len(name), dtype=torch.bfloat16,
                             params=list(tl.named_parameters()))
    assert all(p.dtype == torch.bfloat16 for p in tl.parameters())
    C.close(got, want, "bfloat16", what="out")
    for g, w in zip(gg, wg):
        C.close(g, w, "bfloat16", what="input grad")
    for k in wp:
        C.close(gp[k], wp[k], "bfloat16", what=f"grad of {k}")


@pytest.mark.parametrize("name,p", [("Dropout", 0.3), ("Dropout2D", 0.5),
                                    ("AlphaDropout", 0.2)])
def test_dropout_layers_in_training(name, p):
    """Training mode drops a share p of the elements (of the channels for
    Dropout2D), scales the rest by 1 / (1 - p) (AlphaDropout: keeps the
    mean and variance of a standard normal input), and draws again on
    every call; eval mode is the identity."""
    layer = getattr(nn, name)(p)
    x = torch.randn(64, 32, 8, 8) if name == "Dropout2D" else \
        torch.randn(200, 300)
    pt.seed(1)
    y1 = layer(x)
    y2 = layer(x)
    assert not torch.equal(y1, y2)
    if name == "AlphaDropout":
        assert abs(y1.mean().item()) < 0.02 and abs(y1.std().item() - 1) < 0.03
    else:
        dropped = (y1 == 0)
        if name == "Dropout2D":
            dropped = dropped.all(-1).all(-1)
        assert abs(dropped.float().mean().item() - p) < 0.03
        kept = y1 != 0
        assert torch.allclose(y1[kept], x[kept] / (1 - p))
    pt.seed(1)
    assert torch.equal(layer(x), y1)
    layer.eval()
    assert torch.equal(layer(x), x)


def test_rrelu_in_training():
    layer = nn.RReLU(0.1, 0.3)
    x = -torch.rand(100, 100) - 0.5
    slope = layer(x) / x
    assert 0.1 <= slope.min().item() and slope.max().item() <= 0.3
    assert abs(slope.mean().item() - 0.2) < 0.01


# -- the containers and the Layer API ----------------------------------------


def _block(P):
    class Block(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = P.nn.Linear(4, 6)
            self.norm = P.nn.BatchNorm1D(6)
            self.act = P.nn.GELU()
            self.head = P.nn.Sequential(P.nn.Linear(6, 3),
                                        P.nn.Linear(3, 2, bias_attr=False))
            self.register_buffer("count", P.to_tensor(np.zeros(2, np.float32)))
            self.register_buffer("scratch",
                                 P.to_tensor(np.ones(2, np.float32)),
                                 persistable=False)

        def forward(self, x):
            return self.head(self.act(self.norm(self.fc1(x))))

    return Block()


def test_layer_tree_state_dict_and_forward():
    jb, tb = _block(paddle_tpu), _block(pt)
    assert list(tb.state_dict()) == list(jb.state_dict())
    assert "scratch" not in tb.state_dict() and "count" in tb.state_dict()
    assert [n for n, _ in tb.named_buffers()] == \
        [n for n, _ in jb.named_buffers()]
    assert [n for n, _ in tb.named_parameters()] == \
        [n for n, _ in jb.named_parameters()]
    assert [n for n, _ in tb.named_sublayers()] == \
        [n for n, _ in jb.named_sublayers()]
    assert isinstance(tb.parameters(), list) and \
        len(tb.parameters()) == len(jb.parameters())
    C.carry(jb, tb)
    x = C.make_inputs([(5, 4)], 0)
    want, wg, wp = C.run_jax(jb, x, 0, params=list(jb.named_parameters()))
    got, gg, gp = C.run_port(tb, x, 0, params=list(tb.named_parameters()))
    C.close(got, want)
    C.close(gg[0], wg[0])
    for k in wp:
        C.close(gp[k], wp[k], what=k)
    # the state dict's values are the parameters themselves
    assert tb.state_dict()["fc1.weight"] is tb.fc1.weight
    missing, unexpected = tb.set_state_dict({"fc1.weight": np.zeros((4, 6)),
                                             "nope": np.zeros(1)})
    assert "fc1.bias" in missing and unexpected == ["nope"]
    assert not tb.fc1.weight.any()
    with pytest.raises(ValueError, match="shape mismatch"):
        tb.set_state_dict({"fc1.weight": np.zeros((6, 4))})


def test_hooks_train_eval_and_dtype():
    outs = {}
    jl = paddle_tpu.nn.Linear(3, 2)
    for P in (paddle_tpu, pt):
        layer = jl if P is paddle_tpu else P.nn.Linear(3, 2)
        if P is pt:
            C.carry(jl, layer)
        x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        h1 = layer.register_forward_pre_hook(lambda l, inp: (inp[0] * 2,))
        h2 = layer.register_forward_post_hook(lambda l, inp, out: out + 1)
        if P is pt:
            from paddle_tpu_torch.nn.layer.layers import HookRemoveHelper

            assert isinstance(h1, HookRemoveHelper)
        hooked = C._np(layer(x))
        h1.remove()
        h2.remove()
        outs[P.__name__] = (hooked, C._np(layer(x)))
        seq = P.nn.Sequential(P.nn.Linear(2, 2), P.nn.Dropout(0.5))
        seq.eval()
        assert not seq[1].training
        seq.train()
        assert seq[1].training
    (jh, jp), (th, tp) = outs["paddle_tpu"], outs["paddle_tpu_torch"]
    C.close(th, jh)
    C.close(tp, jp)
    assert not np.allclose(th, tp)
    layer = nn.Linear(3, 2)
    layer.astype("float16")
    assert layer.weight.dtype == torch.float16
    layer.to(dtype="bfloat16")
    assert layer.weight.dtype == torch.bfloat16
    assert isinstance(layer.weight, nn.Parameter)
    layer.to("cpu")
    layer.float()
    assert layer.weight.dtype == torch.float32
    assert layer.full_name().startswith("linear_")


def test_create_parameter_attr_and_global_initializer():
    I, J = pt.nn.initializer, paddle_tpu.nn.initializer
    attr_t = pt.ParamAttr(name="w", initializer=I.Constant(0.5),
                          learning_rate=0.1, trainable=False)
    attr_j = paddle_tpu.ParamAttr(name="w", initializer=J.Constant(0.5),
                                  learning_rate=0.1, trainable=False)
    t = pt.create_parameter([2, 3], "float32", attr=attr_t)
    j = paddle_tpu.create_parameter([2, 3], "float32", attr=attr_j)
    np.testing.assert_array_equal(t.detach().numpy(), C._np(j))
    assert (t.name, t.trainable, t.stop_gradient, t.optimize_attr) == \
        (j.name, j.trainable, j.stop_gradient, j.optimize_attr)
    assert pt.create_parameter([2], "float32", attr=False) is None
    b = pt.create_parameter([3], "float32", is_bias=True)
    assert not b.any()
    I.set_global_initializer(I.Constant(0.3), I.Constant(0.1))
    J.set_global_initializer(J.Constant(0.3), J.Constant(0.1))
    try:
        tl, jl = nn.Linear(2, 3), paddle_tpu.nn.Linear(2, 3)
        for k, v in jl.state_dict().items():
            np.testing.assert_array_equal(
                tl.state_dict()[k].detach().numpy(), C._np(v))
    finally:
        I.set_global_initializer(None, None)
        J.set_global_initializer(None, None)
    p = nn.Linear(2, 2).weight
    p.stop_gradient = True
    assert not p.requires_grad and not p.trainable
    p.trainable = True
    assert p.requires_grad and not p.stop_gradient


def test_parameter_copy_and_save_keep_metadata():
    p = pt.create_parameter([2, 2], "float32",
                            attr=pt.ParamAttr(name="kept",
                                              learning_rate=0.5))
    q = copy.deepcopy(p)
    assert type(q) is nn.Parameter and q.name == "kept"
    assert q.optimize_attr == {"learning_rate": 0.5}
    assert torch.equal(q, p) and q.data_ptr() != p.data_ptr()
    buf = io.BytesIO()
    layer = nn.Linear(2, 2, weight_attr=pt.ParamAttr(name="lw"))
    torch.save(layer.state_dict(), buf)
    buf.seek(0)
    sd = torch.load(buf)
    assert type(sd["weight"]) is nn.Parameter and sd["weight"].name == "lw"
    assert torch.equal(sd["weight"], layer.weight)
    # the optimizers take a Layer's parameters as they are
    opt = torch.optim.SGD(layer.parameters(), lr=0.1)
    layer(torch.ones(1, 2)).sum().backward()
    opt.step()
    layer.clear_gradients()
    assert all(p.grad is None for p in layer.parameters())


def test_functional_call_matches_reference():
    """functional_call with substituted parameters: the reference runs it
    under its tape and returns raw values (a batch of 8 rows, its mesh's dp
    axis); the port's output stays in torch's graph."""
    from paddle_tpu.nn.functional_call import functional_call as jcall
    from paddle_tpu_torch.nn.functional_call import functional_call as tcall

    jb, tb = _block(paddle_tpu), _block(pt)
    jb.eval()
    tb.eval()
    C.carry(jb, tb)
    new = {k: C.make_inputs([tuple(v.shape)], i)[0]
           for i, (k, v) in enumerate(jb.named_parameters())}
    x = C.make_inputs([(8, 4)], 1)[0]
    want = np.asarray(jcall(jb, {k: paddle_tpu.to_tensor(v).value
                                 for k, v in new.items()},
                            paddle_tpu.to_tensor(x)))
    tparams = {k: torch.from_numpy(v).requires_grad_()
               for k, v in new.items()}
    got = tcall(tb, tparams, torch.from_numpy(x))
    C.close(got.detach().numpy(), want, tol=dict(rtol=1e-5, atol=1e-5))
    got.sum().backward()
    assert tparams["fc1.weight"].grad is not None
    assert tb.fc1.weight.grad is None          # the layer's own are back
    with pytest.raises(KeyError):
        tcall(tb, {"nope": torch.zeros(1)}, torch.from_numpy(x))


def test_containers_match_reference():
    for P in (paddle_tpu, pt):
        seq = P.nn.Sequential(("a", P.nn.ReLU()), ("b", P.nn.Tanh()))
        assert [n for n, _ in seq.named_children()] == ["a", "b"]
        assert isinstance(seq[0], P.nn.ReLU) and isinstance(seq[-1],
                                                            P.nn.Tanh)
        assert len(seq[1:]) == 1 and isinstance(seq[1:], P.nn.Sequential)
        ll = P.nn.LayerList([P.nn.ReLU(), P.nn.Tanh()])
        ll.append(P.nn.Sigmoid())
        ll.insert(0, P.nn.Silu())
        assert [type(l).__name__ for l in ll] == ["Silu", "ReLU", "Tanh",
                                                  "Sigmoid"]
        del ll[1]
        assert [n for n, _ in ll.named_children()] == ["0", "1", "2"]
        assert type(ll[-1]).__name__ == "Sigmoid" and len(ll[:2]) == 2
        ld = P.nn.LayerDict({"x": P.nn.ReLU()})
        ld["y"] = P.nn.Tanh()
        assert list(ld.keys()) == ["x", "y"] and "y" in ld
        ld.pop("x")
        assert len(ld) == 1
        pl = P.nn.ParameterList([P.create_parameter([2], "float32")])
        pl.append(P.create_parameter([3], "float32"))
        assert len(pl) == 2 and tuple(pl[-1].shape) == (3,)
        assert [k for k in P.nn.Layer().state_dict()] == []
    jseq = paddle_tpu.nn.Sequential(paddle_tpu.nn.Linear(3, 4),
                                    paddle_tpu.nn.Linear(4, 2))
    tseq = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2))
    C.carry(jseq, tseq)
    x = C.make_inputs([(2, 3)], 4)
    want, wg, _ = C.run_jax(jseq, x, 4)
    got, gg, _ = C.run_port(tseq, x, 4)
    C.close(got, want)
    C.close(gg[0], wg[0])
    pl = nn.ParameterList([pt.create_parameter([2], "float32")])
    assert list(pl.state_dict()) == ["0"]


def test_existing_tests_oracles_on_the_port():
    """tests/test_nn_layers.py holds the reference against torch; the same
    facts of the port: Linear's [in, out] weight, Embedding's zero padding
    row, LayerNorm's default affine and BatchNorm's running update."""
    lin = nn.Linear(3, 5)
    assert tuple(lin.weight.shape) == (3, 5)
    x = torch.randn(4, 3)
    torch.testing.assert_close(lin(x), x @ lin.weight + lin.bias)
    emb = nn.Embedding(6, 2, padding_idx=0)
    assert not emb.weight[0].any()
    ln = nn.LayerNorm(5)
    assert torch.equal(ln.weight, torch.ones(5)) and not ln.bias.any()
    bn = nn.BatchNorm1D(3)
    xb = torch.randn(8, 3)
    bn(xb)
    torch.testing.assert_close(bn._mean, 0.1 * xb.mean(0))


def test_nn_top_level_names():
    """Every public name of the reference's ``paddle.nn`` is the port's,
    the convolution, pooling, recurrent and transformer layers, the
    decoders (and the ``decode`` module) and the four sequence-loss
    layers included (ROADMAP A14b): nothing is left out."""
    import importlib

    for m in ("conv", "pooling", "rnn", "transformer"):
        names = set(importlib.import_module(
            f"paddle_tpu.nn.layer.{m}").__all__)
        assert names <= set(nn.__all__), m
    for n in ("BeamSearchDecoder", "dynamic_decode", "CTCLoss",
              "HSigmoidLoss", "MultiMarginLoss", "RNNTLoss", "decode"):
        assert hasattr(nn, n), n
    ref = {n for n in dir(paddle_tpu.nn) if not n.startswith("_")}
    ref -= {"layer", "clip", "param_attr", "parameter", "functional_call"}
    missing = sorted(n for n in ref if not hasattr(nn, n))
    assert not missing, missing
    assert set(nn.__all__) <= {n for n in dir(nn)}


def test_weight_norm_and_spectral_norm_match_reference():
    """nn.utils on a Linear carried across: ``weight_norm``'s output and
    input gradient, its parameters (weight_g, weight_v, in the reference's
    order), ``remove_weight_norm`` back to a plain weight of the same
    values; ``spectral_norm`` with the reference's power-iteration start
    vectors copied across, two training forwards. The port's hooks are
    differentiable in g and v (ROADMAP C-ref-6)."""
    from paddle_tpu.nn import utils as jutils

    from paddle_tpu_torch.nn import utils as tutils

    for dim in (0, None):
        jl, tl = paddle_tpu.nn.Linear(4, 3), nn.Linear(4, 3)
        C.carry(jl, tl)
        jutils.weight_norm(jl, dim=dim)
        tutils.weight_norm(tl, dim=dim)
        assert [k for k, _ in tl.named_parameters()] == \
            [k for k, _ in jl.named_parameters()]
        x = C.make_inputs([(2, 4)], 3)
        want, wg, _ = C.run_jax(jl, x, 3, tape=True)
        got, gg, gp = C.run_port(tl, x, 3,
                                 params=list(tl.named_parameters()))
        C.close(got, want)
        C.close(gg[0], wg[0])
        assert np.abs(gp["weight_g"]).sum() > 0
        jutils.remove_weight_norm(jl)
        tutils.remove_weight_norm(tl)
        C.close(tl.weight.detach().numpy(), C._np(jl.weight))
        assert sorted(k for k, _ in tl.named_parameters()) == \
            ["bias", "weight"]
    jl, tl = paddle_tpu.nn.Linear(5, 3), nn.Linear(5, 3)
    C.carry(jl, tl)
    jutils.spectral_norm(jl, n_power_iterations=2)
    tutils.spectral_norm(tl, n_power_iterations=2)
    for k in ("weight_u", "weight_v"):
        tl.__dict__[k] = torch.from_numpy(C._np(getattr(jl, k)))
    x = C.make_inputs([(2, 5)], 4)
    for _ in range(2):
        want, wg, _ = C.run_jax(jl, x, 4, tape=True)
        got, gg, _ = C.run_port(tl, x, 4)
        C.close(got, want, tol=dict(rtol=1e-5, atol=1e-5))
        C.close(gg[0], wg[0], tol=dict(rtol=1e-5, atol=1e-5))


def test_parameter_vector_round_trip_matches_reference():
    from paddle_tpu.nn import utils as jutils

    from paddle_tpu_torch.nn import utils as tutils

    jl = paddle_tpu.nn.Sequential(paddle_tpu.nn.Linear(3, 2),
                                  paddle_tpu.nn.Linear(2, 2))
    tl = nn.Sequential(nn.Linear(3, 2), nn.Linear(2, 2))
    C.carry(jl, tl)
    tv = tutils.parameters_to_vector(tl.parameters())
    np.testing.assert_array_equal(
        tv.numpy(), C._np(jutils.parameters_to_vector(jl.parameters())))
    assert not tv.requires_grad
    new = np.arange(tv.numel(), dtype=np.float32)
    tutils.vector_to_parameters(torch.from_numpy(new), tl.parameters())
    jutils.vector_to_parameters(paddle_tpu.to_tensor(new), jl.parameters())
    for k, v in jl.state_dict().items():
        np.testing.assert_array_equal(tl.state_dict()[k].detach().numpy(),
                                      C._np(v))
    assert tutils.clip_grad_norm_ is nn.clip_grad_norm_
