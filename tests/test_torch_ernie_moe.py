"""paddle_tpu_torch's ERNIE-MoE family, its MoE layer and gates against
paddle_tpu's, on the CPU.

The model at the ``"tiny"`` preset (2 layers, hidden 64, 4 heads of 16, 4
experts top-2 on the 2nd layer, vocab 256, fp32), its weights made by the
JAX model from a seed and carried over by ``load_paddle_params``, a batch
of 8 x 16 tokens from numpy with 15% of the positions labelled, GShard's
random routing off on both sides:

- loss and logits of ``model(ids, labels, token_type_ids)`` (the MLM cross
  entropy plus 0.01 x the gates' aux loss) against the JAX model through
  ``functional_call`` under one ``jax.jit``, with and without token types;
- every gradient of the Layer API's backward against ``jax.grad``;
- one paddle-style AdamW step against the JAX AdamW's
  (``adamw_step_matches``).

``MoELayer`` against the reference's, both dispatch forms: the dense
``[T, E, C]`` dispatch and combine tensors equal (bitwise: the same
integer ranks and the same fp32 weights), the sort plan's tokens, slots,
kept flags and weights equal, at a capacity factor that keeps every
choice and at one that drops some (asserted); the layer's output and its
gradients (input, gate, experts) against ``jax.grad`` in ``dense`` and
``sort`` mode; ``auto``'s choice against the reference's. The gates:
``NaiveGate``, ``GShardGate`` with random routing off and ``SwitchGate``
in eval mode (no noise): weights, expert ids and the aux loss; then
GShard's random second-expert drop and Switch's training noise with the
same numpy uniforms handed to both sides (each side's draw replaced):
the same ids, drops included (asserted to occur).

Tolerance: float32 on both sides, the same arithmetic summed in another
order: atol = rtol = 1e-5 at magnitudes of order 1, as in
test_torch_training.py; expert ids, kept sets and slots are held equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.incubate.distributed.models.moe import gate as jgate
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jmoe
from paddle_tpu.models import ernie as jernie
from paddle_tpu.nn.functional_call import functional_call
from paddle_tpu_torch import nn
from paddle_tpu_torch.core.place import set_device
from paddle_tpu_torch.incubate.distributed.models.moe import (
    GShardGate, MoELayer, NaiveGate, SwitchGate)
from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
from paddle_tpu_torch.models import (ErnieMoEForMaskedLM, ernie_moe_config,
                                     load_paddle_params)
from torch_jax_state import (adamw_step_matches, jax_reference_state,  # noqa: F401
                             one_thread)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's layers built here (the gates, the experts) go on the
    CPU; the place is put back after."""
    from paddle_tpu_torch.core import place

    prev = place._current[0]
    set_device("cpu")
    yield
    place._current[0] = prev


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _named(layer):
    return {k: np.asarray(p.value) for k, p in layer.named_parameters()}


def _routing_off(model):
    for layer in model.ernie.layers:
        if layer.use_moe:
            layer.ffn.gate.random_routing = False


def _jax_model(seed):
    paddle.seed(seed)
    cfg = jernie.ernie_moe_config("tiny")
    jm = jernie.ErnieMoEForMaskedLM(cfg)
    _routing_off(jm)
    jm.train()
    return jm, cfg


def _port(jm):
    model = ErnieMoEForMaskedLM(ernie_moe_config("tiny"), device="cpu")
    _routing_off(model)
    load_paddle_params(model, _named(jm))
    model.train()
    return model


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    labels = np.where(rng.rand(8, 16) < 0.15, ids, -100).astype(np.int32)
    types = rng.randint(0, cfg.type_vocab_size, (8, 16)).astype(np.int32)
    assert (labels != -100).sum() > 0
    return ids, labels, types


def _jax_loss(jm, ids, labels, types):
    tt = None if types is None else paddle.Tensor(types)
    return lambda pv: functional_call(jm, pv, paddle.Tensor(ids),
                                      paddle.Tensor(labels), tt)


def test_presets_match_the_reference():
    for name in jernie._PRESETS:
        want, got = jernie.ernie_moe_config(name), ernie_moe_config(name)
        for f in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                  "num_experts", "vocab_size", "top_k", "moe_every",
                  "capacity_factor", "max_position_embeddings",
                  "type_vocab_size", "head_dim", "ffn_size"):
            assert getattr(got, f) == getattr(want, f), (name, f)


@pytest.mark.parametrize("token_types", [False, True])
def test_loss_and_logits_match_jax(token_types):
    jm, cfg = _jax_model(3)
    ids, labels, types = _batch(cfg, seed=4)
    types = types if token_types else None
    params = {k: p.value for k, p in jm.named_parameters()}
    jloss, jlogits = jax.jit(_jax_loss(jm, ids, labels, types))(params)
    model = _port(jm)
    with torch.no_grad():
        loss, logits = model(_t(ids), _t(labels),
                             None if types is None else _t(types))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)


def test_layer_api_grads_match_jax():
    jm, cfg = _jax_model(5)
    ids, labels, types = _batch(cfg, seed=6)
    params = {k: p.value for k, p in jm.named_parameters()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda pv: _jax_loss(jm, ids, labels, types)(pv)[0]))(params)
    model = _port(jm)
    loss, _ = model(_t(ids), _t(labels), _t(types))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert sorted(k for k, _ in model.named_parameters()) == sorted(jgrads)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jgrads[k]), **TOL,
                                   err_msg=k)


def test_adamw_step_matches_jax():
    jm, cfg = _jax_model(7)
    ids, labels, types = _batch(cfg, seed=8)
    params = {k: p.value for k, p in jm.named_parameters()}
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda pv: _jax_loss(jm, ids, labels, types)(pv)[0]))(params)
    model = _port(jm)
    adamw_step_matches(model, jm, jgrads, cfg.hidden_size,
                       lambda: model(_t(ids), _t(labels), _t(types))[0])


# -- MoELayer ------------------------------------------------------------------

D, FFN, E = 16, 32, 4


def _jax_moe(seed, gate, mode, cf):
    paddle.seed(seed)
    experts = [jnn.Sequential(jnn.Linear(D, FFN), jnn.GELU(),
                              jnn.Linear(FFN, D)) for _ in range(E)]
    return jmoe.MoELayer(D, experts, gate=gate, capacity_factor=cf,
                         dispatch_mode=mode)


def _port_moe(jm, gate, mode, cf):
    experts = [nn.Sequential(nn.Linear(D, FFN), nn.GELU(),
                             nn.Linear(FFN, D)) for _ in range(E)]
    m = MoELayer(D, experts, gate=gate, capacity_factor=cf,
                 dispatch_mode=mode)
    load_paddle_params(m, _named(jm))
    return m


def _routing(seed, T=40, k=2):
    """Expert ids [T, k] with some second choices dropped (-1) and softmax-
    like weights, skewed so that expert 0 overflows a small capacity."""
    rng = np.random.RandomState(seed)
    p = np.array([0.55, 0.2, 0.15, 0.1])
    idx = np.stack([rng.choice(E, T, p=p), rng.choice(E, T, p=p[::-1])], 1)
    idx[rng.rand(T) < 0.2, 1] = -1
    val = rng.rand(T, k).astype(np.float32) + 0.05
    return idx.astype(np.int32), val


@pytest.mark.parametrize("cf", [2.0, 0.3])
def test_dispatch_plans_match_the_reference(cf):
    idx, val = _routing(11)
    T = idx.shape[0]
    cap = max(1, int(np.ceil(cf * 2 * T / E)))
    jd, jc = jmoe._build_dispatch(jnp.asarray(idx), jnp.asarray(val), E, cap)
    td, tc = moe_layer._build_dispatch(_t(idx).long(), _t(val), E, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    want = jmoe._sort_dispatch_plan(jnp.asarray(idx), jnp.asarray(val), E,
                                    cap)
    got = moe_layer._sort_dispatch_plan(_t(idx).long(), _t(val), E, cap)
    for name, g, w in zip(("t", "w", "slot", "kept"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    kept = np.asarray(want[3])
    routed = (idx >= 0).sum()
    # the two forms keep the same choices; a capacity of 0.3 drops some
    assert td.numpy().sum() == kept.sum()
    assert (kept.sum() < routed) == (cf < 1.0)


def test_auto_mode_matches_the_reference():
    for T, e, c in ((128, 4, 77), (8192, 8, 2458), (4096, 64, 154),
                    (2048, 8, 1024), (2048, 8, 1025)):
        assert moe_layer._pick_dispatch_mode(T, e, c) == \
            jmoe._pick_dispatch_mode(T, e, c)
    assert moe_layer._pick_dispatch_mode(8192, 8, 2458) == "sort"


@pytest.mark.parametrize("cf", [1.2, 0.3])
@pytest.mark.parametrize("mode", ["dense", "sort"])
def test_moe_layer_matches_jax(mode, cf):
    """Output and gradients (input, gate, experts) of ``MoELayer`` with a
    GShard gate (random routing off) against ``jax.grad``; at cf 0.3
    choices are dropped by capacity."""
    gate = {"type": "gshard", "top_k": 2}
    jm = _jax_moe(13, gate, mode, cf)
    jm.gate.random_routing = False
    m = _port_moe(jm, gate, mode, cf)
    m.gate.random_routing = False
    rng = np.random.RandomState(14)
    x = rng.randn(40, D).astype(np.float32)
    w = rng.randn(40, D).astype(np.float32)
    params = {k: p.value for k, p in jm.named_parameters()}

    def jloss(pv, xv):
        y = functional_call(jm, pv, paddle.Tensor(xv))
        return jnp.sum(y * w), y

    (jl, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = m(xt)
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _np(jgx), **TOL)
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jgp[k]), **TOL,
                                   err_msg=k)
    assert m.last_routing["mode"] == mode
    cap = m.last_routing["capacity"]
    counts = np.bincount(m.last_routing["idx"].numpy().reshape(-1) + 1,
                         minlength=E + 1)[1:]
    assert (counts.max() > cap) == (cf < 1.0)


# -- gates ---------------------------------------------------------------------


def _gate_pair(kind, seed):
    paddle.seed(seed)
    if kind == "naive":
        jg, tg = jgate.NaiveGate(D, E, topk=2), NaiveGate(D, E, topk=2)
    elif kind == "gshard":
        jg, tg = jgate.GShardGate(D, E), GShardGate(D, E)
    else:
        jg, tg = jgate.SwitchGate(D, E), SwitchGate(D, E)
    load_paddle_params(tg, _named(jg))
    return jg, tg


def _gate_outputs(jg, tg, x):
    params = {k: p.value for k, p in jg.named_parameters()}

    def run(pv):
        val, idx = functional_call(jg, pv, paddle.Tensor(x))
        return val, idx, jg.get_loss()

    jval, jidx, jaux = jax.jit(run)(params)
    val, idx = tg(_t(x))
    return (jval, jidx, jaux), (val, idx, tg.get_loss())


@pytest.mark.parametrize("kind", ["naive", "gshard", "switch"])
def test_gates_match_jax(kind):
    """Weights, expert ids and the aux loss (none for the naive gate) with
    random routing off (GShard) and in eval mode (Switch: no noise)."""
    jg, tg = _gate_pair(kind, 21)
    if kind == "gshard":
        jg.random_routing = tg.random_routing = False
    if kind == "switch":
        jg.eval()
        tg.eval()
    x = np.random.RandomState(22).randn(40, D).astype(np.float32)
    (jval, jidx, jaux), (val, idx, aux) = _gate_outputs(jg, tg, x)
    np.testing.assert_allclose(val.detach().numpy(), _np(jval), **TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if kind == "naive":
        assert aux is None and jaux is None
    else:
        np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("kind", ["gshard", "switch"])
def test_random_paths_match_jax_on_the_same_uniforms(kind, monkeypatch):
    """GShard's second-expert drop and Switch's multiplicative noise with
    the same numpy uniforms on both sides: ``jax.random.uniform`` and the
    port gate's ``_uniform`` replaced by the same draws."""
    jg, tg = _gate_pair(kind, 31)
    jg.train()
    tg.train()
    x = np.random.RandomState(32).randn(40, D).astype(np.float32)
    shape = (40,) if kind == "gshard" else (40, E)
    u = np.random.RandomState(33).rand(*shape).astype(np.float32)

    def jax_uniform(key, shp, dtype=jnp.float32, minval=0.0, maxval=1.0):
        assert tuple(shp) == shape
        return minval + (maxval - minval) * jnp.asarray(u)

    def port_uniform(shp, like, low=0.0, high=1.0):
        assert tuple(shp) == shape
        return low + (high - low) * _t(u)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(tg, "_uniform", port_uniform)
    jval, jidx = jg(paddle.Tensor(x))
    jaux = jg.get_loss()
    val, idx = tg(_t(x))
    aux = tg.get_loss()
    np.testing.assert_allclose(val.detach().numpy(), _np(jval.value), **TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx.value))
    np.testing.assert_allclose(aux.item(), float(jaux.value), **TOL)
    if kind == "gshard":
        assert (idx.numpy()[:, 1] == -1).any()        # the drop happened
    else:
        # the noise moved the scores: the weights differ from the noiseless
        tg.eval()
        assert not torch.equal(tg(_t(x))[0], val)


def test_moe_aux_loss_is_the_gates_sum():
    model = ErnieMoEForMaskedLM(ernie_moe_config("tiny", num_hidden_layers=4),
                                device="cpu")
    ids = torch.randint(0, 256, (2, 16))
    model(ids)
    gates = [m.gate for m in model.ernie.moe_layers()]
    assert len(gates) == 2
    want = sum(g.loss for g in gates)
    assert torch.equal(model.ernie.moe_aux_loss(), want)
    assert all(g.get_loss() is None for g in gates)
