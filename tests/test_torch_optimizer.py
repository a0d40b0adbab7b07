"""paddle_tpu_torch's eager optimizers, LR schedulers, gradient clips and
main-gradient mixed precision against paddle_tpu's, on the CPU.

- LR schedulers: the sequence of ``get_lr()`` values over 50 steps equals
  the reference's exactly (the same float arithmetic), for every scheduler,
  ``LinearWarmup`` around another one and across a ``state_dict`` round
  trip, and ``ReduceOnPlateau`` over a seeded metric sequence.
- Optimizers: three steps on the same seeded gradients from the same
  parameters; every parameter allclose at rtol 1e-5 in fp32 (the same
  arithmetic, reductions summed in another order). AdamW on bf16
  parameters: the moments are fp32 after steps 1 and 2 on both sides.
  The parameters' names follow the port's rule (``param_{i}`` by position;
  the JAX side's process-wide names are mapped by position).
- Clips: the clipped gradients and the global norm's scale against the
  reference's.
- ``state_dict``: port against port, bitwise, and the next step bitwise.
- ``MixPrecisionLayer`` / ``MixPrecisionOptimizer``: main_grad over two
  micro-batches, the fp32 masters and the bf16 parameters against the
  reference's at bf16 tolerance (both sides' bf16 products round in
  other orders); the port's ``MixPrecisionScaler`` unscales main_grad and
  skips a step on inf.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.utils import mix_precision_utils as jmp
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn.parameter import Parameter as JParameter
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.optimizer import optimizer as jopt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.distributed.fleet.utils import mix_precision_utils as tmp
from paddle_tpu_torch.distributed.mp_layers import ColumnParallelLinear
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.optimizer import optimizer as topt

TOL = dict(rtol=1e-5, atol=1e-6)
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors are tiny, and a thread pool on a
    machine whose cores other test workers hold waits at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- LR schedulers -------------------------------------------------------------

SCHEDULERS = {
    "noam": ("NoamDecay", dict(d_model=64, warmup_steps=10,
                               learning_rate=1.0)),
    "piecewise": ("PiecewiseDecay", dict(boundaries=[5, 20],
                                         values=[0.1, 0.05, 0.01])),
    "natural_exp": ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.1)),
    "inverse_time": ("InverseTimeDecay", dict(learning_rate=0.5,
                                              gamma=0.1)),
    "polynomial": ("PolynomialDecay", dict(learning_rate=0.5,
                                           decay_steps=20, end_lr=0.01,
                                           power=2.0)),
    "polynomial_cycle": ("PolynomialDecay", dict(
        learning_rate=0.5, decay_steps=12, end_lr=0.01, cycle=True)),
    "linear_warmup": ("LinearWarmup", dict(learning_rate=0.5,
                                           warmup_steps=10, start_lr=0.0,
                                           end_lr=0.5)),
    "exponential": ("ExponentialDecay", dict(learning_rate=0.5, gamma=0.9)),
    "multistep": ("MultiStepDecay", dict(learning_rate=0.5,
                                         milestones=[10, 30], gamma=0.5)),
    "step": ("StepDecay", dict(learning_rate=0.5, step_size=7, gamma=0.5)),
    "lambda": ("LambdaDecay", dict(learning_rate=0.5,
                                   lr_lambda=lambda e: 0.95 ** e)),
    "multiplicative": ("MultiplicativeDecay", dict(
        learning_rate=0.5, lr_lambda=lambda e: 0.95)),
    "cosine": ("CosineAnnealingDecay", dict(learning_rate=0.5, T_max=20,
                                            eta_min=0.01)),
    "cosine_restarts": ("CosineAnnealingWarmRestarts", dict(
        learning_rate=0.5, T_0=5, T_mult=2, eta_min=0.01)),
    "linear_lr": ("LinearLR", dict(learning_rate=0.5, total_steps=20)),
    "one_cycle": ("OneCycleLR", dict(max_learning_rate=0.5,
                                     total_steps=40)),
    "one_cycle_linear": ("OneCycleLR", dict(
        max_learning_rate=0.5, total_steps=40, anneal_strategy="linear",
        three_phase=True)),
    "cyclic2": ("CyclicLR", dict(base_learning_rate=0.01,
                                 max_learning_rate=0.5, step_size_up=5,
                                 mode="triangular2")),
    "cyclic_exp": ("CyclicLR", dict(base_learning_rate=0.01,
                                    max_learning_rate=0.5, step_size_up=4,
                                    step_size_down=6, mode="exp_range",
                                    exp_gamma=0.9)),
}


def _lrs(sched, n=50):
    seq = [sched(), sched.get_lr()]
    for _ in range(n):
        sched.step()
        seq.append(sched())
    return seq


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_lr_sequence_equals_reference(case):
    name, kw = SCHEDULERS[case]
    assert _lrs(getattr(tlr, name)(**kw)) == _lrs(getattr(jlr, name)(**kw))


def _warmup_cosine(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(0.5, T_max=15,
                                                     eta_min=0.01),
                            warmup_steps=8, start_lr=0.0, end_lr=0.5)


def test_linear_warmup_around_a_scheduler_and_its_state_dict():
    """LinearWarmup(CosineAnnealingDecay): 50 steps equal the reference's;
    after 20 steps its state_dict (the inner scheduler's nested) carries
    into a fresh pair, whose next 30 values equal the uninterrupted ones."""
    t, j = _warmup_cosine(tlr), _warmup_cosine(jlr)
    assert _lrs(t) == _lrs(j)
    a = _warmup_cosine(tlr)
    for _ in range(20):
        a.step()
    sd = a.state_dict()
    assert sd == _advanced(_warmup_cosine(jlr), 20).state_dict()
    b = _warmup_cosine(tlr)
    b.set_state_dict(dict(sd))
    assert _lrs(b, 30) == _lrs(a, 30)


def _advanced(sched, n):
    for _ in range(n):
        sched.step()
    return sched


def test_reduce_on_plateau_equals_reference():
    rng = np.random.RandomState(3)
    metrics = list(rng.rand(60))
    kw = dict(learning_rate=0.5, factor=0.5, patience=2, cooldown=1,
              min_lr=0.01)
    t, j = tlr.ReduceOnPlateau(**kw), jlr.ReduceOnPlateau(**kw)
    got, want = [], []
    for m in metrics:
        t.step(torch.tensor(float(m)))
        j.step(float(m))
        got.append(t())
        want.append(j())
    assert got == want
    assert min(got) < 0.5                     # the rate did fall


# -- optimizers ------------------------------------------------------------------

SHAPES = [(4, 3), (3,), (2, 5, 2)]


def _case(seed, steps=3):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return params, grads


def _jax_params(arrs, dtype=jnp.float32):
    return [JParameter(jnp.asarray(a, dtype)) for a in arrs]


def _torch_params(arrs, dtype=torch.float32):
    return [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dtype))
            for a in arrs]


def _by_position(params):
    """name -> position of the JAX side's process-wide parameter names."""
    return {p.name: i for i, p in enumerate(params)}


def _names_fun(side, params, keep):
    """apply_decay_param_fun selecting positions ``keep`` on either side."""
    if side == "jax":
        pos = _by_position(params)
        return lambda name: pos[name] in keep
    return lambda name: int(name.split("_")[1]) in keep


def _identity_fun(params, keep):
    ids = {id(params[i]) for i in keep}
    return lambda p: id(p) in ids


OPTIMIZERS = {
    "sgd_l2": ("SGD", lambda s, ps: dict(learning_rate=0.1,
                                        weight_decay=0.01)),
    "sgd_l1": ("SGD", lambda s, ps: dict(
        learning_rate=0.1, weight_decay=(
            paddle.regularizer.L1Decay(0.05) if s == "jax"
            else topt.L1Decay(0.05)))),
    "momentum_nesterov_clip": ("Momentum", lambda s, ps: dict(
        learning_rate=0.05, momentum=0.9, use_nesterov=True,
        grad_clip=_clip(s, "ClipGradByGlobalNorm", 1.0))),
    "momentum_rescale": ("Momentum", lambda s, ps: dict(
        learning_rate=0.05, momentum=0.8, rescale_grad=0.5)),
    "adagrad": ("Adagrad", lambda s, ps: dict(
        learning_rate=0.1, initial_accumulator_value=0.1)),
    "adadelta": ("Adadelta", lambda s, ps: dict(learning_rate=1.0)),
    "rmsprop_centered": ("RMSProp", lambda s, ps: dict(
        learning_rate=0.01, momentum=0.9, centered=True)),
    "rmsprop": ("RMSProp", lambda s, ps: dict(learning_rate=0.01)),
    "adam_l2": ("Adam", lambda s, ps: dict(learning_rate=0.01,
                                          weight_decay=0.01)),
    "adam_warmup": ("Adam", lambda s, ps: dict(learning_rate=(
        jlr if s == "jax" else tlr).LinearWarmup(0.01, 2, 0.001, 0.01))),
    "adamw_decay_fun": ("AdamW", lambda s, ps: dict(
        learning_rate=0.01, weight_decay=0.1,
        apply_decay_param_fun=_names_fun(s, ps, {0, 2}))),
    "adamw_lr_ratio_clip": ("AdamW", lambda s, ps: dict(
        learning_rate=0.01, weight_decay=0.05,
        lr_ratio=_lr_ratio(ps), grad_clip=_clip(s, "ClipGradByNorm", 0.5))),
    "adamax": ("Adamax", lambda s, ps: dict(learning_rate=0.02)),
    "lamb": ("Lamb", lambda s, ps: dict(
        learning_rate=0.01, lamb_weight_decay=0.01,
        exclude_from_weight_decay_fn=_identity_fun(ps, {1}))),
}


def _clip(side, name, v):
    return getattr(jclip if side == "jax" else tclip, name)(v)


def _lr_ratio(params):
    ratios = {id(p): 0.5 + 0.25 * i for i, p in enumerate(params)}
    return lambda p: ratios[id(p)]


def _run_jax(name, kw, params, grads):
    jp = _jax_params(params)
    opt = getattr(jopt, name)(parameters=jp, **kw("jax", jp))
    for gs in grads:
        for p, g in zip(jp, gs):
            p.grad = paddle.to_tensor(g)
        opt.step()
        opt.clear_grad()
    return jp, opt


def _run_torch(name, kw, params, grads, dtype=torch.float32):
    tp = _torch_params(params, dtype)
    opt = getattr(topt, name)(parameters=tp, **kw("torch", tp))
    for gs in grads:
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g).to(dtype)
        opt.step()
        opt.clear_grad()
    return tp, opt


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_over_three_steps(case):
    name, kw = OPTIMIZERS[case]
    params, grads = _case(sorted(OPTIMIZERS).index(case))
    jp, jo = _run_jax(name, kw, params, grads)
    tp, to = _run_torch(name, kw, params, grads)
    for i, (a, b) in enumerate(zip(tp, jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b.value),
                                   **TOL, err_msg=f"{case} param {i}")
    # the same accumulators under the same names (by position)
    pos = _by_position(jp)
    jsd = jo.state_dict()
    want = {}
    for k, v in jsd.items():
        for n, i in pos.items():
            if k.startswith(n + "_"):
                want[f"param_{i}_{k[len(n) + 1:]}"] = v
    got = {k: v for k, v in to.state_dict().items()
           if k not in ("global_step", "LR_Scheduler")}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(np.asarray(v, np.float32),
                                   np.asarray(want[k].value, np.float32),
                                   **TOL, err_msg=k)
    assert to.state_dict()["global_step"] == jsd["global_step"] == 3


def test_adamw_bf16_moments_promote_to_fp32_as_the_reference():
    """bf16 parameters: the moments start bf16 (zeros_like) and are fp32
    after steps 1 and 2 on both sides; parameters stay bf16 and agree
    within one bf16 step (both sides round one fp32 result)."""
    params, grads = _case(40, steps=2)
    jp = _jax_params(params, jnp.bfloat16)
    tp = _torch_params(params, torch.bfloat16)
    jo = jopt.AdamW(learning_rate=0.01, parameters=jp, weight_decay=0.1)
    to = topt.AdamW(learning_rate=0.01, parameters=tp, weight_decay=0.1)
    for step, gs in enumerate(grads):
        for p, q, g in zip(jp, tp, gs):
            p.grad = paddle.to_tensor(jnp.asarray(g, jnp.bfloat16))
            q.grad = torch.from_numpy(g).to(torch.bfloat16)
        jo.step()
        to.step()
        for i, (a, b) in enumerate(zip(tp, jp)):
            assert a.dtype == torch.bfloat16
            for acc in ("moment1", "moment2"):
                assert to._accumulators[acc][f"param_{i}"].dtype == \
                    torch.float32
                assert jo._accumulators[acc][b.name].dtype == jnp.float32
            np.testing.assert_allclose(
                a.detach().float().numpy(),
                np.asarray(b.value.astype(jnp.float32)),
                rtol=BF16_STEP, atol=1e-6, err_msg=f"step {step} param {i}")


def test_lbfgs_matches_reference_on_a_quadratic():
    rng = np.random.RandomState(5)
    A = rng.randn(6, 4).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    w0 = rng.randn(4).astype(np.float32)
    jw = JParameter(jnp.asarray(w0))
    jo = jopt.LBFGS(learning_rate=0.5, max_iter=6, parameters=[jw])
    ja, jb = paddle.to_tensor(A), paddle.to_tensor(b)

    def jclosure():
        jo.clear_grad()
        loss = ((ja @ jw - jb) ** 2).sum()
        loss.backward()
        return loss

    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    to = topt.LBFGS(learning_rate=0.5, max_iter=6, parameters=[tw])
    ta, tb = torch.from_numpy(A), torch.from_numpy(b)

    def tclosure():
        to.clear_grad()
        loss = ((ta @ tw - tb) ** 2).sum()
        loss.backward()
        return loss

    for _ in range(2):
        jo.step(jclosure)
        to.step(tclosure)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.value),
                               rtol=1e-4, atol=1e-5)


# -- clips ---------------------------------------------------------------------


@pytest.mark.parametrize("clip,arg", [("ClipGradByGlobalNorm", 0.5),
                                      ("ClipGradByGlobalNorm", 1e3),
                                      ("ClipGradByNorm", 1.0),
                                      ("ClipGradByValue", 0.7)])
def test_clip_matches_reference(clip, arg):
    """The clipped gradients (the third parameter has need_clip False and
    passes through) and, for the global norm, its scale."""
    params, grads = _case(7, steps=1)
    jp, tp = _jax_params(params), _torch_params(params)
    jp[2].need_clip = False
    tp[2].need_clip = False
    jout = getattr(jclip, clip)(arg)(
        [(p, paddle.to_tensor(g)) for p, g in zip(jp, grads[0])])
    tout = getattr(tclip, clip)(arg)(
        [(p, torch.from_numpy(g)) for p, g in zip(tp, grads[0])])
    for (_, a), (_, b) in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.value), **TOL)
    assert torch.equal(tout[2][1], torch.from_numpy(grads[0][2]))
    if clip == "ClipGradByGlobalNorm":
        pairs = [(p, paddle.to_tensor(g)) for p, g in zip(jp, grads[0])]
        jn = math.sqrt(float(jclip.ClipGradByGlobalNorm(arg)
                             ._global_norm_sq(pairs)))
        tn = math.sqrt(float(tclip.ClipGradByGlobalNorm(arg)._global_norm_sq(
            [(p, torch.from_numpy(g)) for p, g in zip(tp, grads[0])])))
        np.testing.assert_allclose(tn, jn, rtol=1e-6)
        np.testing.assert_allclose(min(arg / max(tn, 1e-6), 1.0),
                                   min(arg / max(jn, 1e-6), 1.0), rtol=1e-6)


@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
def test_clip_grad_norm_and_value_match_reference(norm_type):
    params, grads = _case(8, steps=1)
    jp, tp = _jax_params(params), _torch_params(params)
    for p, q, g in zip(jp, tp, grads[0]):
        p.grad = paddle.to_tensor(g * 3)
        q.grad = torch.from_numpy(g * 3)
    jn = jclip.clip_grad_norm_(jp, 1.0, norm_type)
    tn = tclip.clip_grad_norm_(tp, 1.0, norm_type)
    np.testing.assert_allclose(float(tn), float(jn.value), rtol=1e-6)
    jclip.clip_grad_value_(jp, 0.05)
    tclip.clip_grad_value_(tp, 0.05)
    for p, q in zip(jp, tp):
        np.testing.assert_allclose(q.grad.numpy(), np.asarray(p.grad.value),
                                   **TOL)


# -- state_dict ----------------------------------------------------------------


def _adamw_warmup(params):
    return topt.AdamW(
        learning_rate=tlr.LinearWarmup(tlr.CosineAnnealingDecay(0.01, 10),
                                       3, 0.0, 0.01),
        parameters=params, weight_decay=0.1,
        grad_clip=tclip.ClipGradByGlobalNorm(1.0))


def test_state_dict_round_trip_is_bitwise():
    """Two AdamW steps (LinearWarmup, global-norm clip), the state_dict into
    a fresh optimizer over a copy of the parameters: the same state,
    bitwise, and the third step gives bitwise the same parameters."""
    params, grads = _case(9, steps=3)
    a = _torch_params(params)
    oa = _adamw_warmup(a)
    for gs in grads[:2]:
        for p, g in zip(a, gs):
            p.grad = torch.from_numpy(g)
        oa.step()
        oa._learning_rate.step()
    sd = oa.state_dict()
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    ob = _adamw_warmup(b)
    ob.set_state_dict(sd)
    sd_b = ob.state_dict()
    assert sorted(sd_b) == sorted(sd)
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(sd_b[k], v), k
            assert sd_b[k] is not v
        else:
            assert sd_b[k] == v, k
    for opt, ps in ((oa, a), (ob, b)):
        for p, g in zip(ps, grads[2]):
            p.grad = torch.from_numpy(g)
        opt.step()
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_named_parameters_give_structured_names():
    lin = ColumnParallelLinear(3, 2, device="cpu")
    opt = topt.Adam(learning_rate=0.1, parameters=lin.named_parameters())
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    assert {"weight_moment1", "bias_moment1", "weight_beta1_pow"} <= set(
        opt.state_dict())


# -- main-gradient mixed precision ---------------------------------------------


def _mp_pair(seed=11):
    """A JAX Linear(8, 4) and the port's twin from the same fp32 weights,
    both wrapped in MixPrecisionLayer (bf16)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(8, 4).astype(np.float32) * 0.3
    bias = rng.randn(4).astype(np.float32) * 0.1
    jl = paddle.nn.Linear(8, 4)
    jl.weight._value = jnp.asarray(w)
    jl.bias._value = jnp.asarray(bias)
    tl = ColumnParallelLinear(8, 4, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.copy_(torch.from_numpy(bias))
    return jmp.MixPrecisionLayer(jl), tmp.MixPrecisionLayer(tl)


def test_mix_precision_matches_reference():
    """Two micro-batches into main_grad, then a MixPrecisionOptimizer(AdamW)
    step, twice: main_grad fp32 and the sum of the micro-batches' bf16
    gradients, the masters fp32, the parameters bf16, all within bf16
    tolerance of the reference's."""
    jm, tm = _mp_pair()
    jparams = [jm._layers.weight, jm._layers.bias]
    tparams = [tm._layers.weight, tm._layers.bias]
    jo = jmp.MixPrecisionOptimizer(jopt.AdamW(
        learning_rate=0.01, parameters=jparams, weight_decay=0.1))
    to = tmp.MixPrecisionOptimizer(topt.AdamW(
        learning_rate=0.01, parameters=tparams, weight_decay=0.1))
    rng = np.random.RandomState(12)
    for _ in range(2):
        for _ in range(2):
            x = rng.randn(3, 8).astype(np.float32)
            (jm(paddle.to_tensor(jnp.asarray(x, jnp.bfloat16))) ** 2) \
                .mean().backward()
            y = tm(torch.from_numpy(x).to(torch.bfloat16))
            (y.float() ** 2).mean().backward()
        for p, q in zip(jparams, tparams):
            assert q.grad is None                 # cleared by the hook
            assert q.main_grad.dtype == torch.float32
            np.testing.assert_allclose(
                q.main_grad.numpy(), np.asarray(p.main_grad.value),
                rtol=2e-2, atol=2e-2)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        for p, q in zip(jparams, tparams):
            assert q.dtype == torch.bfloat16 and q.main_grad is None
            master = to._masters[id(q)]
            assert master.dtype == torch.float32
            np.testing.assert_allclose(master.numpy(), np.asarray(
                jo._masters[id(p)]), rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(
                q.detach().float().numpy(),
                np.asarray(p.value.astype(jnp.float32)),
                rtol=BF16_STEP, atol=1e-3)
            assert torch.equal(q.detach(), master.to(torch.bfloat16))


def test_mix_precision_state_dict_carries_the_masters():
    _, tm = _mp_pair()
    tparams = [tm._layers.weight, tm._layers.bias]
    to = tmp.MixPrecisionOptimizer(topt.AdamW(learning_rate=0.01,
                                              parameters=tparams))
    tm(torch.ones(2, 8, dtype=torch.bfloat16)).float().sum().backward()
    to.step()
    sd = to.state_dict()
    assert set(sd["mix_precision_masters"]) == {"param_0", "param_1"}
    _, tm2 = _mp_pair(seed=99)
    to2 = tmp.MixPrecisionOptimizer(topt.AdamW(
        learning_rate=0.01,
        parameters=[tm2._layers.weight, tm2._layers.bias]))
    to2.set_state_dict(dict(sd))
    for q, q2 in zip(tparams, [tm2._layers.weight, tm2._layers.bias]):
        assert torch.equal(q.detach(), q2.detach())
        assert torch.equal(to._masters[id(q)], to2._masters[id(q2)])


def test_mix_precision_scaler_unscales_main_grad_and_skips_inf():
    _, tm = _mp_pair()
    tparams = [tm._layers.weight, tm._layers.bias]
    opt = tmp.MixPrecisionOptimizer(topt.SGD(learning_rate=0.1,
                                             parameters=tparams))
    sc = tmp.MixPrecisionScaler(GradScaler(init_loss_scaling=8.0))
    x = torch.ones(2, 8, dtype=torch.bfloat16)
    sc.scale(tm(x).float().sum()).backward()
    want = tparams[1].main_grad / 8.0
    w0 = tparams[0].detach().clone()
    sc.step(opt)
    sc.update()
    assert not torch.equal(tparams[0].detach(), w0)
    assert torch.equal(tparams[1].main_grad, want)
    opt.clear_grad()
    sc.scale(tm(x).float().sum()).backward()
    tparams[0].main_grad[0, 0] = float("inf")
    w1 = tparams[0].detach().clone()
    sc.step(opt)
    sc.update()
    assert torch.equal(tparams[0].detach(), w1)       # skipped
    assert sc._scaler.get_loss_scaling() == 4.0
