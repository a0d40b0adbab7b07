"""paddle_tpu_torch's AMP against paddle_tpu's, on the CPU.

- The policy: under O1 and O2, bf16 and fp16, every op name of the
  reference's white and black lists and the port's gray ops get the dtype
  the reference's ``cast_dtype_for`` gives them, custom lists included.
- The ops: each list's ops compute in that dtype, one assertion per list
  and level (a linear and the flash attention for white; RMSNorm, the
  cross entropies and the masked mean for black; RoPE, the embedding and a
  gray loss for gray), and gradients arrive in each leaf's dtype.
- ``decorate(level="O2")``: every parameter of the tiny Llama in the
  dtype the reference's ``decorate`` gives its twin (norms fp32).
- The tiny Llama's loss under O1, and decorated under O2, against the JAX
  package's at bf16 tolerance (both sides round the same products to bf16
  in other orders: 2e-2 of a loss near 5.5).
- ``GradScaler``: the scale after every update and the skipped steps over
  nine steps with two injected infs equal the reference's, the
  parameters allclose; its errors and ``state_dict``.
- ``amp.debugging`` and ``FLAGS_check_nan_inf``: the counts of
  ``check_numerics``, the op-level check raising on a kernel op's inf
  output, the tensor checker and the operator statistics; with the flag
  off and no checker, no check runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.core import amp_state as jstate
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_config
from paddle_tpu.nn.parameter import Parameter as JParameter
from paddle_tpu.optimizer import optimizer as jopt
from paddle_tpu_torch import (LlamaForCausalLM, amp, llama_config,
                              load_paddle_params, set_flags)
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.framework import amp_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.distributed.mp_layers import (ColumnParallelLinear,
                                                    ParallelCrossEntropy,
                                                    VocabParallelEmbedding)
from paddle_tpu_torch.models._utils import masked_lm_loss
from paddle_tpu_torch.ops import flash_attention, fused_rope, rms_norm
from paddle_tpu_torch.optimizer import optimizer as topt

BF16_LOSS_RTOL = 2e-2
JAX_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
              jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.float16): torch.float16}
GRAY = ("fused_rope", "embedding", "l1_loss", "tied_lm_head",
        "bce_with_logits")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the model is tiny, and a thread pool on a
    machine whose cores other test workers hold waits at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the policy ------------------------------------------------------------------


@pytest.mark.parametrize("custom", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_policy_gives_every_op_the_reference_dtype(level, dtype, custom):
    names = sorted(jamp.WHITE_LIST | jamp.BLACK_LIST | set(GRAY))
    kw = dict(level=level, dtype=dtype)
    if custom:
        kw.update(custom_white_list={"rms_norm"},
                  custom_black_list={"linear", "fused_rope"})
    with amp.auto_cast(**kw):
        got = {n: amp_state.cast_dtype_for(n) for n in names}
    with jamp.auto_cast(**kw):
        want = {n: jstate.cast_dtype_for(n) for n in names}
    assert got == {n: None if d is None else JAX_DTYPES[jnp.dtype(d)]
                   for n, d in want.items()}
    assert amp_state.cast_dtype_for("linear") is None   # restored on exit


def _ops(level):
    """Each list's ops on fp32 inputs under auto_cast(level, bf16):
    {list: [output dtypes]}."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 4, 16, generator=g)
    lin = ColumnParallelLinear(16, 16, device="cpu")
    emb = VocabParallelEmbedding(32, 16, device="cpu")
    logits = torch.randn(2, 8, 32, generator=g)
    labels = torch.randint(0, 32, (2, 8), generator=g)
    cos, sin = torch.randn(8, 8, generator=g), torch.randn(8, 8, generator=g)
    with amp.auto_cast(level=level):
        out = {
            "white": [lin(x).dtype, flash_attention(x, x, x,
                                                    causal=True).dtype],
            "black": [rms_norm(x.bfloat16(), torch.ones(16)).dtype,
                      F.cross_entropy(logits.bfloat16(), labels).dtype,
                      ParallelCrossEntropy()(logits.bfloat16(),
                                             labels).dtype,
                      masked_lm_loss(torch.ones(2, 8).bfloat16(),
                                     labels).dtype],
            "gray": [fused_rope(x, cos, sin).dtype, emb(labels).dtype,
                     F.l1_loss(x, x).dtype]}
    return out


@pytest.mark.parametrize("kind", ["white", "black", "gray"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_each_list_computes_in_its_dtype(level, kind):
    want = {"white": torch.bfloat16, "black": torch.float32,
            "gray": torch.float32 if level == "O1" else torch.bfloat16}
    assert set(_ops(level)[kind]) == {want[kind]}


def test_gradients_arrive_in_the_leaf_dtype():
    lin = ColumnParallelLinear(16, 8, device="cpu")
    x = torch.randn(4, 16, requires_grad=True)
    with amp.auto_cast(level="O1", dtype="float16"):
        y = lin(x)
    assert y.dtype == torch.float16
    y.float().sum().backward()
    assert x.grad.dtype == torch.float32
    assert lin.weight.grad.dtype == torch.float32


def test_nested_disable_and_bad_level():
    with amp.auto_cast(level="O2"):
        with amp.auto_cast(enable=False):
            assert amp_state.cast_dtype_for("linear") is None
        assert amp_state.cast_dtype_for("add") == torch.bfloat16
    with pytest.raises(ValueError):
        with amp.auto_cast(level="O3"):
            pass
    with pytest.raises(ValueError):
        amp.decorate(torch.nn.Linear(2, 2), level="O0")


# -- the tiny Llama --------------------------------------------------------------


def _pair(seed=3):
    paddle.seed(seed)
    jm = JaxLlama(jax_config("tiny", num_hidden_layers=2))
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=2),
                             device="cpu")
    load_paddle_params(model, {k: np.asarray(p.value)
                               for k, p in jm.named_parameters()})
    return jm, model


def _batch(seed=4):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (8, 16)).astype(np.int32)
    labels = rng.randint(0, 256, (8, 16)).astype(np.int32)
    labels[0, :3] = -100
    return ids, labels


def test_decorate_o2_casts_as_the_reference():
    jm, model = _pair()
    jamp.decorate(jm, level="O2", dtype="bfloat16")
    assert amp.decorate(model, level="O2", dtype="bfloat16") is model
    want = {k: JAX_DTYPES[jnp.dtype(p.value.dtype)]
            for k, p in jm.named_parameters()}
    got = {k: p.dtype for k, p in model.named_parameters()}
    assert got == want
    assert got["model.norm.weight"] == torch.float32
    assert got["lm_head.weight"] == torch.bfloat16


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tiny_llama_loss_matches_the_reference(level):
    jm, model = _pair()
    if level == "O2":
        jamp.decorate(jm, level="O2")
        amp.decorate(model, level="O2")
    ids, labels = _batch()
    with jamp.auto_cast(level=level):
        jloss = float(jm(paddle.to_tensor(ids), paddle.to_tensor(labels)))
    with amp.auto_cast(level=level):
        loss = model(torch.from_numpy(ids).long(),
                     torch.from_numpy(labels).long())
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), jloss, rtol=BF16_LOSS_RTOL)
    loss.backward()
    for k, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == p.dtype, k
        assert torch.isfinite(p.grad).all(), k


@pytest.mark.parametrize("level,dtype", [("O1", "bfloat16"),
                                         ("O2", "float16")])
def test_recompute_reruns_the_forward_under_its_amp_policy(level, dtype):
    """The backward reruns each layer outside the auto_cast block; it must
    run under the forward's policy: gradients with recompute="full" are
    bitwise those without."""
    ids, labels = (torch.from_numpy(a).long() for a in _batch())
    grads = []
    for recompute in ("none", "full"):
        model = LlamaForCausalLM(llama_config(
            "tiny", num_hidden_layers=2, recompute=recompute), device="cpu")
        if level == "O2":
            amp.decorate(model, level="O2", dtype=dtype)
        with amp.auto_cast(level=level, dtype=dtype):
            loss = model(ids, labels)
        loss.backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k


# -- GradScaler ----------------------------------------------------------------

SCALER = dict(init_loss_scaling=1024.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=1)
INF_STEPS = (2, 5)


def test_grad_scaler_trajectory_matches_the_reference():
    """Nine SGD steps on gradients scaled by the current scale, an inf
    injected at steps 2 and 5: the scale after each update and which steps
    were skipped equal the reference's; parameters allclose."""
    rng = np.random.RandomState(6)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(9)]
    jp, tp = JParameter(jnp.asarray(w0)), torch.nn.Parameter(
        torch.from_numpy(w0.copy()))
    jo = jopt.SGD(learning_rate=0.1, parameters=[jp])
    to = topt.SGD(learning_rate=0.1, parameters=[tp])
    js, ts = jamp.GradScaler(**SCALER), amp.GradScaler(**SCALER)
    got, want = [], []
    for i, g in enumerate(grads):
        for sc, p, out, wrap in ((js, jp, want, paddle.to_tensor),
                                 (ts, tp, got, torch.from_numpy)):
            gs = g * sc.get_loss_scaling()
            if i in INF_STEPS:
                gs[1, 2] = np.inf
            p.grad = wrap(gs.astype(np.float32))
            before = np.array(p.value if p is jp else p.detach())
            sc.step(jo if p is jp else to)
            sc.update()
            after = np.array(p.value if p is jp else p.detach())
            out.append((sc.get_loss_scaling(),
                        bool(np.array_equal(before, after))))
    assert got == want
    assert [s for s, _ in got] == [1024.0, 1024.0, 512.0, 512.0, 512.0,
                                   256.0, 256.0, 256.0, 512.0]
    assert [i for i, (_, skipped) in enumerate(got) if skipped] == list(
        INF_STEPS)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp.value),
                               rtol=1e-6, atol=1e-7)


def test_grad_scaler_errors_and_state_dict():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.SGD(learning_rate=0.1, parameters=[p])
    sc = amp.GradScaler(init_loss_scaling=8.0)
    p.grad = torch.ones(3) * 8
    sc.unscale_(opt)
    assert torch.equal(p.grad, torch.ones(3))
    sc.unscale_(opt)                              # a second call: no-op
    assert torch.equal(p.grad, torch.ones(3))
    sc.step(opt)
    with pytest.raises(RuntimeError, match="after step"):
        sc.unscale_(opt)
    with pytest.raises(RuntimeError, match="already been called"):
        sc.step(opt)
    sc.update()
    sd = sc.state_dict()
    ref = jamp.GradScaler(init_loss_scaling=8.0)
    ref._incr_count = 1
    assert sorted(sd) == sorted(ref.state_dict())
    assert {k: float(v) for k, v in sd.items()} == {
        k: float(v) for k, v in ref.state_dict().items()}
    other = amp.GradScaler()
    other.load_state_dict(sd)
    assert other.get_loss_scaling() == 8.0 and other._incr_count == 1
    off = amp.GradScaler(enable=False)
    assert off.scale(p) is p and off.state_dict() == {}


# -- debugging and FLAGS_check_nan_inf -------------------------------------------


def test_check_numerics_counts_as_the_reference():
    x = np.array([1.0, np.nan, np.inf, 0.0, -np.inf, 0.0], np.float32)
    got = debugging.check_numerics(torch.from_numpy(x), debug_mode=
                                   debugging.DebugMode.CHECK_NAN_INF)
    want = jamp.debugging.check_numerics(
        paddle.to_tensor(x), debug_mode=jamp.debugging.DebugMode.CHECK_NAN_INF)
    assert [int(v) for v in got] == [int(v) for v in want] == [1, 2, 2]
    with pytest.raises(RuntimeError, match="nan=1 inf=2"):
        debugging.check_numerics(torch.from_numpy(x))


def test_flag_check_nan_inf_raises_on_a_kernel_output():
    x = torch.ones(2, 16)
    x[1, 3] = float("inf")
    w = torch.ones(16)
    assert torch.isnan(rms_norm(x, w)).any()     # off: passes through
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(RuntimeError, match="rms_norm.*FLAGS_check"):
            rms_norm(x, w)
        rms_norm(torch.ones(2, 16), w)            # finite: no error
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
    assert not amp_state.amp_state.check_nan_inf


def test_checks_run_only_when_asked(monkeypatch):
    """Flag off and no checker: a forward and backward of the tiny Llama
    runs no check (``torch.isfinite`` is never called)."""
    _, model = _pair()
    calls = []
    real = torch.isfinite
    monkeypatch.setattr(torch, "isfinite",
                        lambda t: calls.append(1) or real(t))
    ids, labels = _batch()
    model(torch.from_numpy(ids).long(),
          torch.from_numpy(labels).long()).backward()
    assert calls == []


def test_tensor_checker_and_operator_stats():
    lin = ColumnParallelLinear(16, 16, device="cpu")
    x = torch.randn(4, 16)
    with debugging.collect_operator_stats():
        with amp.auto_cast(level="O1"):
            rms_norm(lin(x), torch.ones(16))
        stats = dict(debugging._op_stats)
    assert stats == {"linear": {"bfloat16": 1}, "rms_norm": {"float32": 1}}
    assert amp_state.amp_state.checker is None
    cfg = debugging.TensorCheckerConfig(
        enable=True, debug_mode=debugging.DebugMode.CHECK_NAN_INF,
        checked_op_list=["rms_norm"])
    debugging.enable_tensor_checker(cfg)
    try:
        bad = x.clone()
        bad[0, 0] = float("nan")
        rms_norm(bad, torch.ones(16))
        lin(bad)                                   # not a checked op
        assert len(cfg._found) == 1 and "op=rms_norm" in cfg._found[0]
        cfg.debug_mode = debugging.DebugMode.CHECK_NAN_INF_AND_ABORT
        with pytest.raises(RuntimeError, match="num_nan=16"):
            rms_norm(bad, torch.ones(16))
    finally:
        debugging.disable_tensor_checker()
    assert amp_state.amp_state.checker is None
