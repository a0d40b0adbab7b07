"""paddle_tpu_torch's incubate.nn.functional entry points and
``memory_efficient_attention`` against paddle_tpu's, on the CPU.

Each function on the same numpy inputs on both sides; where it is
differentiable, the gradients of ``sum(out * ct)`` for a seeded cotangent
too (the JAX side's forward and ``jax.vjp`` as one ``jax.jit`` program,
its tape off). Where the JAX function reaches a Pallas kernel (K1
``rms_norm``, K2 ``fused_rope``, K3 flash attention) it runs it as the JAX
package's own tests do on the CPU, in interpret mode; the port runs its
kernels' plain versions, and the test checks that the port took its
kernel's wrapper exactly where the reference takes its kernel:

- ``fused_rms_norm`` (K1);
- ``fused_rotary_position_embedding``: the NeoX layout with [S, D/2] and
  paddle's [1, S, 1, D] tables (K2), with ``position_ids`` and in the
  interleaved GPT-J layout (torch ops, as the reference's jnp), q and k
  given and v None;
- ``weight_quantize`` (int8 and int4: the quantized weights equal, the
  scales equal), ``weight_dequantize``, ``weight_only_linear`` with a bias;
- ``fused_linear`` (the weight as given and transposed) and
  ``fused_linear_activation`` (gelu, relu, none; operands transposed);
- ``memory_efficient_attention`` without a bias (K3, non-causal) and with
  an additive bias (the reference's composition).

Tolerance: float32 on both sides, the same arithmetic summed in another
order: atol = rtol = 1e-5 at magnitudes of order 1, as in
test_torch_training.py; quantized weights are held equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import functional as JF
from paddle_tpu.incubate.nn import memory_efficient_attention as jmea
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.incubate.nn import memory_efficient_attention
from paddle_tpu_torch.ops import flash_attention_kernel as fk
from paddle_tpu_torch.ops import fused_kernels
from torch_jax_state import jax_reference_state, one_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _value(out):
    return out.value if isinstance(out, Tensor) else out


def _jax(fn, arrays, seed):
    """(outputs, input gradients) of ``fn`` on the JAX package: the forward
    and its vjp for ``sum(out * ct)`` as one ``jax.jit``."""
    def fwd(*vals):
        with no_grad():
            out = fn(*[Tensor(v) for v in vals])
        return (tuple(_value(o) for o in out) if isinstance(out, tuple)
                else _value(out))

    shapes = jax.eval_shape(fwd, *arrays)
    rng = np.random.RandomState(seed)
    ct = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.randn(*s.shape), s.dtype), shapes)

    @jax.jit
    def both(*vals):
        out, vjp = jax.vjp(fwd, *vals)
        return out, vjp(ct)

    out, grads = both(*[jnp.asarray(a) for a in arrays])
    return out, grads, ct


def _torch(fn, arrays, ct):
    xs = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    cts = ct if isinstance(ct, tuple) else (ct,)
    sum((o * torch.from_numpy(np.array(c))).sum()
        for o, c in zip(outs, cts)).backward()
    return out, [x.grad for x in xs]


def _held(jfn, tfn, arrays, seed):
    jout, jgrads, ct = _jax(jfn, arrays, seed)
    tout, tgrads = _torch(tfn, arrays, ct)
    for o, w in zip(tout if isinstance(tout, tuple) else (tout,),
                    jout if isinstance(jout, tuple) else (jout,)):
        np.testing.assert_allclose(o.detach().numpy(), _np(w), **TOL)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a: calls.append(1) or real(*a))
    return calls


def test_fused_rms_norm_matches_jax(monkeypatch):
    calls = _counting(monkeypatch, fused_kernels, "_rms_norm_fwd")
    rng = np.random.RandomState(1)
    x = rng.randn(4, 8, 64).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    _held(lambda a, b: JF.fused_rms_norm(a, b, epsilon=1e-5),
          lambda a, b: IF.fused_rms_norm(a, b, epsilon=1e-5), [x, w], 2)
    assert calls


def _rope_tables(s, d, four_d=False):
    inv = 1.0 / (10000 ** (np.arange(0, d, 2) / d))
    ang = np.outer(np.arange(s), inv)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    if four_d:                    # paddle's layout: halves duplicated
        cos = np.concatenate([cos, cos], -1)[None, :, None, :]
        sin = np.concatenate([sin, sin], -1)[None, :, None, :]
    return cos, sin


@pytest.mark.parametrize("case", ["neox", "neox_4d", "position_ids",
                                  "gptj"])
def test_fused_rotary_position_embedding_matches_jax(case, monkeypatch):
    calls = _counting(monkeypatch, fused_kernels, "_rope_fwd")
    b, s, h, d = 2, 8, 4, 16
    rng = np.random.RandomState(3)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, h, d).astype(np.float32)
    cos, sin = _rope_tables(2 * s if case == "position_ids" else s, d,
                            case == "neox_4d")
    pids = (rng.randint(0, 2 * s, (b, s)) if case == "position_ids"
            else None)
    neox = case != "gptj"

    def call(mod):
        def f(qq, kk):
            out = mod.fused_rotary_position_embedding(
                qq, kk, None, sin=sin, cos=cos, position_ids=pids,
                use_neox_rotary_style=neox)
            assert out[2] is None
            return out[0], out[1]
        return f

    _held(call(JF), call(IF), [q, k], 4)
    # K2 where the reference takes its kernel: forward of q and k, and the
    # backward of each
    assert len(calls) == (4 if case in ("neox", "neox_4d") else 0)


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_only_quantization_matches_jax(algo):
    rng = np.random.RandomState(5)
    w = rng.randn(64, 48).astype(np.float32)
    w[:, 3] = 0.0                                  # an all-zero channel
    jq, js = JF.weight_quantize(paddle.to_tensor(w), algo=algo)
    tq, ts = IF.weight_quantize(torch.from_numpy(w), algo=algo)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.value))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.value))
    np.testing.assert_array_equal(
        IF.weight_dequantize(tq, ts, algo=algo).numpy(),
        np.asarray(JF.weight_dequantize(jq, js, algo=algo).value))
    x = rng.randn(4, 64).astype(np.float32)
    bias = rng.randn(48).astype(np.float32)
    kind = algo[len("weight_only_"):]
    want = JF.weight_only_linear(paddle.to_tensor(x), jq, paddle.to_tensor(
        bias), weight_scale=js, weight_dtype=kind)
    got = IF.weight_only_linear(torch.from_numpy(x), tq,
                                torch.from_numpy(bias), weight_scale=ts,
                                weight_dtype=kind)
    np.testing.assert_allclose(got.numpy(), _np(want.value), **TOL)
    with pytest.raises(NotImplementedError):
        IF.weight_only_linear(torch.from_numpy(x), tq, weight_scale=ts,
                              group_size=64)


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_matches_jax(transpose):
    rng = np.random.RandomState(6)
    x = rng.randn(3, 5, 32).astype(np.float32)
    w = rng.randn(*((24, 32) if transpose else (32, 24))).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    _held(lambda a, b, c: JF.fused_linear(a, b, c, transpose_weight=transpose),
          lambda a, b, c: IF.fused_linear(a, b, c, transpose_weight=transpose),
          [x, w, bias], 7)


@pytest.mark.parametrize("activation", ["gelu", "relu", "none"])
@pytest.mark.parametrize("trans_x,trans_y", [(False, False), (True, True)])
def test_fused_linear_activation_matches_jax(activation, trans_x, trans_y):
    rng = np.random.RandomState(8)
    x = rng.randn(*((32, 6) if trans_x else (6, 32))).astype(np.float32)
    y = rng.randn(*((24, 32) if trans_y else (32, 24))).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)

    def call(mod):
        return lambda a, b, c: mod.fused_linear_activation(
            a, b, c, trans_x=trans_x, trans_y=trans_y, activation=activation)

    _held(call(JF), call(IF), [x, y, bias], 9)


@pytest.mark.parametrize("with_bias", [False, True])
def test_memory_efficient_attention_matches_jax(with_bias, monkeypatch):
    calls = _counting(monkeypatch, fk, "flash_attention_bshd")
    b, s, h, d = 2, 16, 4, 16
    rng = np.random.RandomState(10)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    if with_bias:
        bias = rng.randn(b, h, s, s).astype(np.float32)
        _held(lambda a, c, e: jmea(a, c, e, attn_bias=Tensor(bias),
                                   scale=0.3),
              lambda a, c, e: memory_efficient_attention(
                  a, c, e, attn_bias=torch.from_numpy(bias), scale=0.3),
              [q, k, v], 11)
    else:
        _held(jmea, memory_efficient_attention, [q, k, v], 11)
    # K3 non-causal without a bias, the composition with one
    assert calls == ([] if with_bias else [1])
