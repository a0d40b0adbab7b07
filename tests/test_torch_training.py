"""paddle_tpu_torch's training path against paddle_tpu's, on the CPU.

- The dropout keep-mask of the port equals the JAX kernel's bit for bit.
- Flash attention forward and backward (the port's plain versions, through
  its autograd Function) against the Pallas kernels in interpret mode and
  ``jax.vjp``, with and without dropout at the same seed; and the plain
  backward in bf16, which rounds dS and P_drop where the Pallas kernels do
  (its own tolerance, stated in the test).
- RMSNorm and RoPE gradients against ``jax.vjp`` of the Pallas wrappers.
- AdamW, the global-norm clip and SGD against ``paddle_tpu.optimizer.
  functional`` over three updates.
- The slice as a whole: the port's ``build_train_step`` against JAX's
  (weights carried across in stacked form), and the Layer API's gradients
  with full recompute against ``jax.grad`` through ``functional_call``.
- The selective remat policies of ``build_train_step`` ("attn_out",
  "dots"): loss and gradients bitwise those of "full" on the CPU, with
  their flash forwards counted, and allclose to the reference's policies.
- The fault this slice repaired: a kernel's output has no ``grad_fn``; the
  autograd Functions must still route every gradient through the ported
  backward.

Tolerance: float32 on both sides (the JAX side at
``jax_default_matmul_precision="highest"``, set by conftest), the same
arithmetic summed in another order, so results differ by a few fp32 ulps:
atol = rtol = 1e-5 at magnitudes of order 1, as in test_torch_kernels.py.
Updated parameters after AdamW get atol 5e-5 (5% of lr = 1e-3): each
element moves by lr m_hat / (sqrt(v_hat) + eps), a ratio that turns a
relative gradient difference of 1e-6 into up to ~1e-2 of lr where |g| is
within a few eps of zero.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_config
from paddle_tpu.models import llama_functional as jax_functional
from paddle_tpu.nn.functional_call import functional_call
from paddle_tpu.ops import flash_attention_kernel as jax_flash
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.optimizer import functional as jax_opt
from paddle_tpu_torch import (LlamaForCausalLM, build_train_step,
                              llama_config, load_paddle_params,
                              load_stacked_params)
from paddle_tpu_torch.models import llama_functional
from paddle_tpu_torch.ops import attention
from paddle_tpu_torch.ops import flash_attention_kernel as fk
from paddle_tpu_torch.ops import fused_kernels
from paddle_tpu_torch.optimizer import functional as opt

TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=5e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- dropout hash ------------------------------------------------------------


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("b,h,q0,k0", [(0, 0, 0, 0), (3, 5, 64, 128),
                                       (1, 7, 1000, 8), (6, 2, 8, 4096)])
@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 31 - 1])
def test_keep_mask_matches_jax_bitwise(seed, b, h, q0, k0, p):
    want = np.asarray(jax_flash._keep_mask(
        jnp.int32(seed), jnp.int32(b), jnp.int32(h), jnp.int32(q0),
        jnp.int32(k0), 8, 16, p))
    got = fk._keep_mask(seed, b, h, q0, k0, 8, 16, p).numpy()
    np.testing.assert_array_equal(got, want)


def test_keep_mask_rate_follows_p():
    keep = fk._keep_mask(11, 0, 0, 0, 0, 256, 256, 0.25)
    assert abs(keep.float().mean().item() - 0.75) < 0.01


# -- flash attention forward and backward ------------------------------------


def _flash_case(b, sq, sk, hq, hkv, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in
            ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
             (b, sq, hq, d))]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,hq,hkv", [(16, 16, 4, 4), (16, 16, 4, 2),
                                          (8, 16, 4, 2), (16, 8, 4, 4)])
def test_flash_fwd_bwd_match_pallas(sq, sk, hq, hkv, causal, dropout,
                                    monkeypatch):
    """Output and (dq, dk, dv) for a random cotangent, against the Pallas
    kernels in interpret mode (8 x 8 blocks) under ``jax.vjp``. The port's
    gradient must come from its ported backward."""
    q, k, v, do = _flash_case(1, sq, sk, hq, hkv, 16, seed=sq + hkv)
    seed = 5
    tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731

    def jf(q_, k_, v_):
        return jax_flash.flash_attention_bhsd(
            q_, k_, v_, causal=causal, dropout_p=dropout, seed=seed,
            block_q=8, block_k=8, interpret=True)

    out_j, vjp = jax.vjp(jf, tr(q), tr(k), tr(v))
    grads_j = vjp(tr(do))

    calls = []
    real = fk.flash_attention_bwd
    monkeypatch.setattr(fk, "flash_attention_bwd",
                        lambda *a: calls.append(1) or real(*a))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = attention.flash_attention(qt, kt, vt, causal=causal,
                                    dropout_p=dropout, seed=seed)
    out.backward(_t(do))
    assert calls == [1]
    np.testing.assert_allclose(out.detach().numpy(),
                               _np(out_j).transpose(0, 2, 1, 3), **TOL)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(),
                                   _np(want).transpose(0, 2, 1, 3), **TOL)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("sq,sk,hq,hkv,d", [(64, 64, 2, 2, 64),
                                            (64, 64, 4, 1, 16),
                                            (48, 64, 4, 2, 16)])
def test_flash_bwd_plain_rounds_like_pallas_in_bf16(sq, sk, hq, hkv, d,
                                                    dropout):
    """bf16, causal, GQA: the plain backward on the Pallas forward's out
    and lse against the Pallas backward kernels in interpret mode (16 x 16
    blocks) under ``jax.vjp``. Both round dS and P_drop to bf16 before the
    second products and sum in fp32, so they agree but where a score's
    fp32 value differs by an ulp across a bf16 rounding boundary, which
    moves one output by a fraction of a bf16 step (6.1e-5 at most over
    these cases). Tolerance: atol 1e-3, rtol 2^-8 (half a bf16 step).
    Without the rounding the plain version is one to several bf16 steps
    away (0.0039-0.0625 at outputs up to 9)."""
    q, k, v, do = _flash_case(1, sq, sk, hq, hkv, d, seed=sq + hkv + d)
    seed, scale = 5, 1.0 / math.sqrt(d)
    bf = jnp.bfloat16
    qj, kj, vj, doj = (jnp.asarray(a.transpose(0, 2, 1, 3), bf)
                       for a in (q, k, v, do))

    def jf(q_, k_, v_):
        return jax_flash.flash_attention_bhsd(
            q_, k_, v_, causal=True, dropout_p=dropout, seed=seed,
            block_q=16, block_k=16, interpret=True)

    _, vjp = jax.vjp(jf, qj, kj, vj)
    grads_j = vjp(doj)
    out_j, lse_j = jax_flash._fwd_impl(
        qj, kj, vj, jnp.asarray([seed], jnp.int32), True, scale, dropout,
        16, 16, True)

    def tt(a):      # [B, H, S, D] bf16 -> [B, S, H, D] bf16
        return torch.tensor(_np(a.astype(jnp.float32)).transpose(0, 2, 1, 3),
                            dtype=torch.bfloat16)

    grads = fk.flash_attention_bwd_ref(
        tt(qj), tt(kj), tt(vj), tt(out_j), torch.tensor(_np(lse_j)[..., 0]),
        tt(doj), True, None, dropout, seed)
    for got, want in zip(grads, grads_j):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(),
            _np(want.astype(jnp.float32)).transpose(0, 2, 1, 3),
            atol=1e-3, rtol=2.0 ** -8)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("sq,sk,hq,hkv,d", [(128, 128, 2, 2, 64),
                                            (128, 128, 4, 1, 16),
                                            (64, 192, 4, 2, 16)])
def test_flash_fwd_plain_rounds_like_pallas_in_bf16(sq, sk, hq, hkv, d,
                                                    dropout):
    """bf16, causal, MHA and GQA, Sq <= Sk: the plain forward against the
    Pallas forward (``_fwd_impl``, interpret mode) with key blocks of 64,
    K3's key tile (every length here is a multiple of 64, so
    ``_pick_block`` takes 64). Both update the running max per 64-key
    tile, round P (after dropout and its 1 / (1 - p) scale) to bf16 at
    that max before P.V and sum the normalizer over the unrounded p, so
    they agree but where a score's fp32 value differs by an ulp across a
    bf16 rounding boundary of P, which moves an output by a bf16 step or
    less: bitwise in 4 of the 6 cases, 9.8e-4 at most (at an output near
    0.2). Tolerance: atol 1e-3, rtol 2^-8 (half a bf16 step) on out, 1e-5
    on the fp32 lse. Without the rounding the plain version is up to
    0.0156 away at 36-42% of the outputs, and rounding at the running max
    of 512-key chunks up to 0.0039 at 6-23%."""
    q, k, v, _ = _flash_case(1, sq, sk, hq, hkv, d, seed=sq + hkv + d)
    seed, scale = 5, 1.0 / math.sqrt(d)
    qj, kj, vj = (jnp.asarray(a.transpose(0, 2, 1, 3), jnp.bfloat16)
                  for a in (q, k, v))
    out_j, lse_j = jax_flash._fwd_impl(
        qj, kj, vj, jnp.asarray([seed], jnp.int32), True, scale, dropout,
        64, 64, True)

    def tt(a):      # [B, H, S, D] bf16 -> [B, S, H, D] bf16
        return torch.tensor(_np(a.astype(jnp.float32)).transpose(0, 2, 1, 3),
                            dtype=torch.bfloat16)

    out, lse = fk.flash_attention_bshd_ref(tt(qj), tt(kj), tt(vj), True,
                                           None, dropout, seed)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(),
        _np(out_j.astype(jnp.float32)).transpose(0, 2, 1, 3),
        atol=1e-3, rtol=2.0 ** -8)
    np.testing.assert_allclose(lse.numpy(), _np(lse_j)[..., 0], **TOL)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("sq,sk,hq,hkv,d", [(128, 128, 2, 2, 64),
                                            (128, 128, 4, 1, 16),
                                            (64, 192, 4, 2, 16)])
def test_flash_fwd_plain_rounds_like_pallas_in_fp16(sq, sk, hq, hkv, d,
                                                    dropout):
    """As the bf16 test above, in fp16 (the dtype of the fp16 kernels): P
    is rounded to fp16 at each 64-key tile's running max on both sides.
    They agree but for single flips of P's rounding, one fp16 step of an
    output at most (1.2e-4 at outputs near 0.2, at 0.06-0.24% of them).
    Tolerance: atol 2e-4, rtol 2^-11 (half an fp16 step). Without the
    rounding the plain version is up to 0.002 away at 35-42% of the
    outputs."""
    q, k, v, _ = _flash_case(1, sq, sk, hq, hkv, d, seed=sq + hkv + d)
    seed, scale = 5, 1.0 / math.sqrt(d)
    qj, kj, vj = (jnp.asarray(a.transpose(0, 2, 1, 3), jnp.float16)
                  for a in (q, k, v))
    out_j, lse_j = jax_flash._fwd_impl(
        qj, kj, vj, jnp.asarray([seed], jnp.int32), True, scale, dropout,
        64, 64, True)

    def tt(a):      # [B, H, S, D] fp16 -> [B, S, H, D] fp16
        return torch.tensor(_np(a.astype(jnp.float32)).transpose(0, 2, 1, 3),
                            dtype=torch.float16)

    out, lse = fk.flash_attention_bshd_ref(tt(qj), tt(kj), tt(vj), True,
                                           None, dropout, seed)
    assert out.dtype == torch.float16
    np.testing.assert_allclose(
        out.float().numpy(),
        _np(out_j.astype(jnp.float32)).transpose(0, 2, 1, 3),
        atol=2e-4, rtol=2.0 ** -11)
    np.testing.assert_allclose(lse.numpy(), _np(lse_j)[..., 0], **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,width", [(16, 64), (96, 128)])
def test_flash_zero_padding_of_d_is_exact(d, width, dtype):
    """What the wrappers do on the card for a head dim between the
    kernels' widths: zero-pad q, k, v and dO to the width, run with the
    real head dim's scale, slice the outputs back. The padded columns add
    nothing to a score, so the plain forward and backward on padded
    inputs equal the unpadded ones (the same fp32 sums, with zeros; atol
    = rtol = 1e-5 in fp32, where only the order of the sums may change,
    and a bf16 step, 2^-7, in bf16), and the padded columns of out, dq,
    dk and dv are exactly zero."""
    q, k, v, do = (_t(a).to(dtype) for a in
                   _flash_case(2, 40, 72, 4, 2, d, seed=d))
    scale = 1.0 / math.sqrt(d)
    out, lse = fk.flash_attention_bshd_ref(q, k, v, True, None, 0.1, 3)
    grads = fk.flash_attention_bwd_ref(q, k, v, out, lse, do, True, None,
                                       0.1, 3)
    qp, kp, vp, dop = (fk._padded(t, width) for t in (q, k, v, do))
    assert qp.shape[-1] == width
    out_p, lse_p = fk.flash_attention_bshd_ref(qp, kp, vp, True, scale,
                                               0.1, 3)
    grads_p = fk.flash_attention_bwd_ref(qp, kp, vp, out_p, lse_p, dop,
                                         True, scale, 0.1, 3)
    tol = TOL if dtype == torch.float32 else dict(atol=1e-5,
                                                  rtol=2.0 ** -7)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), **TOL)
    for got, want in zip((out_p,) + grads_p, (out,) + grads):
        assert torch.equal(got[..., d:], torch.zeros_like(got[..., d:]))
        np.testing.assert_allclose(fk._sliced(got, d).float().numpy(),
                                   want.float().numpy(), **tol)


def test_flash_bwd_rows_without_keys_get_zero_dq():
    q, k, v, do = _flash_case(1, 12, 4, 2, 2, 8, seed=3)
    qt = _t(q).requires_grad_()
    out = attention.flash_attention(qt, _t(k), _t(v), causal=True)
    out.backward(_t(do))
    assert torch.equal(qt.grad[:, :8], torch.zeros_like(qt.grad[:, :8]))


def test_flash_dropout_mask_does_not_depend_on_chunking():
    """The plain forward steps over keys in K3's tiles of 64; the hash
    keys on global coordinates, so a different tiling drops the same
    entries (fp32: the tile changes only the order of the sums)."""
    q, k, v, _ = _flash_case(1, 40, 1100, 2, 2, 8, seed=4)
    a, _ = fk.flash_attention_bshd_ref(_t(q), _t(k), _t(v), False, None,
                                       0.3, 9)
    old = fk._KEY_TILE
    try:
        fk._KEY_TILE = 512
        b, _ = fk.flash_attention_bshd_ref(_t(q), _t(k), _t(v), False, None,
                                           0.3, 9)
    finally:
        fk._KEY_TILE = old
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# -- RMSNorm and RoPE gradients ----------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 96)])
def test_rms_norm_grads_match_jax_vjp(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: pk.rms_norm(a, b, eps=1e-5),
                     jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    fused_kernels.rms_norm(xt, wt, 1e-5).backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), _np(dx_j), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), _np(dw_j), **TOL)


@pytest.mark.parametrize("b,s,h,d", [(2, 8, 4, 16), (1, 13, 3, 32)])
def test_fused_rope_grad_matches_jax_vjp(b, s, h, d, monkeypatch):
    rng = np.random.RandomState(2)
    x = rng.randn(b, s, h, d).astype(np.float32)
    g = rng.randn(b, s, h, d).astype(np.float32)
    ang = rng.rand(s, d // 2).astype(np.float32) * 6.0
    cos, sin = np.cos(ang), np.sin(ang)
    _, vjp = jax.vjp(lambda a: pk.fused_rope(a, jnp.asarray(cos),
                                             jnp.asarray(sin)),
                     jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    calls = []
    real = fused_kernels._rope_fwd
    monkeypatch.setattr(fused_kernels, "_rope_fwd",
                        lambda *a: calls.append(a[2]) or real(*a))
    xt = _t(x).requires_grad_()
    fused_kernels.fused_rope(xt, _t(cos), _t(sin)).backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), _np(dx_j), **TOL)
    # the backward is K2 again, on (dO, cos, -sin)
    assert len(calls) == 2 and torch.equal(calls[1], -_t(sin))


# -- optimizer ---------------------------------------------------------------


def _opt_case(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"a": (4, 5), "b": (7,), "c": (2, 3, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adamw_matches_jax_over_three_updates(moment_dtype):
    params, grads = _opt_case()
    jdt = None if moment_dtype is None else jnp.bfloat16
    tdt = None if moment_dtype is None else torch.bfloat16
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jax_opt.adamw_init(jp, moment_dtype=jdt)
    tp = {k: _t(v.copy()) for k, v in params.items()}
    ts = opt.adamw_init(tp, moment_dtype=tdt)
    for g in grads:
        js, jp = jax_opt.adamw_update({k: jnp.asarray(v) for k, v in
                                       g.items()}, js, jp, lr=1e-2)
        ts2, tp2 = opt.adamw_update({k: _t(v) for k, v in g.items()}, ts,
                                    tp, lr=1e-2)
        assert ts2 is ts and tp2 is tp                  # updated in place
    assert int(ts.step) == int(js.step) == 3
    for k in params:
        assert ts.m[k].dtype == (tdt or torch.float32)
        assert ts.v[k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]), **TOL)
        np.testing.assert_allclose(ts.m[k].float().numpy(), _np(js.m[k]),
                                   **TOL)
        np.testing.assert_allclose(ts.v[k].numpy(), _np(js.v[k]), **TOL)


@pytest.mark.parametrize("clip_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(clip_norm):
    _, grads = _opt_case(1)
    g = grads[0]
    jg, jn = jax_opt.clip_by_global_norm({k: jnp.asarray(v) for k, v in
                                          g.items()}, clip_norm)
    tg = {k: _t(v.copy()) for k, v in g.items()}
    out, tn = opt.clip_by_global_norm(tg, clip_norm)
    assert out is tg
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), _np(jg[k]), **TOL)


def test_sgd_matches_jax_over_three_updates():
    params, grads = _opt_case(2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v.copy()) for k, v in params.items()}
    for g in grads:
        jp = jax_opt.sgd_update({k: jnp.asarray(v) for k, v in g.items()},
                                jp, lr=0.1, weight_decay=0.01)
        opt.sgd_update({k: _t(v) for k, v in g.items()}, tp, lr=0.1,
                       weight_decay=0.01)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]), **TOL)


# -- the slice: train steps against the JAX package --------------------------


def _jax_model(layers, kv_heads, seed, **over):
    paddle.seed(seed)
    cfg = jax_config("tiny", num_hidden_layers=layers,
                     num_key_value_heads=kv_heads, **over)
    return JaxLlama(cfg), cfg


def _batch(cfg, seed):
    """8 rows: the JAX Layer API constrains the batch to the 8-device
    ``dp`` mesh axis of the test platform when traced."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    labels[0, :3] = -100                      # ignored positions
    return ids, labels


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_train_step_matches_jax(kv_heads, remat):
    """Two AdamW steps of ``build_train_step`` from the same weights (the
    JAX side's stacked parameters carried over by load_stacked_params):
    the loss at each step and every parameter after them."""
    jm, cfg = _jax_model(2, kv_heads, seed=3)
    named = {k: jnp.asarray(p.value) for k, p in jm.named_parameters()}
    stacked, rest = jax_functional.stack_params(named, cfg)
    jstep, jinit = jax_functional.build_train_step(cfg, lr=1e-3,
                                                   remat=remat)
    jstate = jinit(stacked, rest)
    model = LlamaForCausalLM(llama_config(
        "tiny", num_hidden_layers=2, num_key_value_heads=kv_heads),
        device="cpu")
    load_stacked_params(model, {k: np.asarray(v) for k, v in stacked.items()},
                        {k: np.asarray(v) for k, v in rest.items()})
    step, init = build_train_step(model.config, lr=1e-3, remat=remat,
                                  device="cpu")
    state = init(model)
    ids, labels = _batch(cfg, seed=4)
    for _ in range(2):
        stacked, rest, jstate, jloss = jstep(
            stacked, rest, jstate, jnp.asarray(ids), jnp.asarray(labels))
        loss = step(model, state, _t(ids), _t(labels))
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    want = jax_functional.unstack_params(stacked, rest)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _np(want[k]),
                                   **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_layer_api_grads_match_jax(kv_heads):
    """``model(ids, labels).backward()`` with ``recompute="full"`` against
    ``jax.grad`` through ``functional_call``, as ``_dryrun_impl`` takes
    it."""
    jm, cfg = _jax_model(2, kv_heads, seed=5, recompute="full")
    jm.train()
    params = {k: p.value for k, p in jm.named_parameters()}
    ids, labels = _batch(cfg, seed=6)
    jloss, jgrads = jax.value_and_grad(
        lambda pv: functional_call(jm, pv, paddle.Tensor(ids),
                                   paddle.Tensor(labels)))(params)
    model = LlamaForCausalLM(llama_config(
        "tiny", num_hidden_layers=2, num_key_value_heads=kv_heads,
        recompute="full"), device="cpu")
    load_paddle_params(model, {k: np.asarray(v) for k, v in params.items()})
    model.train()
    loss = model(_t(ids), _t(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jgrads[k]), **TOL,
                                   err_msg=k)


def test_recompute_recomputes_layers_in_backward(monkeypatch):
    """With recompute="full" each decoder layer runs twice (forward, then
    again in the backward) while training, once in eval mode."""
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=2,
                                          recompute="full"), device="cpu")
    calls = []
    real = fk.flash_attention_bshd
    monkeypatch.setattr(fk, "flash_attention_bshd",
                        lambda *a: calls.append(1) or real(*a))
    ids = torch.randint(0, 256, (1, 8))
    model(ids, ids).backward()
    assert len(calls) == 4
    model.eval()
    model(ids, ids).backward()
    assert len(calls) == 6


# -- the fault this slice repaired -------------------------------------------


def test_kernel_outputs_without_grad_fn_still_train(monkeypatch):
    """On the card a kernel writes its output into a fresh tensor with no
    ``grad_fn``. Make every wrapper's launch return such a tensor here:
    the autograd Functions must still route the gradient through the
    ported backward (RMSNorm's, K2 with -sin, the flash backward), and no
    parameter of a 2-layer model may be left without a gradient."""
    calls = {"rms_bwd": 0, "rope": 0, "flash_bwd": 0}

    def detached(fn, key=None):
        def launch(*a):
            if key:
                calls[key] += 1
            out = fn(*a)
            if isinstance(out, tuple):
                return tuple(o.detach() for o in out)
            return out.detach()
        return launch

    monkeypatch.setattr(fused_kernels, "_rms_norm_fwd",
                        detached(fused_kernels._rms_norm_fwd))
    monkeypatch.setattr(fused_kernels, "_rope_fwd",
                        detached(fused_kernels._rope_fwd, "rope"))
    monkeypatch.setattr(fused_kernels, "_rms_norm_bwd",
                        detached(fused_kernels._rms_norm_bwd, "rms_bwd"))
    monkeypatch.setattr(fk, "flash_attention_bshd",
                        detached(fk.flash_attention_bshd))
    monkeypatch.setattr(fk, "flash_attention_bwd",
                        detached(fk.flash_attention_bwd, "flash_bwd"))
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=2),
                             device="cpu")
    ids = torch.randint(0, 256, (2, 8))
    model(ids, ids).backward()
    missing = [k for k, p in model.named_parameters() if p.grad is None]
    assert missing == []
    # 2 layers: 2 norms each plus the final one; q and k rotated forward
    # and back; one attention backward per layer
    assert calls == {"rms_bwd": 5, "rope": 8, "flash_bwd": 2}


def test_train_step_raises_when_a_gradient_is_missing(monkeypatch):
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=1),
                             device="cpu")
    model.lm_head.weight.requires_grad_(False)
    step, init = build_train_step(model.config, device="cpu")
    ids = torch.randint(0, 256, (1, 8))
    with pytest.raises(RuntimeError, match="lm_head.weight"):
        step(model, init(model), ids, ids)


# -- options and carries -----------------------------------------------------


@pytest.mark.parametrize("remat,exc", [("sometimes", ValueError)])
def test_unported_remat_policies_raise(remat, exc):
    cfg = llama_config("tiny", num_hidden_layers=1)
    with pytest.raises(exc):
        build_train_step(cfg, remat=remat, device="cpu")


def _remat_grads(model, policy, ids, labels, monkeypatch):
    """(loss, {name: grad}, flash forwards) of one backward under
    ``policy``."""
    calls = []
    real = fk.flash_attention_bshd
    monkeypatch.setattr(fk, "flash_attention_bshd",
                        lambda *a: calls.append(1) or real(*a))
    model.zero_grad(set_to_none=True)
    loss = llama_functional.build_loss_fn(model.config, remat=policy)(
        model, ids, labels)
    loss.backward()
    monkeypatch.setattr(fk, "flash_attention_bshd", real)
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}, len(calls)


@pytest.mark.parametrize("policy,flash", [("attn_out", 1), ("dots", 2),
                                          ("none", 1)])
def test_selective_remat_gradients_are_full_remat_bitwise(policy, flash,
                                                          monkeypatch):
    """The selective policies recompute other parts of each layer, but the
    same arithmetic: loss and every gradient bitwise those of "full" on
    the CPU; flash forwards a layer and step: 1 ("attn_out" keeps K3's
    output, "none"), 2 ("dots" recomputes K3, as "full" does)."""
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=2,
                                          num_key_value_heads=2),
                             device="cpu")
    ids, labels = (_t(a).long() for a in _batch(model.config, seed=7))
    loss_f, grads_f, n_full = _remat_grads(model, "full", ids, labels,
                                           monkeypatch)
    loss, grads, n = _remat_grads(model, policy, ids, labels, monkeypatch)
    assert (n_full, n) == (2 * 2, flash * 2)
    assert torch.equal(loss, loss_f)
    for k, g in grads.items():
        assert torch.equal(g, grads_f[k]), k


@pytest.mark.parametrize("policy", ["attn_out", "dots"])
def test_selective_remat_matches_the_reference_policy(policy):
    """Loss and gradients against ``jax.value_and_grad`` of the reference's
    loss under the same remat policy (its scan over stacked layers)."""
    jm, cfg = _jax_model(2, 2, seed=9)
    named = {k: jnp.asarray(p.value) for k, p in jm.named_parameters()}
    stacked, rest = jax_functional.stack_params(named, cfg)
    ids, labels = _batch(cfg, seed=10)
    jloss, (gs, gr) = jax.value_and_grad(
        jax_functional.build_loss_fn(cfg, remat=policy), argnums=(0, 1))(
            stacked, rest, jnp.asarray(ids), jnp.asarray(labels))
    want = jax_functional.unstack_params(gs, gr)
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=2,
                                          num_key_value_heads=2),
                             device="cpu")
    load_stacked_params(model, {k: np.asarray(v) for k, v in stacked.items()},
                        {k: np.asarray(v) for k, v in rest.items()})
    loss = llama_functional.build_loss_fn(model.config, remat=policy)(
        model, _t(ids).long(), _t(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(want[k]), **TOL,
                                   err_msg=k)


def test_recompute_option_is_checked():
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=1,
                                          recompute="dots"), device="cpu")
    with pytest.raises(ValueError, match="recompute"):
        model(torch.zeros(1, 4, dtype=torch.long))


def test_train_step_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama_config("tiny", num_hidden_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    step, init = build_train_step(cfg, device="cpu")
    assert int(init(model).step) == 0


def test_load_stacked_params_raises_on_mismatch():
    jm, cfg = _jax_model(2, None, seed=0)
    named = {k: jnp.asarray(p.value) for k, p in jm.named_parameters()}
    stacked, rest = jax_functional.stack_params(named, cfg)
    stacked = {k: np.asarray(v) for k, v in stacked.items()}
    rest = {k: np.asarray(v) for k, v in rest.items()}
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=2),
                             device="cpu")
    load_stacked_params(model, stacked, rest)
    np.testing.assert_array_equal(
        model.model.layers[1].mlp.up_proj.weight.detach().numpy(),
        stacked["mlp.up_proj.weight"][1])
    deep = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=3),
                            device="cpu")
    with pytest.raises(KeyError, match="model.layers.2"):
        load_stacked_params(deep, stacked, rest)
    with pytest.raises(KeyError, match="model.layers.0"):
        load_stacked_params(model, stacked,
                            dict(rest, **{"model.layers.0.x": rest[
                                "model.norm.weight"]}))
    bad = dict(stacked)
    bad["mlp.up_proj.weight"] = bad["mlp.up_proj.weight"][:, :3]
    with pytest.raises(ValueError, match="up_proj"):
        load_stacked_params(model, bad, rest)
    missing = dict(rest)
    missing.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_stacked_params(model, stacked, missing)


def test_functional_forward_matches_the_layer_api():
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=2),
                             device="cpu")
    ids = torch.randint(0, 256, (2, 8))
    with torch.no_grad():
        np.testing.assert_allclose(
            llama_functional.forward(model, ids, remat="none").numpy(),
            model(ids).numpy(), **TOL)
    assert math.isfinite(llama_functional.build_loss_fn(
        model.config)(model, ids, ids).item())
