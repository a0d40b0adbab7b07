"""paddle_tpu_torch's dense-KV-cache inference against paddle_tpu's: the
plain versions of K7 ``decode_mha`` and K8 ``fused_layer_norm`` against
the Pallas kernels (interpret mode) and the grouped einsum they replace,
the Llama one-token and ragged decode forwards, ``CausalLMEngine.generate``
and the dense ``ContinuousBatchingEngine``, and the incubate
``FusedMultiTransformer`` / ``FusedBiasDropoutResidualLayerNorm``.

Tolerances: float32 on both sides (the JAX side at
``jax_default_matmul_precision="highest"``, set by conftest), the same
arithmetic summed in another order, so results differ by a few fp32 ulps:
atol = rtol = 1e-5 at magnitudes of order 1, as in test_torch_kernels.py.
bf16 inputs: both sides compute in fp32 and round once to bf16, so an
output may land on the neighbouring bf16 value: rtol 2^-7 (one bf16 step)
plus atol 1e-5 for outputs near zero. Greedy streams are compared exactly,
with the top-2 margin check of test_torch_engine.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.incubate.nn import \
    FusedBiasDropoutResidualLayerNorm as JaxBDRLN
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.inference.generation import CausalLMEngine as JaxLMEngine
from paddle_tpu.inference.generation import \
    ContinuousBatchingEngine as JaxDenseEngine
from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops._decode import gqa_decode_attention as jax_gqa_decode
from paddle_tpu_torch import (CausalLMEngine, ContinuousBatchingEngine,
                              GenerationConfig, PagedContinuousBatchingEngine,
                              load_paddle_params, ops)
from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.ops import _build, fused_kernels
from paddle_tpu_torch.ops import decode_attention as port_decode
from paddle_tpu_torch.ops import flash_attention_kernel as fk

from test_torch_engine import _assert_margins, _prompts
from test_torch_llama import make_pair

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)


def _val(x):
    return np.asarray(getattr(x, "value", x), np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jt(a, dtype):
    return jnp.asarray(a).astype(dtype)


# -- K7 decode_mha ------------------------------------------------------------


def _decode_case(lens, hq, hkv, s_max=24, d=16, seed=0):
    rng = np.random.RandomState(seed)
    b = len(lens)
    return (rng.randn(b, hq, d).astype(np.float32),
            rng.randn(b, s_max, hkv, d).astype(np.float32),
            rng.randn(b, s_max, hkv, d).astype(np.float32),
            np.asarray(lens, np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_mha_matches_pallas(dtype):
    """MHA against the Pallas kernel in interpret mode, three S-blocks of
    8: a dead row (len 0 -> zeros), ragged rows and a full one."""
    q, k, v, lens = _decode_case([0, 1, 5, 13, 24, 9], 4, 4, seed=1)
    jd = jnp.dtype(dtype)
    ref = pk.decode_mha(_jt(q, jd), _jt(k, jd), _jt(v, jd),
                        jnp.asarray(lens), block_s=8)
    td = getattr(torch, dtype)
    out = ops.decode_mha(_t(q).to(td), _t(k).to(td), _t(v).to(td), _t(lens))
    assert out.dtype == td
    np.testing.assert_allclose(out.float().numpy(), _val(ref),
                               **(TOL if dtype == "float32" else BF16_TOL))
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 1), (4, 4)])
def test_gqa_decode_matches_reference(dtype, hq, hkv):
    """GQA (and MHA) against ``gqa_decode_attention``'s grouped einsum,
    the branch the TPU package took off the TPU and for every GQA model."""
    q, k, v, lens = _decode_case([7, 0, 24, 2], hq, hkv, seed=hq + hkv)
    jd = jnp.dtype(dtype)
    ref = jax_gqa_decode(_jt(q, jd), _jt(k, jd), _jt(v, jd),
                         jnp.asarray(lens))
    td = getattr(torch, dtype)
    out = ops.gqa_decode_attention(_t(q).to(td), _t(k).to(td), _t(v).to(td),
                                   _t(lens))
    np.testing.assert_allclose(out.float().numpy(), _val(ref),
                               **(TOL if dtype == "float32" else BF16_TOL))
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def test_decode_mha_reads_strided_caches_and_ignores_the_tail():
    """A slot's row of a larger cache (a strided view) gives the same
    result as a contiguous copy, and garbage past each row's length changes
    nothing."""
    q, k, v, lens = _decode_case([3, 11], 4, 2, seed=4)
    big_k = np.random.RandomState(5).randn(4, 24, 2, 16).astype(np.float32)
    big_v = big_k * 0.5
    big_k[1:3], big_v[1:3] = k, v
    view = ops.decode_mha(_t(q), _t(big_k)[1:3], _t(big_v)[1:3], _t(lens))
    k2, v2 = k.copy(), v.copy()
    k2[0, 3:] = 1e3
    v2[1, 11:] = -1e3
    out = ops.decode_mha(_t(q), _t(k2), _t(v2), _t(lens))
    np.testing.assert_allclose(view.numpy(), out.numpy(), **TOL)


@pytest.mark.parametrize("lens,hq,hkv,s_max,split", [
    ([192, 128, 64, 65, 63], 4, 4, 192, 64),  # on split boundaries, and by 1
    ([1, 0, 17, 63], 8, 1, 128, 64),          # shorter than a split; group 8
    ([40, 17, 1, 0], 9, 1, 64, 64),           # group 9: one split
    ([64, 33, 32, 0], 16, 1, 64, 32),         # group 16
    ([700, 576, 384, 193, 1, 0], 4, 4, 700, 192)])  # capacity 700
def test_decode_split_combine_matches_pallas(lens, hq, hkv, s_max, split):
    """K7's split algebra on the CPU: per-split partials and their combine,
    with the partials of splits past each row's length poisoned (the
    combine must not read them), against the Pallas kernel in interpret mode
    (GQA as MHA over caches repeated to the query heads: the TPU kernel was
    MHA-only) and the unsplit plain version, at atol 1e-5."""
    q, k, v, ln = _decode_case(lens, hq, hkv, s_max=s_max, seed=len(lens))
    acc, m, l = port_decode.decode_partials_ref(_t(q), _t(k), _t(v),
                                                _t(ln), split)
    assert acc.shape[0] == -(-s_max // split)
    live = -(-_t(ln).long() // split)
    for r in range(len(lens)):
        acc[live[r]:, r] = m[live[r]:, r] = l[live[r]:, r] = float("nan")
    out = port_decode.combine_partials_ref(acc, m, l, _t(ln), split,
                                           torch.float32)
    want = ops.decode_mha_ref(_t(q), _t(k), _t(v), _t(ln))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5, rtol=0)
    g = hq // hkv
    block = next(bs for bs in (64, 100, 32) if s_max % bs == 0)
    ref = pk.decode_mha(jnp.asarray(q), jnp.asarray(np.repeat(k, g, 2)),
                        jnp.asarray(np.repeat(v, g, 2)), jnp.asarray(ln),
                        block_s=block)
    np.testing.assert_allclose(out.numpy(), _val(ref), **TOL)
    for r, n in enumerate(lens):
        if n == 0:
            assert torch.equal(out[r], torch.zeros_like(out[r]))


def test_decode_mha_rejects_bad_shapes():
    q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError):
        ops.decode_mha(q, torch.zeros(2, 5, 3, 8), torch.zeros(2, 5, 3, 8),
                       torch.ones(2, dtype=torch.int32))       # 4 % 3
    with pytest.raises(ValueError):
        ops.decode_mha(q, torch.zeros(2, 5, 2, 8), torch.zeros(2, 5, 2, 8),
                       torch.ones(3, dtype=torch.int32))       # lens of 3


# -- K8 fused_layer_norm ------------------------------------------------------


@pytest.mark.parametrize("has_res,has_bias", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_fused_layer_norm_and_grads_match_pallas(has_res, has_bias):
    """Forward against the Pallas kernel (interpret mode) at a hidden size
    that is not a power of two; every gradient against ``jax.vjp`` of it
    (the JAX backward is ``_ln_vjp_bwd``)."""
    rng = np.random.RandomState(int(has_res) * 2 + int(has_bias))
    x = (rng.randn(2, 3, 48) * 2 + 0.5).astype(np.float32)
    r = rng.randn(2, 3, 48).astype(np.float32)
    bias = rng.randn(48).astype(np.float32)
    g = (rng.rand(48) + 0.5).astype(np.float32)
    beta = rng.randn(48).astype(np.float32)
    ct = rng.randn(2, 3, 48).astype(np.float32)
    args = [x, r if has_res else None, bias if has_bias else None, g, beta]

    def jf(*a):
        return pk.fused_layer_norm(*a, eps=1e-5)

    jargs = [None if a is None else jnp.asarray(a) for a in args]
    live = [i for i, a in enumerate(jargs) if a is not None]

    def jf_live(*vals):
        full = list(jargs)
        for i, val in zip(live, vals):
            full[i] = val
        return jf(*full)

    want, vjp = jax.vjp(jf_live, *[jargs[i] for i in live])
    jgrads = vjp(jnp.asarray(ct))
    targs = [None if a is None else _t(a).requires_grad_() for a in args]
    out = ops.fused_layer_norm(*targs, eps=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), _val(want), **TOL)
    out.backward(_t(ct))
    for i, jg in zip(live, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), _val(jg), **TOL)


def test_fused_layer_norm_defaults_and_bf16():
    """gamma and beta default to ones and zeros; bf16 computes in fp32 and
    casts once at the end."""
    rng = np.random.RandomState(7)
    x = rng.randn(5, 96).astype(np.float32)
    want = pk.fused_layer_norm(jnp.asarray(x))
    out = ops.fused_layer_norm(_t(x))
    np.testing.assert_allclose(out.numpy(), _val(want), **TOL)
    xb = _t(x).bfloat16()
    outb = ops.fused_layer_norm(xb)
    assert outb.dtype == torch.bfloat16
    assert torch.equal(outb, ops.fused_layer_norm_ref(xb))
    xf = xb.float()
    zc = xf - xf.mean(-1, keepdim=True)
    manual = (zc * torch.rsqrt(zc.pow(2).mean(-1, keepdim=True) + 1e-5))
    assert torch.equal(outb, manual.bfloat16())


# -- Llama: one-token and ragged decode forwards ------------------------------


def _dense_caches(jm, tm, b, max_len, seed):
    """The same random dense caches for both models (cells past any row's
    length hold garbage, as a reused slot's would)."""
    cfg = tm.config
    rng = np.random.RandomState(seed)
    shape = (b, max_len, cfg.kv_heads, cfg.head_dim)
    arrs = [(rng.randn(*shape).astype(np.float32),
             rng.randn(*shape).astype(np.float32))
            for _ in range(cfg.num_hidden_layers)]
    return ([(jnp.asarray(k), jnp.asarray(v)) for k, v in arrs],
            [(_t(k.copy()), _t(v.copy())) for k, v in arrs])


def _assert_caches(jc, tc):
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), _val(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), _val(jv), **TOL)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_forward_with_cache_one_token_steps_match(kv_heads):
    """A 7-token prompt prefilled at bucket width 8, then four S == 1 steps
    from pos = 7 (pad K/V at [7, 8) is overwritten by the first step):
    logits at every step and the caches afterwards agree. A 0-d tensor pos
    gives the same result as the int."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=21)
    rng = np.random.RandomState(21)
    ids = np.zeros((2, 8), np.int32)
    ids[:, :7] = rng.randint(0, cfg.vocab_size, (2, 7))
    jc, tc = _dense_caches(jm, tm, 2, 16, seed=22)
    tc2 = [(k.clone(), v.clone()) for k, v in tc]
    jl, jc = jm.forward_with_cache(paddle.Tensor(ids), jc, 0)
    with torch.no_grad():
        tl, tc = tm.forward_with_cache(_t(ids), tc, 0)
        tm.forward_with_cache(_t(ids), tc2, 0)
    np.testing.assert_allclose(tl.numpy(), _val(jl), **TOL)
    tok = np.argmax(_val(jl)[:, 6], -1).astype(np.int32)
    for pos in range(7, 11):
        with no_grad():
            jl, jc = jm.forward_with_cache(paddle.Tensor(tok[:, None]), jc,
                                           pos)
        with torch.no_grad():
            tl, tc = tm.forward_with_cache(_t(tok[:, None]), tc, pos)
            tl2, tc2 = tm.forward_with_cache(_t(tok[:, None]), tc2,
                                             torch.tensor(pos))
        np.testing.assert_allclose(tl.numpy(), _val(jl), **TOL)
        assert torch.equal(tl2, tl)
        tok = np.argmax(_val(jl)[:, 0], -1).astype(np.int32)
    _assert_caches(jc, tc)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_forward_decode_ragged_matches(kv_heads):
    """Four rows at lengths 5, 11, 0 (dead) and 15 (the last cell of a
    16-wide cache), three ragged steps: logits at every step and the caches
    afterwards agree, and the dead row's cells are unchanged."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=31)
    jc, tc = _dense_caches(jm, tm, 4, 16, seed=32)
    dead_before = [k[2].clone() for k, _ in tc]
    tok = np.array([3, 17, 0, 99], np.int32)
    lens = np.array([5, 11, 0, 15], np.int32)
    live = np.array([True, True, False, True])
    for _ in range(3):
        with no_grad():
            jl, jc = jm.forward_decode_ragged(
                paddle.Tensor(tok[:, None]), jc, jnp.asarray(lens),
                jnp.asarray(live))
        with torch.no_grad():
            tl, tc = tm.forward_decode_ragged(_t(tok[:, None]), tc, _t(lens),
                                              _t(live))
        np.testing.assert_allclose(tl.numpy(), _val(jl), **TOL)
        tok = np.where(live, np.argmax(_val(jl)[:, 0], -1), tok).astype(
            np.int32)
        lens = np.minimum(lens + live, 16).astype(np.int32)
        live = live & (lens < 16)
    _assert_caches(jc, tc)
    for (k, _), before in zip(tc, dead_before):
        assert torch.equal(k[2], before)


# -- engines: CausalLMEngine.generate and the dense ContinuousBatchingEngine --


@pytest.mark.parametrize("kv_heads,seed,plen", [(None, 0, 9), (2, 1, 20)])
def test_generate_matches_reference(kv_heads, seed, plen):
    """Three rows through bucketed prefill (buckets 16 and 32) and nine
    one-token steps: the same greedy tokens as the JAX engine."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=seed)
    ids = np.random.RandomState(seed + 40).randint(
        0, cfg.vocab_size, (3, plen)).astype(np.int32)
    want = JaxLMEngine(jm, max_batch=4, max_len=48).generate(
        ids, JaxGenCfg(max_new_tokens=10))
    eng = CausalLMEngine(tm, max_batch=4, max_len=48)
    got = eng.generate(ids, GenerationConfig(max_new_tokens=10))
    assert got.dtype == np.int32 and got.shape == (3, plen + 10)
    assert got.tolist() == np.asarray(want).tolist()
    _assert_margins(tm, list(ids), [g[plen:] for g in got])
    assert eng.generate_stats["decode_steps"] == 9


def test_generate_eos_freezes_rows_and_checks_limits():
    jm, tm, cfg = make_pair(2, None, seed=2)
    ids = np.random.RandomState(42).randint(0, cfg.vocab_size, (2, 6))
    free = CausalLMEngine(tm, max_batch=2, max_len=32).generate(
        ids, GenerationConfig(max_new_tokens=8))
    eos = int(free[0, 6 + 3])
    want = JaxLMEngine(jm, max_batch=2, max_len=32).generate(
        ids, JaxGenCfg(max_new_tokens=8, eos_token_id=eos))
    eng = CausalLMEngine(tm, max_batch=2, max_len=32, prefill_buckets=None)
    got = eng.generate(ids, GenerationConfig(max_new_tokens=8,
                                             eos_token_id=eos))
    assert got.tolist() == np.asarray(want).tolist()
    assert (got[0, 6 + 3:] == eos).all()
    _assert_margins(tm, list(ids.astype(np.int32)), [f[6:] for f in free])
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate(np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.zeros((1, 30), np.int32),
                     GenerationConfig(max_new_tokens=3))


@pytest.mark.parametrize("kv_heads,seed", [(None, 0), (2, 1)])
def test_dense_serve_streams_match_reference_and_paged(kv_heads, seed):
    """Six requests through two dense slots (MHA and GQA): admission
    recycles slots, prompts span three prefill buckets. The streams equal
    the JAX dense engine's and the port's paged engine's."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=seed)
    prompts = _prompts(seed + 10, [5, 17, 9, 30, 3, 12])
    want = JaxDenseEngine(jm, max_batch=2, max_len=64).serve(
        prompts, JaxGenCfg(max_new_tokens=10), segment_steps=4)
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=64)
    got = eng.serve(prompts, GenerationConfig(max_new_tokens=10),
                    segment_steps=4)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    _assert_margins(tm, prompts, want)
    paged = PagedContinuousBatchingEngine(
        tm, max_batch=2, num_pages=16, page_size=8, max_pages=8).serve(
        prompts, GenerationConfig(max_new_tokens=10), segment_steps=4)
    assert [g.tolist() for g in got] == [p.tolist() for p in paged]
    assert eng.free_slots() == 2
    assert eng.caches[0][0].shape == (2, 64, cfg.kv_heads or 4, 16)
    assert eng.serve_stats["decode_tokens"] == sum(len(w) - 1 for w in want)


def test_dense_serve_eos_and_exact_prefill_match_reference():
    jm, tm, cfg = make_pair(2, None, seed=4)
    prompts = _prompts(14, [6, 11, 4, 20])
    kw = dict(max_batch=3, max_len=40, prefill_buckets=None)
    je = JaxDenseEngine(jm, **kw)
    free = je.serve(prompts, JaxGenCfg(max_new_tokens=12))
    eos = int(free[1][5])
    want = je.serve(prompts, JaxGenCfg(max_new_tokens=12, eos_token_id=eos))
    got = ContinuousBatchingEngine(tm, **kw).serve(
        prompts, GenerationConfig(max_new_tokens=12, eos_token_id=eos))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert len(want[1]) <= 6 and want[1][-1] == eos
    _assert_margins(tm, prompts, free)


# -- incubate: FusedMultiTransformer and FusedBiasDropoutResidualLayerNorm ----


def _fmt_pair(layers=2, e=32, h=4, f=64, seed=0):
    paddle.seed(seed)
    jm = JaxFMT(e, h, f, num_layers=layers, dropout_rate=0.0)
    tm = FusedMultiTransformer(e, h, f, num_layers=layers, device="cpu")
    load_paddle_params(tm, {k: np.asarray(p.value)
                            for k, p in jm.named_parameters()})
    return jm, tm


def test_fmt_context_pass_and_grads_match():
    """Causal context pass and every parameter's gradient of
    mean(out^2) (JAX's test_training_grads objective) against JAX."""
    jm, tm = _fmt_pair(seed=3)
    x = np.random.RandomState(3).randn(2, 8, 32).astype(np.float32)
    jy = jm(paddle.to_tensor(x))
    jloss = (jy ** 2).mean()
    jloss.backward()
    ty = tm(_t(x))
    np.testing.assert_allclose(ty.detach().numpy(), _val(jy), **TOL)
    (ty ** 2).mean().backward()
    jgrads = {k: _val(p.grad.value) for k, p in jm.named_parameters()}
    assert len(jgrads) == 24
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_fmt_masked_context_pass_matches():
    """An explicit mask (bool padding mask, not causal) goes to plain masked
    attention on both sides; a float mask is added to the scores."""
    jm, tm = _fmt_pair(seed=5)
    x = np.random.RandomState(5).randn(2, 6, 32).astype(np.float32)
    keep = np.ones((2, 1, 1, 6), bool)
    keep[1, ..., 4:] = False
    for mask in (keep, np.where(keep, 0.0, -1e4).astype(np.float32)):
        jy = jm(paddle.to_tensor(x), attn_mask=paddle.to_tensor(mask))
        ty = tm(_t(x), attn_mask=_t(mask))
        np.testing.assert_allclose(ty.detach().numpy(), _val(jy), **TOL)


def test_fmt_cache_fill_and_decode_match():
    """Context pass filling caches of 12, three uniform ``time_step`` steps,
    then three ragged ``seq_lens`` steps at lengths 9 and 4: outputs and
    caches agree with JAX at every step."""
    jm, tm = _fmt_pair(seed=6)
    x = np.random.RandomState(6).randn(2, 12, 32).astype(np.float32)
    jc = jm.make_caches(2, 2, 12, 4, 8)
    tc = tm.make_caches(2, 2, 12, 4, 8, device="cpu")
    jy, jc = jm(paddle.to_tensor(x[:, :6]), caches=jc)
    with torch.no_grad():
        ty, tc = tm(_t(x[:, :6]), caches=tc)
    np.testing.assert_allclose(ty.numpy(), _val(jy), **TOL)
    steps = [dict(time_step=t) for t in (6, 7, 8)] + [
        dict(time_step=9, seq_lens=np.array([9 + i, 4 + i], np.int32))
        for i in range(3)]
    for i, kw in enumerate(steps):
        xt = x[:, 6 + i:7 + i]
        with no_grad():
            jy, jc = jm(paddle.to_tensor(xt), caches=jc, **kw)
        with torch.no_grad():
            ty, tc = tm(_t(xt), caches=tc, **kw)
        np.testing.assert_allclose(ty.numpy(), _val(jy), **TOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), _val(getattr(jk, "value", jk)),
                                   **TOL)
        np.testing.assert_allclose(tv.numpy(), _val(getattr(jv, "value", jv)),
                                   **TOL)


def test_fmt_decode_step_equals_context_position():
    """The KV-cache contract, port against port: decode step t equals
    position t of the causal context pass (uniform and ragged forms)."""
    _, tm = _fmt_pair(seed=7)
    x = _t(np.random.RandomState(7).randn(2, 6, 32).astype(np.float32))
    with torch.no_grad():
        ref = tm(x)
        for ragged in (False, True):
            caches = tm.make_caches(2, 2, 6, 4, 8, device="cpu")
            outs = []
            for t in range(6):
                kw = dict(seq_lens=torch.full((2,), t, dtype=torch.int32)) \
                    if ragged else {}
                y, caches = tm(x[:, t:t + 1], caches=caches, time_step=t,
                               **kw)
                outs.append(y)
            np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                                       ref.numpy(), atol=2e-5, rtol=1e-5)


def test_fmt_options():
    with pytest.raises(NotImplementedError):
        FusedMultiTransformer(8, 2, 16, normalize_before=False, device="cpu")
    with pytest.raises(ValueError):
        FusedMultiTransformer(8, 2, 16, activation="swish", device="cpu")
    a = FusedMultiTransformer(8, 2, 16, num_layers=2, device="cpu",
                              generator=torch.Generator().manual_seed(1))
    b = FusedMultiTransformer(8, 2, 16, num_layers=2, device="cpu",
                              generator=torch.Generator().manual_seed(1))
    for (ka, pa), (kb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert ka == kb and torch.equal(pa, pb)
    assert a.ffn1_weights_1.shape == (8, 16)
    assert a.qkv_weights_0.shape == (24, 8)
    assert a.qkv_weights_0.abs().max() <= (6.0 / 32) ** 0.5
    relu = FusedMultiTransformer(8, 2, 16, activation="relu", device="cpu",
                                 dropout_rate=0.5)
    x = torch.randn(1, 3, 8)
    relu.eval()
    assert torch.equal(relu(x), relu(x))           # no dropout in eval


def test_fused_bias_dropout_residual_layer_norm_matches():
    """The layer (dropout 0) and its gradients against JAX's, bias and LN
    parameters loaded across; dropout in training draws from the
    generator: the same seed gives the same mask."""
    paddle.seed(8)
    jl = JaxBDRLN(16, dropout_rate=0.0)
    rng = np.random.RandomState(8)
    named = {k: rng.randn(*np.shape(p.value)).astype(np.float32)
             for k, p in jl.named_parameters()}
    for k, p in jl.named_parameters():
        p.set_value(named[k])
    tl = FusedBiasDropoutResidualLayerNorm(16, dropout_rate=0.0,
                                           device="cpu")
    load_paddle_params(tl, named)
    x, r = rng.randn(2, 4, 16).astype(np.float32), rng.randn(2, 4, 16).astype(
        np.float32)
    jy = jl(paddle.to_tensor(x), paddle.to_tensor(r))
    (jy ** 2).sum().backward()
    ty = tl(_t(x), _t(r))
    np.testing.assert_allclose(ty.detach().numpy(), _val(jy), **TOL)
    (ty ** 2).sum().backward()
    for k, p in jl.named_parameters():
        np.testing.assert_allclose(tl.get_parameter(k).grad.numpy(),
                                   _val(p.grad.value), **TOL)
    outs = [IF.fused_bias_dropout_residual_layer_norm(
        _t(x), _t(r), dropout_rate=0.5,
        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    no_drop = IF.fused_bias_dropout_residual_layer_norm(_t(x), _t(r),
                                                        dropout_rate=0.0)
    assert not torch.equal(outs[0], no_drop)
    assert torch.equal(IF.fused_bias_dropout_residual_layer_norm(
        _t(x), _t(r), dropout_rate=0.5, training=False), no_drop)


# -- the kernels' wrappers ----------------------------------------------------


def test_kernel_outputs_without_grad_fn_still_train_fmt(monkeypatch):
    """On the card K8 and K3 write fresh tensors with no ``grad_fn``. Make
    their launch helpers return such tensors here: every FMT parameter
    still gets a gradient through the autograd Functions."""
    calls = {"ln": 0, "flash": 0}

    def detached(fn, key):
        def launch(*a):
            calls[key] += 1
            out = fn(*a)
            if isinstance(out, tuple):
                return tuple(o.detach() for o in out)
            return out.detach()
        return launch

    monkeypatch.setattr(fused_kernels, "_layer_norm_fwd",
                        detached(fused_kernels._layer_norm_fwd, "ln"))
    monkeypatch.setattr(fk, "flash_attention_bshd",
                        detached(fk.flash_attention_bshd, "flash"))
    _, tm = _fmt_pair(seed=9)
    (tm(torch.randn(2, 5, 32)) ** 2).mean().backward()
    assert [k for k, p in tm.named_parameters() if p.grad is None] == []
    assert calls == {"ln": 4, "flash": 2}


def test_new_kernels_count_no_cpu_launches_and_refuse_other_devices():
    ops.reset_launch_counts()
    x = torch.randn(2, 4, 8)
    ops.decode_mha(x, x[:, None], x[:, None], torch.ones(2, dtype=torch.int32))
    ops.fused_layer_norm(x, x, gamma=torch.ones(8))
    assert ops.launch_counts()["decode_mha"] == 0
    assert ops.launch_counts()["fused_layer_norm"] == 0
    m = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError):
        ops.decode_mha(m, m[:, None], m[:, None],
                       torch.empty(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        ops.fused_layer_norm(m, m)


def test_decode_mha_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("decode_mha")
