"""Chunked prefill in paddle_tpu_torch against paddle_tpu: the port of
``ops/pallas.py::prefix_chunk_attention`` (K3's prefix-chunk instance; its
plain version here), Llama's ``forward_with_cache`` at S > 1 and a device
offset, ``CausalLMEngine(prefill_chunk=...)`` and the continuous engines'
chunked admission (``begin_admit`` / ``admit_chunk`` / ``abort_admit``).

Tolerances. fp32 on both sides (the JAX side at "highest" matmul
precision, set by conftest): the same arithmetic in another order, a few
fp32 ulps, so atol = rtol = 1e-5 as in test_torch_dense.py. bf16 attention:
both sides round P to bf16 before P.V, the port at the running max of each
64-key tile, the JAX fallback at the running max of each chunk of up to
512 keys, and round the output once to bf16, so an output may move by a
bf16 step of its own size or of a neighbour's: atol = rtol = 2^-6 (two
bf16 steps; 0.0156 measured at outputs up to 2.7). Port against port the
chunked rows are bitwise the one-shot rows (the same key tiles and
roundings). Greedy streams are compared exactly on pinned prompts whose
top-2 margins are checked (test_torch_engine.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.inference.generation import CausalLMEngine as JaxLMEngine
from paddle_tpu.inference.generation import \
    ContinuousBatchingEngine as JaxDenseEngine
from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxPagedEngine
from paddle_tpu.ops.pallas import prefix_chunk_attention as jax_prefix
from paddle_tpu_torch import (CausalLMEngine, ContinuousBatchingEngine,
                              GenerationConfig, PagedContinuousBatchingEngine,
                              ops)

from test_torch_engine import _assert_margins, _prompts
from test_torch_llama import make_pair

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2.0 ** -6, rtol=2.0 ** -6)
DTYPES = {"float32": (torch.float32, jnp.float32, TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}
PAGED = dict(max_batch=2, num_pages=16, page_size=8, max_pages=8)
DENSE = dict(max_batch=2, max_len=64)
C = 16


def _val(x):
    return np.asarray(getattr(x, "value", x), np.float32)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _pos(p):
    return torch.tensor(p, dtype=torch.int32)


# -- prefix_chunk_attention ----------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("case", [
    (128, 32, 0, 32),       # the first chunk
    (128, 32, 64, 32),      # mid-cache
    (128, 32, 96, 11),      # a partial last chunk: 11 real rows, padded
    (640, 64, 576, 64)])    # past one of JAX's 512-key chunks
def test_prefix_chunk_attention_matches_reference(dtype, hkv, case):
    """The chunk [pos, pos + C) over a cache written up to pos + r (rows
    past it zero, as a partly filled cache), against the JAX function: the
    real rows agree."""
    tdt, jdt, tol = DTYPES[dtype]
    w, c, pos, r = case
    rng = np.random.RandomState(w + pos + hkv)
    q = rng.randn(1, c, 4, 16).astype(np.float32)
    k = rng.randn(1, w, hkv, 16).astype(np.float32)
    v = rng.randn(1, w, hkv, 16).astype(np.float32)
    k[:, pos + r:] = 0.0
    v[:, pos + r:] = 0.0
    got = ops.prefix_chunk_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                     _pos(pos))
    want = jax_prefix(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                      jnp.int32(pos))
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy()[:, :r],
                               _val(want.astype(jnp.float32))[:, :r], **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hkv", [4, 1])
def test_chunked_rows_equal_one_shot_rows_bitwise(dtype, hkv):
    """A prompt of 200 tokens attended one-shot (K3 causal's plain version)
    and in chunks of 48 at offsets 0, 48, ..., 192 (off the 64-key tiles;
    the last chunk has 8 real rows): every real row is bitwise equal."""
    torch.manual_seed(hkv)
    n, c, w = 200, 48, 256
    q = torch.randn(1, n, 4, 16).to(dtype)
    k = torch.randn(1, n, hkv, 16).to(dtype)
    v = torch.randn(1, n, hkv, 16).to(dtype)
    one_shot, _ = ops.flash_attention_bshd_ref(q, k, v, causal=True)
    kc = torch.zeros(1, w, hkv, 16, dtype=dtype)
    vc = torch.zeros_like(kc)
    kc[:, :n], vc[:, :n] = k, v
    for pos in range(0, n, c):
        r = min(c, n - pos)
        qc = torch.zeros(1, c, 4, 16, dtype=dtype)
        qc[:, :r] = q[:, pos:pos + r]
        got = ops.prefix_chunk_attention(qc, kc, vc, _pos(pos))
        assert torch.equal(got[:, :r], one_shot[:, pos:pos + r]), pos


def test_prefix_chunk_plain_version_reads_only_the_written_prefix():
    """Rows of the cache past pos + C are never read: NaN there changes
    nothing, as on the card the kernel stages no key past it."""
    torch.manual_seed(0)
    q = torch.randn(1, 16, 2, 16)
    kc = torch.randn(1, 64, 2, 16)
    vc = torch.randn(1, 64, 2, 16)
    want = ops.prefix_chunk_attention(q, kc, vc, _pos(16))
    kc[:, 32:], vc[:, 32:] = float("nan"), float("nan")
    assert torch.equal(ops.prefix_chunk_attention(q, kc, vc, _pos(16)), want)
    assert torch.equal(ops.prefix_chunk_attention(q, kc, vc, 16), want)


def test_prefix_chunk_dispatch_and_refusals():
    """Every dtype the flash kernels take has a prefix-chunk entry point; a
    tensor off the CPU never takes the plain version (a ``meta`` tensor
    stands in for any non-CPU device: it raises before any launch), and a
    CPU call counts no launch."""
    from paddle_tpu_torch.ops import flash_attention_kernel as fk
    assert fk.kernel_for("flash_fwd_prefix", torch.bfloat16, 128) == (
        "flash_fwd", "flash_fwd_prefix_bf16", 128)
    assert fk.kernel_for("flash_fwd_prefix", torch.float16, 96) == (
        "flash_fwd", "flash_fwd_prefix_f16", 128)
    assert fk.kernel_for("flash_fwd_prefix", torch.float32, 16) == (
        "flash_f32", "flash_fwd_prefix_f32", 64)
    with pytest.raises(ValueError):
        fk.kernel_for("flash_fwd_prefix", torch.float64, 64)
    with pytest.raises(ValueError):
        fk.kernel_for("flash_fwd_prefix", torch.bfloat16, 256)
    x = torch.empty(1, 16, 2, 16, device="meta")
    c = torch.empty(1, 64, 2, 16, device="meta")
    with pytest.raises(ValueError):
        ops.prefix_chunk_attention(x, c, c, _pos(0))
    ops.reset_launch_counts()
    ops.prefix_chunk_attention(torch.randn(1, 16, 2, 16),
                               torch.randn(1, 64, 2, 16),
                               torch.randn(1, 64, 2, 16), _pos(3))
    assert ops.launch_counts()["flash_fwd_prefix"] == 0


# -- Llama forward_with_cache in chunks ---------------------------------------


@pytest.mark.parametrize("kv_heads,seed", [(None, 3), (2, 4)])
def test_forward_with_cache_chunks_match_reference(kv_heads, seed):
    """A 40-token prompt in chunks of 16 at device offsets 0, 16, 32 (the
    last chunk padded) into a 64-row cache: logits of every chunk and the
    caches agree with the JAX model's; the port's chunked logits agree with
    its one-shot prefill's."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=seed)
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                              (1, 40)).astype(np.int32)
    jc, tc = jm.init_cache(1, 64), tm.init_cache(1, 64)
    chunked = []
    for pos in range(0, 40, C):
        chunk = np.zeros((1, C), np.int32)
        real = ids[:, pos:pos + C]
        chunk[:, :real.shape[1]] = real
        with no_grad():
            jl, jc = jm.forward_with_cache(paddle.Tensor(chunk), jc,
                                           jnp.int32(pos))
        with torch.no_grad():
            tl, tc = tm.forward_with_cache(_t(chunk), tc, _pos(pos))
        np.testing.assert_allclose(tl.numpy(), _val(jl), **TOL)
        chunked.append(tl[0, :real.shape[1]])
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), _val(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), _val(jv), **TOL)
    with torch.no_grad():
        one, _ = tm.forward_with_cache(_t(np.pad(ids, ((0, 0), (0, 24)))),
                                       tm.init_cache(1, 64), 0)
    np.testing.assert_allclose(torch.cat(chunked).numpy(), one[0, :40].numpy(),
                               **TOL)


# -- CausalLMEngine(prefill_chunk=...) -----------------------------------------


@pytest.mark.parametrize("kv_heads,seed,plen", [(None, 0, 37), (2, 1, 32),
                                                (None, 2, 9)])
def test_generate_chunked_matches_reference(kv_heads, seed, plen):
    """Two rows prefilled in chunks of 16 (37 tokens: three chunks, the
    last partial; 32: two full ones; 9: no chunking, one bucketed prefill)
    then nine steps: the JAX engine's greedy tokens, and the unchunked
    port engine's."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=seed)
    ids = np.random.RandomState(seed + 50).randint(
        0, cfg.vocab_size, (2, plen)).astype(np.int32)
    want = JaxLMEngine(jm, max_batch=2, max_len=64, prefill_chunk=C).generate(
        ids, JaxGenCfg(max_new_tokens=10))
    eng = CausalLMEngine(tm, max_batch=2, max_len=64, prefill_chunk=C)
    got = eng.generate(ids, GenerationConfig(max_new_tokens=10))
    assert got.tolist() == np.asarray(want).tolist()
    _assert_margins(tm, list(ids), [g[plen:] for g in got])
    assert got.tolist() == CausalLMEngine(tm, max_batch=2, max_len=64).generate(
        ids, GenerationConfig(max_new_tokens=10)).tolist()


def test_generate_warmup_runs_the_chunk_program():
    _, tm, cfg = make_pair(2, None, seed=0)
    eng = CausalLMEngine(tm, max_batch=2, max_len=64, prefill_chunk=C)
    out = eng.warmup(batch=2)
    assert "prefill_chunk" in out
    before = dict(eng.programs.captures)
    ids = np.random.RandomState(50).randint(0, cfg.vocab_size,
                                            (2, 37)).astype(np.int32)
    eng.generate(ids, GenerationConfig(max_new_tokens=4))
    eng.generate(ids, GenerationConfig(max_new_tokens=4, do_sample=True))
    assert eng.programs.captures == before


# -- chunked admission on the continuous engines ------------------------------


ENGINES = {
    "dense": (ContinuousBatchingEngine, JaxDenseEngine, DENSE),
    "paged": (PagedContinuousBatchingEngine, JaxPagedEngine, PAGED),
    "paged_int8": (PagedContinuousBatchingEngine, JaxPagedEngine,
                   dict(PAGED, kv_dtype="int8")),
}


def _drive(eng, gen_cfg, prompts):
    """A serving gap loop: request 0 is admitted in chunks, one chunk per
    gap, while request 1 (admitted at once) decodes between them; then
    both drain. Returns the streams by request id order."""
    first = eng.add_request(prompts[1], gen_cfg(max_new_tokens=12))
    adm = eng.begin_admit(prompts[0], gen_cfg(max_new_tokens=10))
    while not eng.admit_chunk(adm):
        eng.decode_segment(2)
    while eng.decode_segment(4):
        pass
    done = eng.collect_finished()
    return [np.asarray(done[adm.rid]).tolist(),
            np.asarray(done[first]).tolist()]


@pytest.mark.parametrize("kind", list(ENGINES))
@pytest.mark.parametrize("kv_heads,seed", [(None, 0), (2, 1)])
def test_chunked_admission_matches_reference(kind, kv_heads, seed):
    """A 45-token prompt admitted in three chunks of 16 while another
    request decodes between the chunks: both streams equal the JAX
    engine's driven the same way, and the chunked request's equals a
    one-shot admission's."""
    port, ref, kw = ENGINES[kind]
    jm, tm, cfg = make_pair(2, kv_heads, seed=seed)
    prompts = _prompts(seed + 60, [45, 7])
    eng = port(tm, prefill_chunk=C, **kw)
    got = _drive(eng, GenerationConfig, prompts)
    want = _drive(ref(jm, prefill_chunk=C, **kw), JaxGenCfg, prompts)
    assert got == want
    assert eng.prefill_chunks == 3 and eng.free_slots() == 2
    one_shot = port(tm, **kw).serve(prompts[:1],
                                    GenerationConfig(max_new_tokens=10))
    assert got[0] == one_shot[0].tolist()
    _assert_margins(tm, prompts, [np.asarray(s, np.int32) for s in got])
    if kind != "dense":
        eng.alloc.check()
        assert eng.alloc.free_pages == PAGED["num_pages"]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_abort_admit_gives_the_claim_back(kind):
    """An admission aborted after one of its chunks, and one aborted before
    any: the free slots and the allocator's counts are back to what they
    were, abort is idempotent, and the engine then serves as before."""
    port, _, kw = ENGINES[kind]
    _, tm, _ = make_pair(2, None, seed=0)
    eng = port(tm, prefill_chunk=C, **kw)
    prompts = _prompts(60, [45, 7])
    rid = eng.add_request(prompts[1], GenerationConfig(max_new_tokens=12))
    paged = kind != "dense"
    before = (eng.free_slots(), eng.alloc.free_pages if paged else None)
    for chunks in (1, 0):
        adm = eng.begin_admit(prompts[0], GenerationConfig(max_new_tokens=10))
        assert eng.free_slots() == before[0] - 1
        if paged:
            assert eng.alloc.free_pages < before[1]
        for _ in range(chunks):
            assert not eng.admit_chunk(adm)
        eng.abort_admit(adm)
        eng.abort_admit(adm)
        assert (eng.free_slots(),
                eng.alloc.free_pages if paged else None) == before
        if paged:
            eng.alloc.check()
        with pytest.raises(RuntimeError, match="already"):
            eng.admit_chunk(adm)
    while eng.decode_segment(4):
        pass
    assert list(eng.collect_finished()) == [rid]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_chunked_admission_errors_match_reference(kind):
    """The reference's errors: no prefill_chunk -> RuntimeError; a closed
    admission -> RuntimeError; max_len not a multiple of prefill_chunk (or
    a chunk that is not a positive int) -> ValueError, in both packages."""
    port, ref, kw = ENGINES[kind]
    jm, tm, _ = make_pair(2, None, seed=0)
    p = _prompts(60, [20])[0]
    for eng, gen in ((port(tm, **kw), GenerationConfig),
                     (ref(jm, **kw), JaxGenCfg)):
        with pytest.raises(RuntimeError, match="prefill_chunk"):
            eng.begin_admit(p, gen(max_new_tokens=4))
    for make, gen in ((lambda **k: port(tm, **kw, **k), GenerationConfig),
                      (lambda **k: ref(jm, **kw, **k), JaxGenCfg)):
        for bad in (24, 0, -16, True, 16.0):
            with pytest.raises(ValueError, match="prefill_chunk"):
                make(prefill_chunk=bad)
        eng = make(prefill_chunk=C)
        adm = eng.begin_admit(p, gen(max_new_tokens=4))
        while not eng.admit_chunk(adm):
            pass
        with pytest.raises(RuntimeError, match="already"):
            eng.admit_chunk(adm)
        with pytest.raises(ValueError, match="max_len"):
            eng.begin_admit(np.zeros(60, np.int32), gen(max_new_tokens=8))


def test_lm_engine_prefill_chunk_errors_match_reference():
    jm, tm, _ = make_pair(2, None, seed=0)
    for make in (lambda c: CausalLMEngine(tm, 2, 64, prefill_chunk=c),
                 lambda c: JaxLMEngine(jm, 2, 64, prefill_chunk=c)):
        for bad in (24, 0, False, "16"):
            with pytest.raises(ValueError, match="prefill_chunk"):
                make(bad)


def test_int8_pools_after_chunked_admission_equal_reference():
    """int8 pools after a chunked admission's install (before any decode
    step). The install quantizes the admission's mini cache exactly as the
    reference's store does (``write_tokens_q`` over the same rows, page
    table and limit): bytes and scales equal, page for page. Against the
    JAX int8 engine driven the same way, whose mini cache differs from the
    port's by fp32 ulps, the pages match up to one quantization step and
    the scales to 1e-5."""
    from paddle_tpu.inference.paged_cache import write_tokens_q as jax_write_q

    jm, tm, _ = make_pair(2, None, seed=0)
    kw = dict(PAGED, kv_dtype="int8", prefill_chunk=C)
    p = _prompts(60, [45])[0]
    te = PagedContinuousBatchingEngine(tm, **kw)
    je = JaxPagedEngine(jm, **kw)
    minis = []
    install = te._install_mini
    te._install_mini = lambda slot, mini, plen: (minis.append(mini),
                                                 install(slot, mini, plen))
    for eng, gen in ((te, GenerationConfig), (je, JaxGenCfg)):
        adm = eng.begin_admit(p, gen(max_new_tokens=10))
        while not eng.admit_chunk(adm):
            pass
    n, width = PAGED["num_pages"], 64          # the 45-token prompt's bucket
    table = te.alloc.page_table
    assert (table == np.asarray(je.alloc.page_table)).all()
    slots = jnp.zeros((width,), jnp.int32)
    pos = jnp.arange(width, dtype=jnp.int32)
    fresh = jm.init_paged_cache(n, PAGED["page_size"], kv_dtype="int8")
    for t_entry, j_entry, f_entry, (mk, mv) in zip(te.caches, je.caches[0],
                                                   fresh, minis[0]):
        want = jax_write_q(*f_entry, jnp.asarray(table), slots, pos,
                           jnp.asarray(mk[0, :width].numpy()),
                           jnp.asarray(mv[0, :width].numpy()),
                           limit=jnp.int32(len(p)))
        for t, w, j in zip(t_entry, want, j_entry):
            assert np.array_equal(t[:n].numpy(), np.asarray(w))
            if t.dtype == torch.int8:
                diff = t[:n].numpy().astype(np.int32) - np.asarray(j, np.int32)
                assert np.abs(diff).max() <= 1
            else:
                np.testing.assert_allclose(t[:n].numpy(), np.asarray(j),
                                           rtol=1e-5, atol=0)
