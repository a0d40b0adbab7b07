"""paddle_tpu_torch's int8 KV path against paddle_tpu's, on the same numpy
inputs: the quantization math (``quantization/kv.py``), the quantizing
page write (``write_tokens_q``), the allocator's scale bookkeeping, the
model's int8 paged decode step and the paged engine with
``kv_dtype="int8"``.

Pool bytes and scales are held EQUAL to the reference's after the same
stores, not close: both round half to even in the same order of fp32
operations. The port aims a dropped row at its sink page (the pools' last
row) where the reference drops it, so the comparisons read the real pages
``[:num_pages]``. The port re-quantizes the target pages on every store
where the reference does so only when a page's scale grew; the two are
held byte-equal over a seeded sequence of stores.

Engine streams are compared on pinned prompts, as ``test_torch_engine.py``
does: both int8 engines store the same bytes, so their logits differ by
fp32 summation order only, and every greedy choice along the streams is
checked to beat the runner-up by at least ``MARGIN`` in the port's own
int8 decode logits.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.autograd import no_grad
from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.paged_cache import PageAllocator as JaxAllocator
from paddle_tpu.inference.paged_cache import write_tokens_q as jax_write_q
from paddle_tpu.quantization import kv as jax_kv
from paddle_tpu_torch import GenerationConfig, PagedContinuousBatchingEngine
from paddle_tpu_torch.inference.paged_cache import (PageAllocator,
                                                    write_tokens,
                                                    write_tokens_q)
from paddle_tpu_torch.quantization import kv as port_kv

from test_torch_llama import make_pair
from torch_jax_state import jax_reference_state  # noqa: F401

MARGIN = 1e-3
FLOOR = port_kv.KV_SCALE_FLOOR
port_paged = importlib.import_module("paddle_tpu_torch.ops.paged_attention")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models and ops are
    tiny, and a thread pool on a machine whose cores other test workers
    hold waits for its threads at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(x):
    return np.asarray(getattr(x, "value", x))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pools(P=4, ps=4, H=2, D=8):
    """A JAX int8 pool and scales, and the port's twin with its sink."""
    return ((jnp.zeros((P, ps, H, D), jnp.int8),
             jnp.full((P, H), FLOOR, jnp.float32)),
            (torch.zeros((P + 1, ps, H, D), dtype=torch.int8),
             torch.full((P + 1, H), FLOOR)))


def _store_both(j, t, pages, offs, rows):
    """One ``quant_store_rows`` on each side; the port's sink stands for
    the reference's out-of-range page P."""
    jp, js = jax_kv.quant_store_rows(*j, jnp.asarray(pages),
                                     jnp.asarray(offs), jnp.asarray(rows))
    port_kv.quant_store_rows(*t, _t(pages), _t(offs), _t(rows))
    P = js.shape[0]
    np.testing.assert_array_equal(t[0][:P].numpy(), _j(jp))
    np.testing.assert_array_equal(t[1][:P].numpy(), _j(js))
    return (jp, js), t


# -- quantization.kv: the shared absmax math ----------------------------------


def test_constants_and_conventions_are_the_reference_ones():
    assert port_kv.KV_DTYPES == jax_kv.KV_DTYPES
    assert port_kv.KV_QMAX == jax_kv.KV_QMAX
    assert port_kv.KV_SCALE_FLOOR == jax_kv.KV_SCALE_FLOOR
    assert port_paged.KV_QMAX is port_kv.KV_QMAX        # K4 reads the same one
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 4, 2, 8) * 2).astype(np.float32)
    s = (np.abs(x).max(axis=(1, 3)) * rng.uniform(0.6, 1.2, (3, 2))
         ).astype(np.float32)[:, None, :]          # some rows saturate
    q = port_kv.quantize_page(_t(x), _t(s))
    np.testing.assert_array_equal(q.numpy(),
                                  _j(jax_kv.quantize_page(x, s)))
    np.testing.assert_array_equal(
        port_kv.dequantize_page(q, _t(s)).numpy(),
        _j(jax_kv.dequantize_page(q.numpy(), s)))
    np.testing.assert_array_equal(port_kv.dequant_scale(_t(s)).numpy(),
                                  _j(jax_kv.dequant_scale(s)))


def test_round_trip_error_bound():
    """|dequant(quant(x)) - x| <= scale / (2 QMAX) when the scale is the
    rows' absmax, and the scale is the per-head absmax."""
    j, t = _pools()
    x = (np.random.RandomState(1).randn(4, 2, 8) * 3.0).astype(np.float32)
    j, t = _store_both(j, t, np.zeros(4, np.int32),
                       np.arange(4, dtype=np.int32), x)
    s = t[1][0].numpy()
    got = port_kv.dequantize_page(t[0][0, :4], t[1][0]).numpy()
    assert np.all(np.abs(got - x) <= (s / (2 * port_kv.KV_QMAX) + 1e-6)[
        None, :, None])
    np.testing.assert_allclose(s, np.abs(x).max(axis=(0, 2)), rtol=1e-6)


def test_running_absmax_regrows_and_requantizes():
    """A row stored before its page's scale grew survives the growth: the
    page re-quantizes by old / new, within one more rounding."""
    j, t = _pools()
    rng = np.random.RandomState(2)
    first = (rng.randn(1, 2, 8) * 0.1).astype(np.float32)
    j, t = _store_both(j, t, np.zeros(1, np.int32), np.zeros(1, np.int32),
                       first)
    s0 = t[1][0].clone()
    big = (rng.randn(1, 2, 8) * 5.0).astype(np.float32)
    j, t = _store_both(j, t, np.zeros(1, np.int32), np.ones(1, np.int32),
                       big)
    s1 = t[1][0]
    assert torch.all(s1 >= s0)
    got0 = port_kv.dequantize_page(t[0][0, 0], s1).numpy()
    assert np.all(np.abs(got0 - first[0])
                  <= (s1.numpy() / port_kv.KV_QMAX + 1e-6)[:, None])


def test_dropped_rows_touch_only_the_sink():
    """Rows aimed at the sink (the reference's out-of-range page) leave
    every real page and scale as they were."""
    j, t = _pools()
    rows = (np.random.RandomState(3).randn(2, 2, 8) * 100).astype(np.float32)
    pages = np.array([4, 4], np.int32)     # the sink; out of range in JAX
    j, t = _store_both(j, t, pages, np.array([0, 1], np.int32), rows)
    assert not t[0][:4].any()
    assert torch.equal(t[1][:4], torch.full((4, 2), FLOOR))
    assert t[1][4].max() > 99               # the sink took the absmax


def test_rows_sharing_a_page_compose_in_one_call():
    j, t = _pools()
    rng = np.random.RandomState(4)
    rows = np.stack([rng.randn(2, 8) * m for m in (0.1, 4.0, 1.0)]
                    ).astype(np.float32)
    j, t = _store_both(j, t, np.zeros(3, np.int32),
                       np.arange(3, dtype=np.int32), rows)
    np.testing.assert_allclose(t[1][0].numpy(),
                               np.abs(rows).max(axis=(0, 2)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_unconditional_requant_is_byte_equal_to_the_gated_one(seed):
    """Forty stores of 1-6 rows at mixed magnitudes into 5 pages, drops
    and rows sharing a page included: the port re-quantizes on every
    store, the reference only when a scale grew, and after every store
    the two hold the same bytes and scales. The reason: an unchanged page
    has ratio exactly 1.0, and round(q * 1.0) == q for every int8 q."""
    q = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(torch.round(q.float() * 1.0).to(torch.int8), q)
    rng = np.random.RandomState(seed)
    P, ps = 5, 4
    j, t = _pools(P=P, ps=ps, H=3)
    grew = 0
    for _ in range(40):
        n = rng.randint(1, 7)
        cells = rng.permutation((P + 1) * ps)[:n]   # distinct cells
        rows = (rng.randn(n, 3, 8) * rng.choice([0.1, 1, 10], (n, 1, 1))
                ).astype(np.float32)
        before = t[1].clone()
        j, t = _store_both(j, t, (cells // ps).astype(np.int32),
                           (cells % ps).astype(np.int32), rows)
        grew += int((t[1][:P] > before[:P]).any())
    assert 0 < grew < 40                  # both branches of the gate ran


def test_write_tokens_q_matches_reference():
    """Two slots' tokens through one page table (an unmapped column
    included) into int8 pools, twice: bytes and scales equal the
    reference's."""
    rng = np.random.RandomState(5)
    P, ps, H, D = 8, 4, 2, 8
    table = np.full((2, 4), -1, np.int32)
    table[0, :3] = [5, 1, 6]
    table[1, :2] = [0, 3]
    jk, jv = (jnp.zeros((P, ps, H, D), jnp.int8) for _ in range(2))
    js, jvs = (jnp.full((P, H), FLOOR, jnp.float32) for _ in range(2))
    tk, tv = (torch.zeros((P + 1, ps, H, D), dtype=torch.int8)
              for _ in range(2))
    ts, tvs = (torch.full((P + 1, H), FLOOR) for _ in range(2))
    for _ in range(2):
        slots = np.array([0] * 6 + [1] * 5, np.int32)
        pos = np.concatenate([rng.permutation(12)[:6],
                              rng.permutation(12)[:5]]).astype(np.int32)
        kn = rng.randn(11, H, D).astype(np.float32)
        vn = (rng.randn(11, H, D) * 3).astype(np.float32)
        jk, jv, js, jvs = jax_write_q(jk, jv, js, jvs, jnp.asarray(table),
                                      slots, pos, kn, vn)
        write_tokens_q(tk, tv, ts, tvs, _t(table), _t(slots), _t(pos),
                       _t(kn), _t(vn))
    for a, b in ((tk, jk), (tv, jv), (ts, js), (tvs, jvs)):
        np.testing.assert_array_equal(a[:P].numpy(), _j(b))


def test_write_tokens_q_limit_drops_pad_tail():
    """Rows at positions >= limit go to the sink: the headroom page's
    scale reflects only the row below the limit, as in the reference."""
    table = np.array([[2, 0, -1, -1]], np.int32)
    rows = (np.random.RandomState(6).randn(8, 2, 8) * 100).astype(np.float32)
    jk, jv, js, jvs = jax_write_q(jnp.zeros((4, 4, 2, 8), jnp.int8),
                                  jnp.zeros((4, 4, 2, 8), jnp.int8),
                                  jnp.full((4, 2), FLOOR),
                                  jnp.full((4, 2), FLOOR), jnp.asarray(table),
                                  np.zeros(8, np.int32),
                                  np.arange(8, dtype=np.int32), rows, rows,
                                  limit=jnp.int32(5))
    tk = torch.zeros((5, 4, 2, 8), dtype=torch.int8)
    tv, ts, tvs = tk.clone(), torch.full((5, 2), FLOOR), torch.full((5, 2),
                                                                    FLOOR)
    write_tokens_q(tk, tv, ts, tvs, _t(table),
                   torch.zeros(8, dtype=torch.int32),
                   torch.arange(8, dtype=torch.int32), _t(rows), _t(rows),
                   limit=torch.tensor(5))
    np.testing.assert_array_equal(tk[:4].numpy(), _j(jk))
    np.testing.assert_array_equal(ts[:4].numpy(), _j(js))
    np.testing.assert_allclose(ts[0].numpy(), np.abs(rows[4]).max(-1),
                               rtol=1e-6)
    assert not tk[0, 1:].any()


def test_int8_write_tracks_the_float_pool():
    """The same tokens into a float pool and an int8 one: dequantized, the
    int8 rows are within one quantization step of the float rows."""
    rng = np.random.RandomState(7)
    table = _t(np.array([[1, 3, 0]], np.int32))
    kf = torch.zeros((5, 4, 2, 16))
    kq = torch.zeros((5, 4, 2, 16), dtype=torch.int8)
    ks = torch.full((5, 2), FLOOR)
    slots = torch.zeros(10, dtype=torch.int32)
    pos = torch.arange(10, dtype=torch.int32)
    rows = _t(rng.randn(10, 2, 16).astype(np.float32))
    write_tokens(kf, kf.clone(), table, slots, pos, rows, rows)
    write_tokens_q(kq, kq.clone(), ks, ks.clone(), table, slots, pos, rows,
                   rows)
    for p in (1, 3, 0):
        deq = port_kv.dequantize_page(kq[p], ks[p])
        assert (deq - kf[p]).abs().max() <= ks[p].max() / port_kv.KV_QMAX


# -- the allocator's scale bookkeeping ----------------------------------------


def _allocs(kv_dtype="int8", num_pages=8):
    kw = dict(num_pages=num_pages, page_size=4, max_batch=2, max_pages=4,
              debug=True, kv_dtype=kv_dtype)
    return JaxAllocator(**kw), PageAllocator(**kw)


def test_allocator_kv_dtype_validated():
    for cls in (JaxAllocator, PageAllocator):
        with pytest.raises(ValueError, match="kv_dtype"):
            cls(8, 4, 2, 4, kv_dtype="fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        _allocs()[1].set_kv_dtype("fp8")


def test_allocator_scale_accounting_follows_the_reference():
    """Claims, flushes, an abort before the flush and frees, in lockstep
    with the reference's allocator: the same established pages and the
    same fresh-scale queue at every step."""
    ja, ta = _allocs()

    def same():
        assert ta._scaled == ja._scaled
        assert ta._fresh_scales == ja._fresh_scales
        assert (ta.page_table == ja.page_table).all()
        ta.check()

    for a in (ja, ta):
        a.ensure(0, 8)
    same()
    assert set(ta._fresh_scales) == set(ta.page_table[0, :2])
    assert ta.take_fresh_scales() == ja.take_fresh_scales()
    same()
    for a in (ja, ta):
        a.ensure(1, 12)                  # claimed, then aborted unflushed
    same()
    for a in (ja, ta):
        a.free_slot(1)
    same()
    assert not ta._fresh_scales
    for a in (ja, ta):
        a.ensure(1, 4)
        a.ensure(0, 16)
    same()
    assert ta.take_fresh_scales() == ja.take_fresh_scales()
    for a in (ja, ta):
        a.free_slot(0)
        a.free_slot(1)
    same()
    assert not ta._scaled


def test_allocator_check_catches_scale_faults():
    _, a = _allocs()
    a.ensure(0, 8)
    a.take_fresh_scales()
    pid = int(a.page_table[0, 0])
    a._scaled.discard(pid)               # an owned page never established
    with pytest.raises(RuntimeError, match="scale"):
        a.check()
    a._scaled.add(pid)
    free = a._free[0]
    a._scaled.add(free)                  # a free page kept as established
    with pytest.raises(RuntimeError, match="scale"):
        a.check()
    a._scaled.discard(free)
    a._fresh_scales.append(free)         # a reset queued for a free page
    with pytest.raises(RuntimeError, match="queue"):
        a.check()
    a._fresh_scales.clear()
    a.check()


def test_bf16_allocator_skips_scale_accounting():
    _, a = _allocs("bf16")
    a.ensure(0, 8)
    assert not a._scaled and not a.take_fresh_scales()
    a.check()
    a.set_kv_dtype("int8")
    assert a.kv_dtype == "int8" and not a._fresh_scales


# -- the model's int8 paged decode step ---------------------------------------


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_int8_paged_decode_step_matches_reference(kv_heads):
    """Two live rows and a dead one, int8 pools: each row's prompt K/V
    quantized in, then four decode steps through the model's int8 branch
    (quantize on store, K4's plain dequant): logits within the fp32
    tolerance of the JAX model's, scales within it, pool bytes equal but
    where the two models' K/V differ across a rounding boundary."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=12)
    rng = np.random.RandomState(8)
    table = np.full((3, 6), -1, np.int32)
    table[0, :3] = [9, 2, 14]
    table[1, :4] = [0, 7, 3, 12]
    plens = [5, 11]
    j_pools = jm.init_paged_cache(16, 4, kv_dtype="int8")
    t_pools = tm.init_paged_cache(16, 4, kv_dtype="int8")
    assert [t.dtype for t in t_pools[0]] == [torch.int8, torch.int8,
                                             torch.float32, torch.float32]
    assert t_pools[0][2].shape == (17, cfg.kv_heads)
    tok = []
    for row, plen in enumerate(plens):
        ids = np.zeros((1, 16), np.int32)
        ids[0, :plen] = rng.randint(0, cfg.vocab_size, plen)
        with torch.no_grad():
            tl, mini = tm.forward_with_cache(_t(ids), tm.init_cache(1, 16), 0)
        tok.append(int(tl[0, plen - 1].argmax()))
        slots = np.full(16, row, np.int32)
        pos = np.arange(16, dtype=np.int32)
        # both sides quantize the port's prefill rows, with the same limit
        j_pools = [jax_write_q(*p, jnp.asarray(table), slots, pos,
                               mk[0].numpy(), mv[0].numpy(),
                               limit=jnp.int32(plen))
                   for p, (mk, mv) in zip(j_pools, mini)]
        for p, (mk, mv) in zip(t_pools, mini):
            write_tokens_q(*p, _t(table), _t(slots), _t(pos), mk[0], mv[0],
                           limit=plen)
    tok = np.array(tok + [0], np.int32)
    lens = np.array(plens + [0], np.int32)
    live = np.array([True, True, False])
    for _ in range(4):
        with no_grad():
            jl, j_pools = jm.forward_decode_paged(
                jnp.asarray(tok[:, None]), j_pools, jnp.asarray(table),
                jnp.asarray(lens), jnp.asarray(live))
        with torch.no_grad():
            tl, t_pools = tm.forward_decode_paged(
                _t(tok[:, None]), t_pools, _t(table), _t(lens), _t(live))
        np.testing.assert_allclose(tl.numpy(), _j(jl), atol=1e-5, rtol=1e-5)
        tok = np.where(live, _j(jl)[:, 0].argmax(-1), tok).astype(np.int32)
        lens = lens + live
    n = diff = 0
    for jp, tp in zip(j_pools, t_pools):
        for a, b in zip(tp[:2], jp[:2]):
            d = np.abs(a[:16].numpy().astype(int) - _j(b).astype(int))
            assert d.max() <= 1
            n, diff = n + d.size, diff + int((d > 0).sum())
        for a, b in zip(tp[2:], jp[2:]):
            np.testing.assert_allclose(a[:16].numpy(), _j(b), rtol=1e-5)
    assert diff <= n * 1e-3, (diff, n)


# -- the paged engine with kv_dtype="int8" ------------------------------------


def _prompts(seed, lens, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def record_margins(tm):
    """Wrap the port model's paged decode step to record, for every live
    row of every step, its top-2 logit margin; returns the list."""
    margins = []
    step = tm.forward_decode_paged

    def recorded(input_ids, caches, page_table, lens, live):
        logits, caches = step(input_ids, caches, page_table, lens, live)
        top2 = logits[:, 0].topk(2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1])[live].tolist())
        return logits, caches

    tm.forward_decode_paged = recorded
    return margins


def assert_first_token_margins(tm, prompts):
    with torch.no_grad():
        for p in prompts:
            top2 = tm(_t(p.astype(np.int64))[None])[0, -1].topk(2).values
            assert top2[0] - top2[1] >= MARGIN, "near-tie: pick another seed"


INT8_CASES = [(None, 0, [5, 17, 9, 30, 3, 12]), (2, 1, [7, 20, 4, 11])]


@pytest.mark.parametrize("kv_heads,seed,lens", INT8_CASES)
def test_int8_serve_streams_match_reference(kv_heads, seed, lens):
    """More requests than slots (MHA and GQA): slots and pages are reused,
    so fresh pages' scales are reset before their installs; prompts span
    three prefill buckets. The streams equal the JAX int8 engine's, the
    allocator ends leak-free, and a page costs what it costs there."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=seed)
    prompts = _prompts(seed + 20, lens)
    kw = dict(max_batch=2, num_pages=16, page_size=8, max_pages=8,
              kv_dtype="int8", debug_pages=True)
    je = JaxEngine(jm, **kw)
    want = je.serve(prompts, JaxGenCfg(max_new_tokens=10), segment_steps=4)
    margins = record_margins(tm)
    te = PagedContinuousBatchingEngine(tm, **kw)
    got = te.serve(prompts, GenerationConfig(max_new_tokens=10),
                   segment_steps=4)
    assert [g.tolist() for g in got] == [np.asarray(w).tolist()
                                        for w in want]
    assert margins and min(margins) >= MARGIN, min(margins)
    assert_first_token_margins(tm, prompts)
    te.alloc.check()
    assert te.alloc.free_pages == 16 and te.free_slots() == 2
    assert te.kv_page_cost() == je.kv_page_cost()
    assert te.caches[0][0].dtype == torch.int8


def test_reset_state_keeps_the_quantized_pools():
    """reset_state on a busy int8 engine: every page back, the same pool
    and scale storage, int8 zeros and floor scales, and the next serve
    gives the stream of a fresh engine and of the reference."""
    jm, tm, _ = make_pair(2, None, seed=0)
    prompt = _prompts(20, [5])[0]
    kw = dict(max_batch=2, num_pages=16, page_size=8, max_pages=8,
              kv_dtype="int8", debug_pages=True)
    eng = PagedContinuousBatchingEngine(tm, **kw)
    ptrs = [t.data_ptr() for entry in eng.caches for t in entry]
    eng.add_request(_prompts(3, [13])[0], GenerationConfig(max_new_tokens=6))
    eng.decode_segment(2)
    assert eng.caches[0][2].max() > FLOOR
    eng.reset_state()
    assert [t.data_ptr() for entry in eng.caches for t in entry] == ptrs
    for kp, vp, ks, vs in eng.caches:
        assert kp.dtype == torch.int8 and not kp.any() and not vp.any()
        assert torch.equal(ks, torch.full_like(ks, FLOOR))
        assert torch.equal(vs, torch.full_like(vs, FLOOR))
    assert eng.alloc.free_pages == 16 and eng.free_slots() == 2
    assert not eng.alloc._fresh_scales and not eng.alloc._scaled
    eng.alloc.check()
    gen = GenerationConfig(max_new_tokens=6)
    out = eng.serve([prompt], gen)[0]
    ref = PagedContinuousBatchingEngine(tm, **kw).serve([prompt], gen)[0]
    want = JaxEngine(jm, **kw).serve([prompt], JaxGenCfg(max_new_tokens=6))
    assert out.tolist() == ref.tolist() == np.asarray(want[0]).tolist()


def test_set_kv_dtype_idle_only():
    """The storage dtype changes only on an idle engine; the change
    rebuilds the pools and drops the programs that held the old ones, and
    the engine then serves as one built int8."""
    _, tm, _ = make_pair(2, None, seed=0)
    prompts = _prompts(20, [5, 17])
    kw = dict(max_batch=2, num_pages=16, page_size=8, max_pages=8)
    eng = PagedContinuousBatchingEngine(tm, **kw)
    gen = GenerationConfig(max_new_tokens=4)
    eng.serve(prompts, gen)
    assert eng.programs.captures == {("segment", 8): 1}
    eng.add_request(prompts[0], gen)
    with pytest.raises(RuntimeError, match="idle"):
        eng.set_kv_dtype("int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        eng.set_kv_dtype("fp8")
    while eng.decode_segment(4):
        pass
    eng.collect_finished()
    eng.set_kv_dtype("int8")
    assert eng.kv_dtype == eng.alloc.kv_dtype == "int8"
    assert eng.caches[0][0].dtype == torch.int8
    out = eng.serve(prompts, gen)
    assert eng.programs.captures == {("segment", 8): 2, ("segment", 4): 1}
    ref = PagedContinuousBatchingEngine(tm, kv_dtype="int8", **kw).serve(
        prompts, gen)
    assert [o.tolist() for o in out] == [r.tolist() for r in ref]
    pools = eng.caches
    eng.set_kv_dtype("int8")             # the same dtype: nothing happens
    assert eng.caches is pools
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedContinuousBatchingEngine(tm, kv_dtype="fp8", **kw)
