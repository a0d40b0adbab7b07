"""The port's automatic prefix cache (refcounted copy-on-write shared KV
pages) against paddle_tpu's, and its own contract, on the CPU.

Against the reference, on the same inputs:

- the chain hashes (``_chain_root``, ``_block_hash``) are byte-equal;
- the allocator: the same seeded (hypothesis) sequences of ``ensure``,
  ``free_slot``, ``lookup_prefix``, ``map_shared``, ``register_blocks``,
  ``cow``, ``count_preemption`` and ``clear_prefix_index`` leave equal page
  tables, refcounts, free heaps, LRU orders, indexes and counters after
  every op, and both ``check()``s pass;
- the device ops (``scatter_rows``, ``copy_page``, ``gather_pages``,
  ``gather_dense`` and their int8 twins) equal the reference's on the real
  pages (the port's pools carry a sink page as their last row);
- the engine: greedy streams, page tables and prefix counters equal on
  pinned prompts, cold and warm, one-shot and chunked, bf16 and int8; int8
  pool bytes and scales equal after a warm admission with copy-on-write
  (a fully cached prompt: the reference math there is pure copies);
- optimistic admission: ``serve()`` over a pool too small for its traffic
  makes the same admissions (the prompt-plus-one-page claim, the
  watermark), growth, short lists, victims and replays, with equal
  allocator state after every call and equal streams, bf16 and int8,
  with and without the prefix cache.

Port against port, the scenarios of ``tests/test_prefix_cache.py`` (the
reference's contract there is bitwise): the refcount-aware validator,
``check_coverage``, warm == cold (one-shot and chunked, MHA and GQA, block
boundary, mid-block CoW, decode into a shared tail page), leak-free cancel,
abort, preempt and ``reset_state``, LRU reclaim, and the metrics surface;
and no shared page changes across a segment that steps past a budget.

Streams are compared on pinned prompts, as ``test_torch_engine.py`` does:
the two engines' logits differ by fp32 summation order, so every greedy
choice along the streams is checked to win by at least ``MARGIN``.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from paddle_tpu.inference import paged_cache as jax_pc
from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxEngine
from paddle_tpu.quantization import kv as jax_kv
from paddle_tpu_torch import (ContinuousBatchingEngine, GenerationConfig,
                              LlamaForCausalLM, PagedContinuousBatchingEngine,
                              llama_config, monitor)
from paddle_tpu_torch.inference import paged_cache as port_pc
from paddle_tpu_torch.inference.paged_cache import PageAllocator
from paddle_tpu_torch.quantization.kv import KV_SCALE_FLOOR
from paddle_tpu_torch.serving import Server

from test_torch_llama import make_pair
from torch_jax_state import jax_reference_state  # noqa: F401

MARGIN = 1e-4
_MODELS = {}
_REFS = {}


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
    return torch.from_numpy(np.array(x))


def tiny_model(kv_heads=4):
    """One tiny 1-layer llama per kv-head layout (4 = MHA, 2 = GQA)."""
    if kv_heads not in _MODELS:
        torch.manual_seed(0)
        cfg = llama_config("tiny", num_hidden_layers=1,
                           num_key_value_heads=kv_heads)
        _MODELS[kv_heads] = (LlamaForCausalLM(cfg, device="cpu"), cfg)
    return _MODELS[kv_heads]


def paged_engine(model, max_batch=4, num_pages=64, page_size=4,
                 max_pages=8, **kw):
    kw.setdefault("debug_pages", True)
    return PagedContinuousBatchingEngine(
        model, max_batch=max_batch, num_pages=num_pages,
        page_size=page_size, max_pages=max_pages, **kw)


def _greedy(n, eos=None):
    return GenerationConfig(max_new_tokens=n, eos_token_id=eos)


def _run_one(eng, ids, n=6, seg=4):
    rid = eng.add_request(ids, _greedy(n))
    while eng.decode_segment(seg):
        pass
    return list(eng.collect_finished()[rid])


def ref_tokens(ids, n=6, kv_heads=4):
    """Greedy tokens of a module-cached plain paged engine (no prefix
    cache), which serves one request at a time and drains fully."""
    if kv_heads not in _REFS:
        _REFS[kv_heads] = paged_engine(tiny_model(kv_heads)[0])
    return _run_one(_REFS[kv_heads], np.asarray(ids, np.int32), n=n)


def _assert_no_leaks(eng):
    """Every reference released: each page free or parked, no slot holds
    anything, and the validator is clean."""
    assert eng.free_slots() == eng.max_batch
    assert eng.alloc.used_pages == 0
    assert eng.alloc.free_pages + eng.alloc.cached_pages == eng.num_pages
    eng.alloc.check()


# -- the chain hash ------------------------------------------------------------


@pytest.mark.parametrize("salt", [b"", b"adapter@1", b"\x00\xff" * 9])
def test_block_hash_is_byte_equal_to_the_reference(salt):
    assert port_pc._ROOT == jax_pc._ROOT
    assert port_pc._chain_root(salt) == jax_pc._chain_root(salt)
    rng = np.random.RandomState(len(salt))
    toks = rng.randint(0, 2 ** 31 - 1, (5, 16)).astype(np.int64)
    hp = hj = port_pc._chain_root(salt)
    for block in toks:
        hp = port_pc._block_hash(hp, block)
        hj = jax_pc._block_hash(hj, block)
        assert hp == hj and len(hp) == 16
    # the lookup's hash chain is the reference allocator's too
    kw = dict(num_pages=8, page_size=16, max_batch=1, max_pages=8,
              prefix_cache=True)
    flat = toks.reshape(-1)
    assert (PageAllocator(**kw).lookup_prefix(flat, salt=salt)[2]
            == jax_pc.PageAllocator(**kw).lookup_prefix(flat, salt=salt)[2])


# -- the allocator, op for op --------------------------------------------------

_FAMILIES = [np.random.RandomState(s).randint(0, 50, (24,)).astype(np.int32)
             for s in range(3)]
_OPS = st.tuples(st.sampled_from(["admit", "admit", "ensure", "free", "cow",
                                  "preempt", "clear", "flush"]),
                 st.integers(0, 2), st.integers(0, 40))


def _same_alloc(ja, ta):
    assert (ta.page_table == ja.page_table).all()
    assert ta._owned == ja._owned
    assert ta._ref == ja._ref
    assert ta._free == ja._free
    assert list(ta._parked.items()) == list(ja._parked.items())
    assert ta._index == ja._index
    assert ta._hash_of == ja._hash_of
    assert ta._parent_of == ja._parent_of
    assert ta._next == ja._next
    assert ta._tok_of.keys() == ja._tok_of.keys()
    for pid in ta._tok_of:
        assert np.array_equal(ta._tok_of[pid], ja._tok_of[pid])
    assert ta._scaled == ja._scaled
    assert ta._fresh_scales == ja._fresh_scales
    for name in ("prefix_lookups", "prefix_hits", "prefix_tokens_saved",
                 "cow_copies", "preemptions", "shared_pages", "free_pages",
                 "cached_pages", "used_pages", "available_pages"):
        assert getattr(ta, name) == getattr(ja, name), name
    ja.check()
    ta.check()


def _apply(a, op, slot, p, ps):
    """One op of the differential run on allocator ``a``; a no-op where the
    op is not valid in the current state (decided from ``a``'s state, which
    the comparison holds equal on both sides). Returns what it observed."""
    owned = a._owned.get(slot, [])
    if op == "admit":
        toks = _FAMILIES[p % 3][:4 + (p * 5) % 17]
        got = a.lookup_prefix(toks)
        if owned or not a.can_fit(slot, len(toks) + 2):
            return got
        pids, cov, hashes = got
        a.map_shared(slot, pids)
        a.ensure(slot, len(toks) + 2)
        a.register_blocks(slot, hashes, toks, cov // ps, len(toks) // ps)
        if cov:
            a.count_prefix_hit(min(cov, len(toks) - 1))
        return got
    if op == "ensure":
        n = min(a.covered_tokens(slot) + 1 + p % 7,
                ps * a.page_table.shape[1])
        if a.can_fit(slot, n):
            a.ensure(slot, n)
    elif op == "free":
        a.free_slot(slot)
    elif op == "cow":
        if owned and a.available_pages:
            idx = p % len(owned)
            if a.needs_cow(slot, idx * ps):
                old, new = a.cow(slot, idx)
                a.note_scale_copied(new)
                return old, new
    elif op == "preempt":
        if owned:
            a.count_preemption("pressure")
            a.free_slot(slot)
    elif op == "clear":
        a.clear_prefix_index()
    elif op == "flush":
        return a.take_fresh_scales()
    return None


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=st.lists(_OPS, min_size=1, max_size=40))
def test_allocator_follows_the_reference(kv_dtype, ops):
    kw = dict(num_pages=10, page_size=4, max_batch=3, max_pages=8,
              prefix_cache=True, kv_dtype=kv_dtype)
    ja, ta = jax_pc.PageAllocator(**kw), PageAllocator(**kw)
    for op, slot, p in ops:
        assert _apply(ta, op, slot, p, 4) == _apply(ja, op, slot, p, 4)
        _same_alloc(ja, ta)


# -- the device ops ------------------------------------------------------------


def _pools(quant, P=6, ps=4, H=2, D=8, seed=0):
    """Random pools (and int8 scales) as the reference's arrays and the
    port's tensors, the port's with a sink row."""
    rng = np.random.RandomState(seed)
    if quant:
        k = rng.randint(-127, 128, (P, ps, H, D)).astype(np.int8)
        v = rng.randint(-127, 128, (P, ps, H, D)).astype(np.int8)
        ks = rng.uniform(0.5, 2.0, (P, H)).astype(np.float32)
        vs = rng.uniform(0.5, 2.0, (P, H)).astype(np.float32)
        arrs = [k, v, ks, vs]
    else:
        arrs = [rng.randn(P, ps, H, D).astype(np.float32) for _ in range(2)]
    port = [torch.cat([_t(a), _t(np.zeros_like(a[:1]))]) for a in arrs]
    if quant:
        port[2][-1] = KV_SCALE_FLOOR
        port[3][-1] = KV_SCALE_FLOOR
    return [jnp.asarray(a) for a in arrs], port


def _same_rows(got, want, quant, eager=None):
    """Equal rows. Dequantized rows equal the reference's dequant evaluated
    eagerly (``eager``) and are within two ulps of its jitted gathers: XLA
    turns the division by KV_QMAX into a multiplication by its reciprocal
    there, one more rounding than the eager formula the port computes."""
    if quant:
        np.testing.assert_array_equal(got, eager)
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
    else:
        np.testing.assert_array_equal(got, want)


def _same_pools(jp, tp):
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(t[:-1].numpy(), _j(j))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("start,limit,width", [(0, 9, 16), (5, 13, 8),
                                               (6, 6, 4), (30, 32, 4),
                                               (10, 25, 16)])
def test_scatter_rows_matches_reference(quant, start, limit, width):
    jp, tp = _pools(quant, P=8, seed=start)
    table = np.array([[3, 0, 5, -1, 7, 1, -1, 2],
                      [4, 6, -1, -1, -1, -1, -1, -1]], np.int32)
    rng = np.random.RandomState(limit)
    mk = rng.randn(1, 32, 2, 8).astype(np.float32) * 3
    mv = rng.randn(1, 32, 2, 8).astype(np.float32) * 3
    fj = jax_pc.scatter_rows_q if quant else jax_pc.scatter_rows
    ft = port_pc.scatter_rows_q if quant else port_pc.scatter_rows
    jp = fj(*jp, jnp.asarray(table), jnp.int32(0), jnp.int32(start),
            jnp.int32(limit), jnp.asarray(mk), jnp.asarray(mv), width=width)
    ft(*tp, _t(table), 0, start, limit, _t(mk), _t(mv), width=width)
    _same_pools(jp, tp)


@pytest.mark.parametrize("quant", [False, True])
def test_copy_page_matches_reference(quant):
    jp, tp = _pools(quant, seed=1)
    fj = jax_pc.copy_page_q if quant else jax_pc.copy_page
    ft = port_pc.copy_page_q if quant else port_pc.copy_page
    for src, dst in ((2, 4), (0, 0), (5, 1)):
        jp = fj(*jp, jnp.int32(src), jnp.int32(dst))
        ft(*tp, src, dst)
        _same_pools(jp, tp)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n", [0, 3, 8])
def test_gather_pages_matches_reference(quant, n):
    jp, tp = _pools(quant, P=10, seed=2)
    pids = [7, 2, 9, 0, 4, 4, 1, 3][:n]
    row = np.full((8,), -1, np.int32)
    row[:n] = pids
    mk = np.full((1, 32, 2, 8), 5.0, np.float32)
    mv = np.full((1, 32, 2, 8), -5.0, np.float32)
    fj = jax_pc.gather_pages_q if quant else jax_pc.gather_pages
    ft = port_pc.gather_pages_q if quant else port_pc.gather_pages
    jk, jv = fj(*jp, jnp.asarray(row), jnp.asarray(mk), jnp.asarray(mv))
    tk, tv = ft(*tp, _t(row), _t(mk.copy()), _t(mv.copy()))
    # mapped rows equal; the -1 tail reads page 0 there and the sink here,
    # junk past the cached coverage either way
    m = 4 * n
    for got, want, pool, sc in ((tk, jk, 0, 2), (tv, jv, 1, 3)):
        eager = None
        if quant:
            idx = np.asarray(pids, np.int64)
            eager = _j(jax_kv.dequantize_page(
                _j(jp[pool])[idx], _j(jp[sc])[idx][:, None, :])).reshape(
                1, m, 2, 8)
        _same_rows(got[:, :m].numpy(), _j(want)[:, :m], quant, eager)


@pytest.mark.parametrize("quant", [False, True])
def test_gather_dense_matches_reference(quant):
    jp, tp = _pools(quant, P=6, seed=3)
    table = np.array([[3, 0, 5, -1], [1, 2, -1, -1]], np.int32)
    for row in (0, 1):
        if quant:
            j = jax_pc.gather_dense_q(jp[0], jp[2], jnp.asarray(table),
                                      row)
            t = port_pc.gather_dense_q(tp[0], tp[2], _t(table), row)
        else:
            j = jax_pc.gather_dense(jp[0], jnp.asarray(table), row)
            t = port_pc.gather_dense(tp[0], _t(table), row)
        idx = table[row][table[row] >= 0].astype(np.int64)
        m = 4 * len(idx)
        eager = (_j(jax_kv.dequantize_page(
            _j(jp[0])[idx], _j(jp[2])[idx][:, None, :])).reshape(m, 2, 8)
            if quant else None)
        _same_rows(t[:m].numpy(), _j(j)[:m], quant, eager)


# -- the engine against the reference's ----------------------------------------


def _record_margins(tm):
    """Record every live row's top-2 margin of the port's paged decode."""
    margins = []
    step = tm.forward_decode_paged

    def recorded(input_ids, caches, page_table, lens, live):
        logits, caches = step(input_ids, caches, page_table, lens, live)
        top2 = logits[:, 0].topk(2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1])[live].tolist())
        return logits, caches

    tm.forward_decode_paged = recorded
    return margins


def _first_margins(tm, prompts):
    with torch.no_grad():
        for p in prompts:
            top2 = tm(_t(p.astype(np.int64))[None])[0, -1].topk(2).values
            assert top2[0] - top2[1] >= MARGIN, "near-tie: pick another seed"


def _engine_prompts(seed, vocab=256):
    """A shared 13-token prefix with suffixes that diverge at a block
    boundary and mid-block, a whole-prompt repeat, and a prompt that is a
    cached prefix ending mid-page."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, (13,)).astype(np.int32)
    p0 = np.concatenate([shared, rng.randint(0, vocab, (5,))]).astype(
        np.int32)
    p1 = np.concatenate([shared[:12], rng.randint(0, vocab, (3,))]).astype(
        np.int32)
    p2 = np.concatenate([shared, rng.randint(0, vocab, (4,))]).astype(
        np.int32)
    return [p0, p1, p0.copy(), p2, p0[:10].copy()]


def _admit(eng, ids, cfg, chunked):
    if not chunked:
        return eng.add_request(ids, cfg)
    adm = eng.begin_admit(ids, cfg)
    while not eng.admit_chunk(adm):
        pass
    return adm.rid


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("chunked", [False, True])
def test_engine_matches_reference(kv_dtype, chunked):
    """The same admissions and segments on both prefix-cache engines: equal
    page tables and prefix counters after every step, and equal streams.
    Two slots for five prompts, so pages are shared, copied on write,
    parked and reclaimed."""
    jm, tm, cfg = make_pair(2, 2, seed=3)
    prompts = _engine_prompts(7)
    kw = dict(max_batch=2, num_pages=14, page_size=4, max_pages=8,
              kv_dtype=kv_dtype, prefix_cache=True, debug_pages=True,
              prefill_chunk=8 if chunked else None)
    je = JaxEngine(jm, **kw)
    margins = _record_margins(tm)
    te = PagedContinuousBatchingEngine(tm, **kw)

    def same():
        assert (te.alloc.page_table == je.alloc.page_table).all()
        for name in ("prefix_lookups", "prefix_hits", "prefix_tokens_saved",
                     "cow_copies", "cached_pages", "shared_pages",
                     "free_pages"):
            assert getattr(te.alloc, name) == getattr(je.alloc, name), name
        assert list(te.alloc._parked) == list(je.alloc._parked)
        assert te.alloc._index == je.alloc._index

    want, got = {}, {}
    pending = list(enumerate(prompts))
    order_j, order_t = {}, {}
    while pending or te._slot_req:
        while pending and te.free_slots():
            i, p = pending.pop(0)
            order_j[_admit(je, p, JaxGenCfg(max_new_tokens=7), chunked)] = i
            order_t[_admit(te, p, _greedy(7), chunked)] = i
            same()
        je.decode_segment(3)
        te.decode_segment(3)
        same()
        want.update({order_j[r]: s for r, s in je.collect_finished().items()})
        got.update({order_t[r]: s for r, s in te.collect_finished().items()})
    assert sorted(got) == list(range(len(prompts)))
    assert ([np.asarray(got[i]).tolist() for i in range(len(prompts))]
            == [np.asarray(want[i]).tolist() for i in range(len(prompts))])
    assert te.alloc.prefix_hits >= 3 and te.alloc.cow_copies >= 1
    assert margins and min(margins) >= MARGIN, min(margins)
    _first_margins(tm, prompts)
    te.alloc.check()


def _alloc_state(a):
    """A copy of everything the allocator decides: the table, each page's
    owner, refcount and state, the prefix index and the counters."""
    state = dict(table=a.page_table.tolist(), owned=copy.deepcopy(a._owned),
                 free=list(a._free))
    for name in ("preemptions", "free_pages", "used_pages",
                 "available_pages"):
        state[name] = getattr(a, name)
    if a.prefix_cache:
        state.update(ref=dict(a._ref), parked=list(a._parked.items()),
                     index=dict(a._index))
        for name in ("prefix_hits", "prefix_tokens_saved", "cow_copies",
                     "cached_pages", "shared_pages"):
            state[name] = getattr(a, name)
    return state


def _log_gaps(eng, log):
    """Log every call ``serve()`` makes to the engine's admission, growth,
    preemption and segment entry points: the call, what it returned and the
    allocator's state after it."""
    def wrapped(name):
        call = getattr(eng, name)

        def logged(*args, **kw):
            out = call(*args, **kw)
            seen = (len(args[0]) if name == "add_request"
                    else np.asarray(out).tolist())
            log.append((name, seen, _alloc_state(eng.alloc)))
            return out
        setattr(eng, name, logged)

    for name in ("add_request", "grow_for_segment", "preempt_request",
                 "decode_segment"):
        wrapped(name)


def _record_first_margins(te):
    """Record the top-2 margin of every admission's first token."""
    margins = []
    sample = te._sample_first

    def recorded(slot, plen, last_logits, cfg):
        top2 = last_logits[0].topk(2).values
        margins.append(float(top2[0] - top2[1]))
        return sample(slot, plen, last_logits, cfg)

    te._sample_first = recorded
    return margins


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("prefix_cache,num_pages,chunk,watermark", [
    (True, 13, None, 1.0), (True, 13, 8, 0.9), (False, 13, None, 1.0)])
def test_optimistic_serve_matches_reference(kv_dtype, prefix_cache,
                                            num_pages, chunk, watermark):
    """``serve()`` on both optimistic engines over a pool too small for
    the traffic: the same admissions (the claim of prompt plus one page,
    the watermark), the same growth and short lists in every gap, the same
    victims (the youngest) and replay prompts, equal allocator state after
    every call, equal preemption counts and equal streams."""
    jm, tm, cfg = make_pair(2, 2, seed=3)
    prompts = _engine_prompts(7)
    kw = dict(max_batch=4, num_pages=num_pages, page_size=4, max_pages=10,
              kv_dtype=kv_dtype, prefix_cache=prefix_cache,
              admission_mode="optimistic", kv_watermark=watermark,
              prefill_chunk=chunk, debug_pages=True)
    je = JaxEngine(jm, **kw)
    te = PagedContinuousBatchingEngine(tm, **kw)
    jlog, tlog = [], []
    _log_gaps(je, jlog)
    _log_gaps(te, tlog)
    decode_margins = _record_margins(tm)
    first_margins = _record_first_margins(te)
    want = je.serve(prompts, JaxGenCfg(max_new_tokens=18), segment_steps=4)
    got = te.serve(prompts, _greedy(18), segment_steps=4)
    assert [np.asarray(s).tolist() for s in got] == [
        np.asarray(s).tolist() for s in want]
    assert len(tlog) == len(jlog)
    for i, (t, j) in enumerate(zip(tlog, jlog)):
        assert t == j, (i, t[:2], j[:2])
    assert te.alloc.preemptions == je.alloc.preemptions >= 1
    assert te.serve_stats["preemptions"] == te.alloc.preemptions
    assert any(name == "grow_for_segment" and short
               for name, short, _ in tlog)
    if prefix_cache:
        assert te.alloc.prefix_hits >= 1
    assert min(decode_margins) >= MARGIN, min(decode_margins)
    assert min(first_margins) >= MARGIN, min(first_margins)
    _assert_no_leaks(te)


def test_int8_warm_cow_bytes_match_reference():
    """A fully cached prompt ending mid-page, int8: its warm admission is
    all copies (the gathered prefix, the copy-on-write of the partial tail
    page with its scale rows; the recomputed last token's KV is masked
    out), so after it the pools equal the reference's byte for byte, given
    the same pools before it."""
    jm, tm, cfg = make_pair(2, 2, seed=3)
    kw = dict(max_batch=2, num_pages=12, page_size=4, max_pages=8,
              kv_dtype="int8", prefix_cache=True, debug_pages=True)
    je = JaxEngine(jm, **kw)
    te = PagedContinuousBatchingEngine(tm, **kw)
    donor = _engine_prompts(7)[0]
    for e, c in ((je, JaxGenCfg(max_new_tokens=3)), (te, _greedy(3))):
        e.add_request(donor, c)
        while e.decode_segment(2):
            pass
        e.collect_finished()
    assert (te.alloc.page_table == je.alloc.page_table).all()
    pools, _ = je.caches
    with torch.no_grad():           # the same bytes before the admission
        for jentry, tentry in zip(pools, te.caches):
            for j, t in zip(jentry, tentry):
                t[:-1].copy_(_t(_j(j)))
    probe = donor[:14].copy()         # 3 full blocks and 2 rows of one
    je.add_request(probe, JaxGenCfg(max_new_tokens=3))
    te.add_request(probe, _greedy(3))
    assert te.alloc.cow_copies == je.alloc.cow_copies == 1
    assert (te.alloc.page_table == je.alloc.page_table).all()
    assert te.alloc._scaled == je.alloc._scaled
    pools, _ = je.caches
    for jentry, tentry in zip(pools, te.caches):
        for j, t in zip(jentry, tentry):
            np.testing.assert_array_equal(t[:-1].numpy(), _j(j))
    slot = next(iter(te._slot_req))
    new = int(te.alloc.page_table[slot, 3])
    src = te.alloc._index[te.alloc.lookup_prefix(donor[:16])[2][3]]
    for entry in te.caches:
        for t in entry:
            assert torch.equal(t[new], t[src])


# -- the allocator's sharing contract (port against port) ----------------------
class TestAllocatorSharing:
    def _alloc(self, num_pages=12, **kw):
        kw.setdefault("prefix_cache", True)
        return PageAllocator(num_pages=num_pages, page_size=4, max_batch=3,
                             max_pages=6, **kw)

    def _populate(self, a, toks, slot=0):
        """Cold-path bookkeeping: claim, register the full blocks, release
        (the blocks park). Returns the chain hashes."""
        _, _, hashes = a.lookup_prefix(toks)
        a.ensure(slot, len(toks))
        a.register_blocks(slot, hashes, toks, 0, len(toks) // a.page_size)
        a.free_slot(slot)
        return hashes

    def test_shared_page_partitions_by_refcount(self):
        a = self._alloc()
        toks = np.arange(8, dtype=np.int32)
        self._populate(a, toks)
        assert a.cached_pages == 2
        pids, cov, _ = a.lookup_prefix(toks)
        assert cov == 8
        a.map_shared(0, pids)
        a.map_shared(1, list(pids))
        a.check()
        assert a.shared_pages == 2
        a.free_slot(0)
        a.check()
        assert a.shared_pages == 0
        a.free_slot(1)
        a.check()
        assert a.cached_pages == 2 and a.used_pages == 0

    def test_appearance_without_refcount_detected(self):
        a = self._alloc()
        a.ensure(0, 4)
        a._owned[1] = [a._owned[0][0]]
        a.page_table[1, 0] = a._owned[0][0]
        with pytest.raises(RuntimeError, match="matching refcount"):
            a.check()

    def test_refcount_leak_detected(self):
        a = self._alloc()
        a.ensure(0, 4)
        a._ref[a._owned[0][0]] = 2
        with pytest.raises(RuntimeError, match="refcount"):
            a.check()

    def test_parked_page_also_free_detected(self):
        a = self._alloc()
        self._populate(a, np.arange(4, dtype=np.int32))
        a._free.append(next(iter(a._parked)))
        with pytest.raises(RuntimeError, match="parked"):
            a.check()

    def test_indexed_unparked_orphan_detected(self):
        a = self._alloc()
        self._populate(a, np.arange(4, dtype=np.int32))
        a._parked.clear()
        with pytest.raises(RuntimeError, match="not.*parked|missing"):
            a.check()

    def test_lookup_is_token_verified(self):
        a = self._alloc()
        toks = np.arange(8, dtype=np.int32)
        self._populate(a, toks)
        pid = a._index[a.lookup_prefix(toks)[2][0]]
        a._tok_of[pid] = a._tok_of[pid] + 1
        pids, cov, _ = a.lookup_prefix(toks)
        assert cov == 0 and pids == []

    def test_partial_block_match(self):
        a = self._alloc()
        self._populate(a, np.arange(8, dtype=np.int32))
        probe = np.array([0, 1, 2, 3, 4, 5, 99, 98], np.int32)
        pids, cov, _ = a.lookup_prefix(probe)
        assert len(pids) == 2 and cov == 6

    def test_lru_reclaim_oldest_first_and_touch(self):
        a = self._alloc(num_pages=3)
        blocks = [np.full((4,), 10 + i, np.int32) for i in range(3)]
        for b in blocks:
            self._populate(a, b, slot=0)
        assert a.cached_pages == 3 and a.free_pages == 0
        a.lookup_prefix(blocks[0])      # touch: block 0 becomes the newest
        a.ensure(1, 4)                  # one page: evicts the LRU
        assert a.cached_pages == 2
        assert a.lookup_prefix(blocks[1])[1] == 0
        assert a.lookup_prefix(blocks[0])[1] == 4
        a.free_slot(1)
        a.check()

    def test_available_counts_parked(self):
        a = self._alloc(num_pages=3)
        self._populate(a, np.arange(12, dtype=np.int32))
        assert a.free_pages == 0 and a.available_pages == 3
        assert a.can_fit(1, 12)
        a.ensure(1, 12)
        assert a.cached_pages == 0
        a.free_slot(1)
        a.check()

    def test_cow_bookkeeping(self):
        a = self._alloc()
        toks = np.arange(4, dtype=np.int32)
        self._populate(a, toks)
        pids, _, _ = a.lookup_prefix(toks)
        a.map_shared(0, pids)
        a.map_shared(1, list(pids))
        old, new = a.cow(1, 0)
        assert old == pids[0] and new != old
        assert a._ref[old] == 1 and a._ref[new] == 1
        assert a.page_table[1, 0] == new
        assert a.cow_copies == 1
        a.check()
        a.free_slot(0)
        a.free_slot(1)
        assert a.lookup_prefix(toks)[1] == 4
        a.check()

    def test_map_shared_needs_empty_slot(self):
        a = self._alloc()
        toks = np.arange(4, dtype=np.int32)
        self._populate(a, toks)
        a.ensure(0, 4)
        with pytest.raises(RuntimeError, match="empty slot"):
            a.map_shared(0, a.lookup_prefix(toks)[0])
        a.free_slot(0)

    def test_check_coverage_past_mapping(self):
        a = self._alloc()
        a.ensure(0, 8)
        a.check_coverage(0, 8)
        with pytest.raises(RuntimeError, match="extends past"):
            a.check_coverage(0, 9)

    def test_check_coverage_shared_write_detected(self):
        a = self._alloc()
        toks = np.arange(8, dtype=np.int32)
        self._populate(a, toks)
        pids, _, _ = a.lookup_prefix(toks)
        a.map_shared(0, pids)
        with pytest.raises(RuntimeError, match="copy-on-write"):
            a.check_coverage(0, 6)
        a.cow(0, 1)
        a.check_coverage(0, 6)
        a.free_slot(0)

    def test_disabled_prefix_cache_is_plain_allocator(self):
        a = self._alloc(prefix_cache=False)
        toks = np.arange(8, dtype=np.int32)
        a.lookup_prefix(toks)
        a.ensure(0, 8)
        a.register_blocks(0, [], toks, 0, 2)
        a.free_slot(0)
        assert a.cached_pages == 0 and a.free_pages == a.num_pages
        a.check()

    def test_int8_cow_waits_for_its_scale_copy(self):
        """An int8 copy-on-write's page leaves the fresh-scale queue (a
        flush would floor the copied scales) and is established only by
        note_scale_copied; until then check() rejects it."""
        a = self._alloc(kv_dtype="int8")
        toks = np.arange(4, dtype=np.int32)
        self._populate(a, toks)
        a.take_fresh_scales()
        a.map_shared(0, a.lookup_prefix(toks)[0])
        _, new = a.cow(0, 0)
        assert new not in a._fresh_scales and new not in a._scaled
        with pytest.raises(RuntimeError, match="scales"):
            a.check()
        a.note_scale_copied(new)
        a.check()
        a.free_slot(0)
        a.check()


# -- engine: warm == cold (port against port) ----------------------------------
class TestParity:
    @pytest.mark.parametrize("kv_heads", [4, 2])
    def test_cold_warm_cow_parity(self, kv_heads):
        model, cfg = tiny_model(kv_heads)
        rng = np.random.RandomState(0)
        eng = paged_engine(model, prefix_cache=True)
        donor = rng.randint(0, cfg.vocab_size, (12,)).astype(np.int32)
        want = ref_tokens(donor, kv_heads=kv_heads)
        assert _run_one(eng, donor) == want          # cold populates
        assert eng.alloc.cached_pages == 3
        assert _run_one(eng, donor) == want          # full block hit
        assert eng.alloc.prefix_hits == 1
        pb = donor.copy()                            # diverges at a block
        pb[8] = (pb[8] + 1) % cfg.vocab_size
        assert _run_one(eng, pb) == ref_tokens(pb, kv_heads=kv_heads)
        assert eng.alloc.cow_copies == 0
        pm = donor.copy()                            # diverges mid-block
        pm[10] = (pm[10] + 1) % cfg.vocab_size
        assert _run_one(eng, pm) == ref_tokens(pm, kv_heads=kv_heads)
        assert eng.alloc.cow_copies == 1
        pt = donor[:10].copy()                       # decode into shared
        assert _run_one(eng, pt) == ref_tokens(pt, kv_heads=kv_heads)
        assert eng.alloc.cow_copies == 2
        assert eng.alloc.prefix_hits >= 3
        assert eng.alloc.prefix_tokens_saved > 0
        _assert_no_leaks(eng)
        if kv_heads == 4:
            dense = ContinuousBatchingEngine(model, max_batch=2, max_len=32)
            assert _run_one(dense, donor) == want

    def test_concurrent_sharing_parity(self):
        model, cfg = tiny_model()
        rng = np.random.RandomState(1)
        shared = rng.randint(0, cfg.vocab_size, (8,)).astype(np.int32)
        prompts = [np.concatenate(
            [shared, rng.randint(0, cfg.vocab_size, (2,)).astype(np.int32)])
            for _ in range(3)]
        want = [ref_tokens(p) for p in prompts]
        eng = paged_engine(model, prefix_cache=True)
        srv = Server(eng, segment_steps=4)
        try:
            hs = [srv.submit(p, _greedy(6)) for p in prompts]
            got = [list(h.result(timeout=120)) for h in hs]
            hits = eng.alloc.prefix_hits
        finally:
            srv.shutdown()
        _assert_no_leaks(eng)
        assert got == want and hits >= 1

    def test_chunked_warm_parity(self):
        model, cfg = tiny_model()
        rng = np.random.RandomState(2)
        shared = rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32)
        prompts = [np.concatenate(
            [shared, rng.randint(0, cfg.vocab_size, (6,)).astype(np.int32)])
            for _ in range(2)]
        want = [ref_tokens(p, n=5) for p in prompts]
        eng = paged_engine(model, prefill_chunk=8, prefix_cache=True)
        srv = Server(eng, segment_steps=4)
        try:
            hs = [srv.submit(p, _greedy(5)) for p in prompts]
            got = [list(h.result(timeout=120)) for h in hs]
            saved = eng.alloc.prefix_tokens_saved
        finally:
            srv.shutdown()
        _assert_no_leaks(eng)
        assert got == want
        assert saved >= 8     # whole chunks of prefill skipped

    def test_shared_pages_untouched_past_budget(self):
        """An optimistic segment steps past a request's budget: those steps
        write to uncovered positions (the sink) and read clamped pages.
        No shared page's bytes change across it, and the kept tokens are
        the cold ones."""
        model, cfg = tiny_model()
        rng = np.random.RandomState(12)
        donor = rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32)
        eng = paged_engine(model, prefix_cache=True,
                           admission_mode="optimistic", kv_watermark=1.0)
        want = _run_one(eng, donor, n=3)
        rid = eng.add_request(donor, _greedy(3))     # a 4-block hit
        slot = next(iter(eng._slot_req))
        shared = [int(p) for p in eng.alloc._owned[slot]
                  if p in eng.alloc._hash_of]
        assert len(shared) == 4
        before = [[t[shared].clone() for t in entry] for entry in eng.caches]
        eng.decode_segment(8)                        # budget 2 < 8 steps
        after = [[t[shared] for t in entry] for entry in eng.caches]
        for b, a in zip(before, after):
            for x, y in zip(b, a):
                assert torch.equal(x, y)
        assert list(eng.collect_finished()[rid]) == want
        _assert_no_leaks(eng)


# -- lifecycle: every retirement releases, never frees a shared page -----------
class TestLifecycle:
    def test_cancel_and_reset_state_decrement_leak_free(self):
        model, cfg = tiny_model()
        rng = np.random.RandomState(4)
        shared = rng.randint(0, cfg.vocab_size, (8,)).astype(np.int32)
        p1 = np.concatenate([shared, [1, 2]]).astype(np.int32)
        p2 = np.concatenate([shared, [3, 4]]).astype(np.int32)
        want = ref_tokens(p1, n=10)
        eng = paged_engine(model, prefix_cache=True)
        r1 = eng.add_request(p1, _greedy(10))
        r2 = eng.add_request(p2, _greedy(10))
        eng.decode_segment(2)
        assert eng.alloc.shared_pages == 2
        eng.cancel_request(r2)
        eng.alloc.check()
        assert eng.alloc.shared_pages == 0
        while eng.decode_segment(4):
            pass
        assert list(eng.collect_finished()[r1]) == want
        _assert_no_leaks(eng)
        assert eng.alloc.cached_pages > 0
        caps = eng.programs.captures
        eng.reset_state()
        assert eng.alloc.cached_pages == 0
        assert eng.alloc.free_pages == eng.num_pages
        assert eng.alloc.lookup_prefix(p1)[1] == 0
        eng.alloc.check()
        assert _run_one(eng, p1, n=10) == want
        assert eng.programs.captures == caps        # graphs kept

    def test_chunked_abort_decrements_leak_free(self):
        model, cfg = tiny_model()
        rng = np.random.RandomState(5)
        shared = rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32)
        eng = paged_engine(model, max_pages=16, prefill_chunk=8,
                           prefix_cache=True)
        donor = np.concatenate(
            [shared, rng.randint(0, cfg.vocab_size, (4,)).astype(np.int32)])
        want = _run_one(eng, donor, n=4)
        cached = eng.alloc.cached_pages
        assert cached > 0
        adm = eng.begin_admit(np.concatenate(
            [shared, rng.randint(0, cfg.vocab_size, (17,)).astype(np.int32)]),
            _greedy(4))
        assert eng.admit_chunk(adm) is False
        eng.abort_admit(adm)
        eng.alloc.check()
        assert eng.alloc.cached_pages == cached
        _assert_no_leaks(eng)
        assert _run_one(eng, donor, n=4) == want
        assert eng.alloc.prefix_hits >= 1
        # a partial-block warm CHUNKED admission copies the shared page at
        # begin_admit, atomically with its claim
        probe = np.concatenate(
            [donor[:18], rng.randint(0, cfg.vocab_size, (6,)).astype(
                np.int32)])
        adm2 = eng.begin_admit(probe, _greedy(4))
        assert eng.alloc.cow_copies >= 1
        while not eng.admit_chunk(adm2):
            pass
        while eng.decode_segment(4):
            pass
        got = list(eng.collect_finished()[adm2.rid])
        ref = paged_engine(model, max_pages=16)
        assert got == _run_one(ref, probe, n=4)
        _assert_no_leaks(eng)

    def test_preempt_releases_only_own_refs(self):
        model, cfg = tiny_model()
        rng = np.random.RandomState(6)
        shared = rng.randint(0, cfg.vocab_size, (8,)).astype(np.int32)
        p1 = np.concatenate([shared, [5, 6]]).astype(np.int32)
        p2 = np.concatenate([shared, [7, 8]]).astype(np.int32)
        want = ref_tokens(p1, n=10)
        eng = paged_engine(model, prefix_cache=True,
                           admission_mode="optimistic")
        r1 = eng.add_request(p1, _greedy(10))
        r2 = eng.add_request(p2, _greedy(10))
        eng.decode_segment(2)
        assert eng.alloc.shared_pages == 2
        assert eng.preempt_request(r2, reason="pressure") is not None
        eng.alloc.check()
        slot1 = [s for s, r in eng._slot_req.items() if r == r1][0]
        assert all(eng.alloc._ref.get(p, 0) >= 1
                   for p in eng.alloc._owned[slot1])
        while eng.decode_segment(4):
            pass
        assert list(eng.collect_finished()[r1]) == want
        _assert_no_leaks(eng)

    def test_preempt_replay_warm_parity_under_pressure(self):
        """Optimistic small pool with shared prefixes: pressure preempts a
        sharer, the replay re-admits WARM, and every stream is the
        unpressured one."""
        model, cfg = tiny_model()
        rng = np.random.RandomState(7)
        shared = rng.randint(0, cfg.vocab_size, (8,)).astype(np.int32)
        prompts = [np.concatenate(
            [shared, rng.randint(0, cfg.vocab_size, (2,)).astype(np.int32)])
            for _ in range(3)]
        want = [ref_tokens(p, n=12) for p in prompts]
        eng = paged_engine(model, max_batch=3, num_pages=12,
                           prefix_cache=True, admission_mode="optimistic")
        srv = Server(eng, segment_steps=4, max_preemptions=10)
        try:
            hs = [srv.submit(p, _greedy(12)) for p in prompts]
            got = [list(h.result(timeout=180)) for h in hs]
            preempts = eng.alloc.preemptions
        finally:
            srv.shutdown()
        _assert_no_leaks(eng)
        assert got == want and preempts >= 1


# -- LRU reclaim under pressure ------------------------------------------------
class TestReclaim:
    def test_parked_pages_reclaimed_on_demand(self):
        model, cfg = tiny_model()
        rng = np.random.RandomState(9)
        eng = paged_engine(model, max_batch=2, num_pages=8,
                           prefix_cache=True)
        donor = rng.randint(0, cfg.vocab_size, (12,)).astype(np.int32)
        _run_one(eng, donor, n=4)
        assert eng.alloc.cached_pages == 3
        probe = rng.randint(0, cfg.vocab_size, (8,)).astype(np.int32)
        if eng.can_admit(len(probe), _greedy(4)):
            _run_one(eng, probe, n=4)
        other = rng.randint(0, cfg.vocab_size, (12,)).astype(np.int32)
        assert eng.alloc.pages_for(12 + 10) > eng.alloc.free_pages
        _run_one(eng, other, n=10)
        eng.alloc.check()
        assert eng.free_slots() == eng.max_batch

    def test_full_pool_request_still_admits(self):
        """A request whose worst case exactly fills the pool admits with
        the cache on, and a warm partial-block hit that cannot spare its
        copy-on-write page degrades to full blocks; streams stay cold."""
        model, cfg = tiny_model()
        rng = np.random.RandomState(13)
        eng = paged_engine(model, max_batch=2, num_pages=8,
                           prefix_cache=True)
        donor = rng.randint(0, cfg.vocab_size, (20,)).astype(np.int32)
        assert eng.can_admit(20, _greedy(12))
        assert _run_one(eng, donor, n=12) == ref_tokens(donor, n=12)
        probe = donor[:18].copy()
        assert eng.can_admit(18, _greedy(14))
        assert _run_one(eng, probe, n=14) == ref_tokens(probe, n=14)
        assert eng.alloc.cow_copies == 0
        assert eng.alloc.prefix_hits == 1
        eng.alloc.check()


# -- metrics and surfaces ------------------------------------------------------
class TestMetrics:
    def test_counters_pressure_surface_and_series_lifecycle(self):
        model, cfg = tiny_model()
        ids = np.random.RandomState(11).randint(
            0, cfg.vocab_size, (10,)).astype(np.int32)
        monitor.enable()
        try:
            eng = paged_engine(model, prefix_cache=True)
            pool = eng.alloc.monitor_pool
            srv = Server(eng, segment_steps=4)
            try:
                assert list(srv.submit(ids, _greedy(4)).result(timeout=60))
                assert list(srv.submit(ids, _greedy(4)).result(timeout=60))
                p = srv.pressure()
                assert p["prefix_cache"] is True
                assert p["prefix_hits"] == 1 and p["prefix_lookups"] == 2
                assert p["prefix_tokens_saved"] > 0
                assert p["cached_pages"] > 0
            finally:
                srv.shutdown()

            def series(name):
                snap = monitor.snapshot()["metrics"]
                return [s for s in snap.get(name, {}).get("samples", [])
                        if s["labels"].get("pool") == pool]

            hits = series("paddle_tpu_kv_prefix_hits_total")
            assert hits and hits[0]["value"] == 1
            saved = series("paddle_tpu_kv_prefix_tokens_saved_total")
            assert saved and saved[0]["value"] > 0
            assert series("paddle_tpu_kv_shared_pages") != []
            assert {s["labels"]["state"]
                    for s in series("paddle_tpu_kv_pages")} == {
                "free", "used", "cached"}
            eng.close()
            for name in ("paddle_tpu_kv_prefix_hits_total",
                         "paddle_tpu_kv_prefix_tokens_saved_total",
                         "paddle_tpu_kv_shared_pages",
                         "paddle_tpu_kv_pages"):
                assert series(name) == [], name
        finally:
            monitor.disable()

    def test_int8_pressure_reports_bytes_saved(self):
        model, cfg = tiny_model()
        eng = paged_engine(model, prefix_cache=True, kv_dtype="int8")
        srv = Server(eng, segment_steps=4)
        try:
            ids = np.arange(9, dtype=np.int32)
            srv.submit(ids, _greedy(3)).result(timeout=60)
            p = srv.pressure()
            cost = eng.kv_page_cost()
            per_page = (cost["bf16_equiv_bytes_per_page"]
                        - cost["bytes_per_page"])
            assert per_page > 0
            assert p["kv_quant_bytes_saved"] == 3 * per_page   # 3 claims
            assert p["kv_dtype"] == "int8"
        finally:
            srv.shutdown()

    def test_prefix_pause_takes_the_cold_path(self):
        """Brownout rung 4's actuator: a paused engine neither looks up nor
        indexes, and resuming hits what was cached before."""
        model, cfg = tiny_model()
        eng = paged_engine(model, prefix_cache=True)
        donor = np.random.RandomState(14).randint(
            0, cfg.vocab_size, (9,)).astype(np.int32)
        want = _run_one(eng, donor)
        eng.prefix_pause = True
        assert _run_one(eng, donor) == want
        assert eng.alloc.prefix_lookups == 1 and eng.alloc.prefix_hits == 0
        eng.prefix_pause = False
        assert _run_one(eng, donor) == want
        assert eng.alloc.prefix_hits == 1
        _assert_no_leaks(eng)

    def test_warmup_covers_the_warm_path(self):
        """warmup() runs the gather, the page copy and one tail prefill and
        masked scatter per bucket under the reference's keys, captures only
        the segments, and changes nothing a request can see."""
        model, cfg = tiny_model()
        eng = paged_engine(model, prefix_cache=True)
        out = eng.warmup(4)
        assert "prefix_gather_copy" in out
        assert {f"prefix_warm_{w}" for w in eng.prefill_buckets} <= set(out)
        caps = eng.programs.captures
        donor = np.arange(10, dtype=np.int32)
        want = ref_tokens(donor)
        assert _run_one(eng, donor) == want
        assert _run_one(eng, donor) == want
        assert eng.programs.captures == caps
        _assert_no_leaks(eng)
