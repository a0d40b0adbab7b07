"""paddle_tpu_torch's paged continuous-batching engine against paddle_tpu's:
identical greedy streams on pinned prompts, with more requests than slots
so that admission recycles slots and pages, plus the page allocator's
bookkeeping.

Both engines run the same float32 weights; their logits differ by ~1e-6
(see test_torch_llama.py), so a greedy stream can only diverge where two
logits tie to that precision. The prompts are pinned, and the test checks
that every greedy choice along the streams wins by a top-2 margin of at
least ``MARGIN`` (measured with the port's uncached forward), so identical
streams are a meaningful bar: untrained tiny models do have near-ties on
some prompts, and those would make the comparison flaky rather than wrong.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch import GenerationConfig, PagedContinuousBatchingEngine
from paddle_tpu_torch.inference.generation import prefill_buckets_for
from paddle_tpu_torch.inference.paged_cache import PageAllocator, write_tokens

from test_torch_llama import make_pair
from torch_jax_state import jax_reference_state  # noqa: F401

MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models and ops are
    tiny, and a thread pool on a machine whose cores other test workers
    hold waits for its threads at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(seed, lens, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _assert_margins(tm, prompts, streams):
    """Every greedy choice along ``streams`` beats the runner-up logit by
    at least MARGIN under the port's uncached forward."""
    for p, s in zip(prompts, streams):
        seq = np.concatenate([p, s[:-1]]).astype(np.int64)
        with torch.no_grad():
            logits = tm(torch.from_numpy(seq)[None])[0, len(p) - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert torch.equal(logits.argmax(-1), torch.from_numpy(
            s.astype(np.int64))), "stream is not the uncached greedy one"
        assert (top2[:, 0] - top2[:, 1]).min() >= MARGIN, \
            "pinned prompt has a near-tie: pick another seed"


def _engines(jm, tm, **kw):
    je = JaxEngine(jm, **kw)
    te = PagedContinuousBatchingEngine(tm, debug_pages=True, **kw)
    return je, te


@pytest.mark.parametrize("kv_heads,seed", [(None, 0), (2, 1)])
def test_serve_streams_match_reference(kv_heads, seed):
    """Six requests through two slots (MHA and GQA): admission recycles
    slots and pages; prompts span three prefill buckets."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=seed)
    prompts = _prompts(seed + 10, [5, 17, 9, 30, 3, 12])
    kw = dict(max_batch=2, num_pages=16, page_size=8, max_pages=8)
    je, te = _engines(jm, tm, **kw)
    want = je.serve(prompts, JaxGenCfg(max_new_tokens=10), segment_steps=4)
    got = te.serve(prompts, GenerationConfig(max_new_tokens=10),
                   segment_steps=4)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    _assert_margins(tm, prompts, want)
    te.alloc.check()
    assert te.alloc.free_pages == kw["num_pages"]
    assert te.free_slots() == kw["max_batch"]
    assert te.serve_stats["decode_tokens"] == sum(len(w) - 1 for w in want)
    assert len(te.serve_stats["ttft_s"]) == len(prompts)


def test_eos_and_exact_prefill_match_reference():
    """An eos id taken from the middle of a stream ends that request
    early, in both engines; exact-length prefill (no buckets) gives the
    same streams as well."""
    jm, tm, cfg = make_pair(2, None, seed=4)
    prompts = _prompts(14, [6, 11, 4, 20])
    kw = dict(max_batch=3, num_pages=12, page_size=4, max_pages=10,
              prefill_buckets=None)
    je, te = _engines(jm, tm, **kw)
    free = je.serve(prompts, JaxGenCfg(max_new_tokens=12))
    eos = int(free[1][5])
    want = je.serve(prompts, JaxGenCfg(max_new_tokens=12, eos_token_id=eos))
    got = te.serve(prompts, GenerationConfig(max_new_tokens=12,
                                             eos_token_id=eos))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert len(want[1]) <= 6 and want[1][-1] == eos
    _assert_margins(tm, prompts, free)


def test_allocator_check_holds_at_every_gap():
    """Driven by hand: admit, decode, cancel, admit again; the allocator's
    invariants hold after every gap and every page comes back."""
    _, tm, _ = make_pair(2, 2, seed=5)
    eng = PagedContinuousBatchingEngine(tm, max_batch=2, num_pages=10,
                                        page_size=4, max_pages=6)
    cfg = GenerationConfig(max_new_tokens=8)
    p = _prompts(6, [7, 13, 5])
    a = eng.add_request(p[0], cfg)
    eng.alloc.check()
    assert eng.alloc.covered_tokens(0) == 16      # 7 + 8 -> 4 pages
    b = eng.add_request(p[1], cfg)
    eng.alloc.check()
    assert not eng.can_admit(5, cfg)              # no free slot
    eng.decode_segment(3)
    eng.alloc.check()
    part = eng.cancel_request(b)
    assert len(part) == 4                         # first token + 3 steps
    eng.alloc.check()
    assert eng.cancel_request(b) is None
    c = eng.add_request(p[2], cfg)
    while eng.decode_segment(3):
        eng.alloc.check()
    done = eng.collect_finished()
    assert sorted(done) == [a, c] and b not in done
    assert all(len(v) == 8 for v in done.values())
    eng.alloc.check()
    assert eng.alloc.free_pages == 10


def test_admission_limits_and_unported_modes():
    _, tm, _ = make_pair(2, seed=6)
    eng = PagedContinuousBatchingEngine(tm, max_batch=2, num_pages=4,
                                        page_size=4, max_pages=6)
    cfg = GenerationConfig(max_new_tokens=8)
    assert eng.can_admit(8, cfg)                  # 16 tokens = 4 pages
    assert not eng.can_admit(9, cfg)              # 5 pages > pool
    with pytest.raises(ValueError):
        eng.add_request(np.zeros(20, np.int32), cfg)   # past max_len 24
    with pytest.raises(RuntimeError):
        eng.add_request(np.zeros(9, np.int32), cfg)
    assert eng.free_slots() == 2 and eng.alloc.free_pages == 4
    # the reference's request options are the port's (sampling,
    # speculative decoding, the LoRA adapter); the admission mode, the
    # prefix cache and kv_dtype take the reference's values only
    assert GenerationConfig(max_new_tokens=2, speculative=True).speculative
    assert GenerationConfig(max_new_tokens=2, adapter="a").adapter == "a"
    with pytest.raises(ValueError, match="adapter"):
        GenerationConfig(max_new_tokens=2, adapter="")
    for kw in (dict(admission_mode="optimistic"), dict(prefix_cache=True)):
        e = PagedContinuousBatchingEngine(tm, max_batch=1, num_pages=4,
                                          page_size=4, max_pages=2, **kw)
        assert e.admission_mode == kw.get("admission_mode", "reserved")
        assert e.prefix_cache == e.alloc.prefix_cache == kw.get(
            "prefix_cache", False)
    with pytest.raises(ValueError, match="admission_mode"):
        PagedContinuousBatchingEngine(tm, max_batch=1, num_pages=4,
                                      page_size=4, max_pages=2,
                                      admission_mode="eager")
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedContinuousBatchingEngine(tm, max_batch=1, num_pages=4,
                                      page_size=4, max_pages=2,
                                      kv_dtype="fp8")


def test_write_tokens_drops_unmapped_writes():
    """A write whose position has no mapped page lands in the sink page and
    touches no real page (the reference drops it)."""
    kp = torch.zeros(5, 2, 1, 4)              # 4 pages + sink
    vp = torch.zeros(5, 2, 1, 4)
    table = torch.tensor([[3, -1], [1, 0]], dtype=torch.int32)
    slots = torch.tensor([0, 0, 1], dtype=torch.int32)
    pos = torch.tensor([1, 2, 3], dtype=torch.int32)   # (0, 2) is unmapped
    new = torch.arange(1, 4, dtype=torch.float32)[:, None, None].expand(
        3, 1, 4)
    write_tokens(kp, vp, table, slots, pos, new, new * 10)
    assert kp[3, 1].eq(1).all() and kp[0, 1].eq(3).all()
    assert vp[0, 1].eq(30).all()
    assert kp[4, 0].eq(2).all()               # the dropped write, in the sink
    real = kp[:4].clone()
    real[3, 1] = 0
    real[0, 1] = 0
    assert real.eq(0).all()


def test_page_allocator_bookkeeping():
    al = PageAllocator(num_pages=6, page_size=4, max_batch=3, max_pages=3)
    al.ensure(1, 5)
    al.ensure(0, 12)
    assert al.page_table[1].tolist() == [0, 1, -1]
    assert al.page_table[0].tolist() == [2, 3, 4]
    assert al.pages_for(9) == 3 and al.covered_tokens(0) == 12
    assert al.can_fit(1, 8) and not al.can_fit(2, 8)
    with pytest.raises(RuntimeError):
        al.ensure(2, 8)                           # 2 pages, 1 free
    assert al.free_pages == 1                     # nothing was claimed
    with pytest.raises(ValueError):
        al.ensure(1, 13)                          # past max_pages
    al.free_slot(0)
    al.check()
    assert al.used_pages == 2
    al.ensure(2, 8)
    assert al.page_table[2].tolist() == [2, 3, -1]   # lowest ids first
    al.page_table[2, 2] = 5                          # corrupt the table
    with pytest.raises(RuntimeError):
        al.check()


def test_generation_config_and_buckets():
    with pytest.raises(ValueError):
        GenerationConfig(max_new_tokens=0)
    for bad in (-1, 2 ** 31, True, 3.0):
        with pytest.raises(ValueError):
            GenerationConfig(eos_token_id=bad)
    assert prefill_buckets_for("auto", 100) == (16, 32, 64, 100)
    assert prefill_buckets_for([48, 8, 8], 64) == (8, 48, 64)
    assert prefill_buckets_for(None, 64) is None
