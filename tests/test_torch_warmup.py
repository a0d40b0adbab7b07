"""``warmup()``, the captured decode programs and ``reset_state()`` of the
port's three engines: the paged engine (bf16 and int8 pools), the dense
``ContinuousBatchingEngine`` and ``CausalLMEngine.generate``.

On the CPU a program runs eagerly and its key's first run counts as its
capture (``inference/_graphs.py``), so these tests hold the engines'
bookkeeping to the reference's contract: after ``warmup()`` no request
adds a program key or a capture, whatever its prompt length, eos id or
token budget (as ``tests/test_prefill_buckets.py`` holds the JAX engine's
compile counters); a warmed engine's greedy streams are bitwise an
un-warmed one's and the JAX engine's on pinned prompts (their margins are
checked in ``test_torch_engine.py``, ``test_torch_dense.py`` and
``test_torch_kv_quant.py``); ``reset_state()`` resets the decode state in
place, so every buffer a captured graph reads keeps its address, keeps the
programs, and serves the same streams afterwards without reusing a request
id. That the graphs replay bitwise on the card is ``chip_smoke.py``'s
check (phase 4).
"""
import numpy as np
import pytest

from paddle_tpu.inference.generation import CausalLMEngine as JaxLMEngine
from paddle_tpu.inference.generation import \
    ContinuousBatchingEngine as JaxDenseEngine
from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxPagedEngine
from paddle_tpu_torch import (CausalLMEngine, ContinuousBatchingEngine,
                              GenerationConfig, PagedContinuousBatchingEngine)

from test_torch_llama import make_pair

PAGED = dict(max_batch=2, num_pages=16, page_size=8, max_pages=8)
DENSE = dict(max_batch=2, max_len=64)
# kind: (port engine, JAX engine, kwargs, prompts' seed); the prompts are
# the ones whose margins test_torch_engine.py, test_torch_dense.py and
# test_torch_kv_quant.py check on the models of make_pair(2, None, seed=0)
KINDS = {
    "paged": (PagedContinuousBatchingEngine, JaxPagedEngine, PAGED, 10),
    "paged_int8": (PagedContinuousBatchingEngine, JaxPagedEngine,
                   dict(PAGED, kv_dtype="int8"), 20),
    "dense": (ContinuousBatchingEngine, JaxDenseEngine, DENSE, 10),
}
LENS = [5, 17, 9, 30, 3, 12]


def _prompts(seed, lens, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _serve(eng, prompts, n=10, **kw):
    return [o.tolist() for o in eng.serve(
        prompts, GenerationConfig(max_new_tokens=n, **kw), segment_steps=4)]


def _state(eng):
    """Every tensor a decode program of ``eng`` reads or writes."""
    out = [t for entry in eng.caches for t in entry]
    out += [eng.lens, eng.last, eng.done_dev, eng.active_dev, eng.eos]
    out += list(eng._seg_out.values())
    if hasattr(eng, "page_table_dev"):
        out.append(eng.page_table_dev)
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_warmed_streams_equal_unwarmed_and_reference(kind):
    port, ref, kw, seed = KINDS[kind]
    jm, tm, _ = make_pair(2, None, seed=0)
    prompts = _prompts(seed, LENS)
    eng = port(tm, **kw)
    out = eng.warmup(segment_steps=4)
    assert set(out) == {f"prefill_{b}" for b in eng.prefill_buckets} | {
        "admit_state", "segment_4", "segment_4_sampled", "total"}
    assert eng.programs.captures == {("segment", 4): 1,
                                     ("segment", 4, "sampled"): 1}
    assert eng.free_slots() == 2 and not eng.collect_finished()
    got = _serve(eng, prompts)
    assert _serve(port(tm, **kw), prompts) == got
    want = ref(jm, **kw).serve(prompts, JaxGenCfg(max_new_tokens=10),
                               segment_steps=4)
    assert got == [np.asarray(w).tolist() for w in want]
    assert eng.programs.captures == {("segment", 4): 1,
                                     ("segment", 4, "sampled"): 1}


@pytest.mark.parametrize("kind", list(KINDS))
def test_no_program_after_warmup(kind):
    """Serves with other prompt lengths (other prefill buckets), an eos id
    and other token budgets, and a request cancelled mid-way, add no
    program key and capture nothing."""
    port, _, kw, seed = KINDS[kind]
    _, tm, _ = make_pair(2, None, seed=0)
    eng = port(tm, **kw)
    eng.warmup(segment_steps=4)
    before = dict(eng.programs.captures)
    free = _serve(eng, _prompts(seed, [3, 40, 21]), n=9)
    _serve(eng, _prompts(seed, [3, 40, 21]), n=9, eos_token_id=free[1][4])
    _serve(eng, _prompts(seed + 1, [33, 2]), n=3)
    rid = eng.add_request(_prompts(seed, [6])[0],
                          GenerationConfig(max_new_tokens=20))
    eng.decode_segment(4)
    assert len(eng.cancel_request(rid)) == 5
    assert eng.programs.captures == before
    assert eng.free_slots() == 2


@pytest.mark.parametrize("kind", list(KINDS))
def test_warmup_needs_an_idle_engine(kind):
    port, _, kw, seed = KINDS[kind]
    _, tm, _ = make_pair(2, None, seed=0)
    eng = port(tm, **kw)
    eng.add_request(_prompts(seed, [5])[0], GenerationConfig(max_new_tokens=4))
    with pytest.raises(RuntimeError, match="idle"):
        eng.warmup(segment_steps=4)
    assert not eng.programs.captures


@pytest.mark.parametrize("kind", list(KINDS))
def test_reset_state_keeps_storage_and_programs(kind):
    """reset_state on a busy warmed engine: every buffer the segment
    program reads keeps its address, the programs stay, every slot (and
    page) comes back, and the same serve gives the same streams with ids
    after the ones handed out before the reset."""
    port, _, kw, seed = KINDS[kind]
    _, tm, _ = make_pair(2, None, seed=0)
    eng = port(tm, **kw)
    eng.warmup(segment_steps=4)
    prompts = _prompts(seed, LENS)
    want = _serve(eng, prompts)
    ptrs = [t.data_ptr() for t in _state(eng)]
    programs = dict(eng.programs.captures)
    old = [eng.add_request(p, GenerationConfig(max_new_tokens=12))
           for p in prompts[:2]]
    eng.decode_segment(4)
    eng.reset_state()
    assert [t.data_ptr() for t in _state(eng)] == ptrs
    assert eng.programs.captures == programs
    assert eng.free_slots() == 2 and not eng.collect_finished()
    assert not eng.active_dev.any() and not eng.lens.any()
    if kind.startswith("paged"):
        assert eng.alloc.free_pages == PAGED["num_pages"]
        assert (eng.page_table_dev == -1).all()
        eng.alloc.check()
    assert eng.decode_segment(4) == 0
    new = eng.add_request(prompts[0], GenerationConfig(max_new_tokens=2))
    assert new > max(old)
    eng.cancel_request(new)
    assert _serve(eng, prompts) == want
    assert eng.programs.captures == programs


def test_generate_warmup_reset_and_programs():
    """``CausalLMEngine``: after ``warmup(batch=3)`` no generate of 3 rows
    adds a program, whatever its prompt length, eos id or budget; the
    tokens are an un-warmed engine's and the JAX engine's; reset_state
    keeps the caches' and the step state's storage and the programs."""
    jm, tm, cfg = make_pair(2, None, seed=0)
    ids = np.random.RandomState(40).randint(0, cfg.vocab_size,
                                            (3, 9)).astype(np.int32)
    eng = CausalLMEngine(tm, max_batch=4, max_len=48)
    out = eng.warmup(batch=3)
    assert set(out) == {"prefill_16", "prefill_32", "prefill_48",
                        "admit_state", "step_3", "step_3_sampled", "total"}
    warmed = {("step", 3): 1, ("step", 3, "sampled"): 1}
    assert eng.programs.captures == warmed
    got = eng.generate(ids, GenerationConfig(max_new_tokens=10))
    assert got.tolist() == CausalLMEngine(tm, max_batch=4, max_len=48
                                          ).generate(
        ids, GenerationConfig(max_new_tokens=10)).tolist()
    want = JaxLMEngine(jm, max_batch=4, max_len=48).generate(
        ids, JaxGenCfg(max_new_tokens=10))
    assert got.tolist() == np.asarray(want).tolist()
    eos_cfg = GenerationConfig(max_new_tokens=10,
                               eos_token_id=int(got[0, 9 + 3]))
    stopped = eng.generate(ids, eos_cfg)
    assert stopped.tolist() == CausalLMEngine(
        tm, max_batch=4, max_len=48).generate(ids, eos_cfg).tolist()
    assert stopped.tolist() != got.tolist()
    longer = np.concatenate([ids, ids[:, :11]], axis=1)
    eng.generate(longer, GenerationConfig(max_new_tokens=3))
    eng.generate(ids[:, :2], GenerationConfig(max_new_tokens=1))
    assert eng.programs.captures == warmed
    eng.generate(ids[:2], GenerationConfig(max_new_tokens=4))
    assert eng.programs.captures == {**warmed, ("step", 2): 1}
    tensors = [t for kv in eng._caches for t in kv] + [
        eng._tok, eng._done, eng._eos, eng._pos, eng._hist]
    ptrs = [t.data_ptr() for t in tensors]
    eng.reset_state()
    assert [t.data_ptr() for t in tensors] == ptrs
    assert not any(t.any() for kv in eng._caches for t in kv)
    assert int(eng._pos) == 0 and int(eng._eos) == -1
    assert eng.generate(ids, GenerationConfig(max_new_tokens=10)
                        ).tolist() == got.tolist()
    assert eng.programs.captures == {**warmed, ("step", 2): 1}
    with pytest.raises(ValueError, match="batch"):
        eng.warmup(batch=5)
