"""paddle_tpu_torch.serving: the online serving front over the port's
engines, on the CPU.

The scenarios of ``tests/test_serving.py`` against the port (its soak,
which needs ``tools/serve_bench.py``, waits for the port's bench): a
``Server`` over the paged engine takes concurrent requests with mixed
prompt lengths and per-request configs, completes them interleaved,
streams tokens before completion, reclaims capacity on cancellation,
applies queue-full backpressure and exports TTFT / queue depth through the
monitor; the engine's capacity probe, cancellation, per-request configs,
deadlines, drain and the HTTP front.

Beyond them: the port's ``Server`` streams the JAX ``Server``'s tokens on
the same weights and pinned prompts (the prompts whose greedy margins
``test_torch_engine.py`` checks), the dense engine serves behind it too,
and every reference feature the port's engines lack raises, at
construction or at the call, naming its ROADMAP item.

Every test that starts a ``Server`` waits with a timeout and shuts it
down in ``finally``, so no scheduler thread outlives its test.
"""
import http.client
import json
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch

from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxPagedEngine
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu_torch import (CausalLMEngine, ContinuousBatchingEngine,
                              GenerationConfig, LlamaForCausalLM,
                              PagedContinuousBatchingEngine, llama_config,
                              monitor)
from paddle_tpu_torch.serving import (DeadlineExpired, QueueFull,
                                      RequestCancelled, RequestFailed,
                                      RequestHandle, RequestQueue,
                                      RequestRejected, Server, serve_http)

from test_torch_llama import make_pair

WAIT = 120          # seconds any one wait may take before the test fails


def tiny_model(layers=1, seed=0):
    torch.manual_seed(seed)
    cfg = llama_config("tiny", num_hidden_layers=layers)
    return LlamaForCausalLM(cfg, device="cpu"), cfg


def paged_engine(model, max_batch=3, num_pages=24, page_size=8,
                 max_pages=8, **kw):
    return PagedContinuousBatchingEngine(
        model, max_batch=max_batch, num_pages=num_pages,
        page_size=page_size, max_pages=max_pages, **kw)


@pytest.fixture()
def mon():
    monitor.enable()
    monitor.reset()
    yield monitor
    monitor.reset()
    monitor.disable()


def _prompts(rng, vocab, lens):
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _events(name):
    return {s["labels"]["event"]: s["value"]
            for s in monitor.snapshot()["metrics"][name]["samples"]}


def _server(model_layers=1, **kw):
    model, cfg = tiny_model(layers=model_layers)
    defaults = dict(max_batch=3, num_pages=24, page_size=8, max_pages=8)
    eng_kw = {k: kw.pop(k) for k in list(kw)
              if k in ("max_batch", "num_pages", "page_size", "max_pages",
                       "prefill_chunk")}
    eng = paged_engine(model, **{**defaults, **eng_kw})
    return Server(eng, **kw), eng, cfg


class TestGenerationConfigValidation:
    """A malformed online request must be rejected at admission, not
    crash a shared decode segment mid-flight."""

    @pytest.mark.parametrize("kw", [
        {"max_new_tokens": 0}, {"max_new_tokens": -3},
        {"max_new_tokens": 2.0}, {"max_new_tokens": True},
        {"temperature": 0}, {"temperature": -0.5},
        {"temperature": float("nan")},
        {"top_k": -1}, {"top_k": 2.5},
        {"top_p": 0}, {"top_p": 0.0}, {"top_p": 1.5}, {"top_p": -0.1},
        {"eos_token_id": -2}, {"eos_token_id": 1.5},
        {"max_new_tokens": 2 ** 31}, {"top_k": 2 ** 40},
        {"eos_token_id": 2 ** 31},
    ])
    def test_bad_values_raise(self, kw):
        with pytest.raises(ValueError, match=next(iter(kw))):
            GenerationConfig(**kw)

    def test_good_values_normalize(self):
        cfg = GenerationConfig(max_new_tokens=np.int64(8),
                               temperature=1, top_k=np.int32(5),
                               top_p=1, eos_token_id=np.int64(3))
        assert (cfg.max_new_tokens, cfg.top_k, cfg.eos_token_id) == (8, 5, 3)
        assert isinstance(cfg.temperature, float)
        assert GenerationConfig().eos_token_id is None


class TestRequestQueue:
    """Ordering, bounded size and reaping, no engine needed."""

    def _h(self, rid, priority=0, deadline=None):
        return RequestHandle(rid, [1], 1,
                             GenerationConfig(max_new_tokens=2),
                             priority=priority, deadline=deadline)

    def test_priority_then_fifo(self):
        q = RequestQueue(8)
        for h in (self._h(0, 5), self._h(1, 0), self._h(2, 0),
                  self._h(3, 2)):
            q.put(h)
        order = []
        while q.depth:
            order.append(q.pop_if(lambda h: True).id)
        assert order == [1, 2, 3, 0]

    def test_bounded_put_raises(self):
        q = RequestQueue(2)
        q.put(self._h(0))
        q.put(self._h(1))
        with pytest.raises(QueueFull):
            q.put(self._h(2))

    def test_reap_removes_deep_entries(self):
        q = RequestQueue(8)
        live = self._h(0, 0)
        expired = self._h(1, 3, deadline=time.monotonic() - 1)
        cancelled = self._h(2, 5)
        cancelled._cancel_requested = True
        for h in (live, expired, cancelled):
            q.put(h)
        dead = q.reap(time.monotonic())
        assert {h.id for h in dead} == {1, 2}
        assert q.depth == 1
        assert q.pop_if(lambda h: True).id == 0

    def test_pop_if_defers_on_false(self):
        q = RequestQueue(4)
        q.put(self._h(0))
        assert q.pop_if(lambda h: False) is None
        assert q.depth == 1

    def test_aging_lifts_a_waiting_request(self):
        q = RequestQueue(4, age_after_s=0.01)
        low = self._h(0, priority=5)
        low.submit_ts -= 1.0                      # waited a second
        q.put(low)
        q.put(self._h(1, priority=0))
        q.reap(time.monotonic())
        assert q.pop_if(lambda h: True).id == 0


class TestCapacityProbe:
    """Public free_slots()/can_admit(): the scheduler path is probe +
    defer; add_request raising is the programmer-error path."""

    def test_dense_probe_and_loud_add(self):
        model, cfg = tiny_model()
        eng = ContinuousBatchingEngine(model, max_batch=2, max_len=32)
        gc = GenerationConfig(max_new_tokens=4, eos_token_id=None)
        assert eng.free_slots() == 2
        assert eng.can_admit(5, gc)
        assert not eng.can_admit(30, gc)
        with pytest.raises(ValueError, match="max_len"):
            eng.add_request(np.arange(30, dtype=np.int32), gc)
        rng = np.random.RandomState(0)
        for p in _prompts(rng, cfg.vocab_size, [4, 4]):
            eng.add_request(p, gc)
        assert eng.free_slots() == 0
        assert not eng.can_admit(4, gc)
        with pytest.raises(RuntimeError, match="free slot"):
            eng.add_request(np.arange(4, dtype=np.int32), gc)
        assert eng.load() == {"free_slots": 0, "active_slots": 2,
                              "max_batch": 2, "max_len": 32,
                              "tp_degree": 1}

    def test_paged_probe_sees_pool_pressure(self):
        model, cfg = tiny_model()
        # 6 pages * 8 = 48 tokens; each request reserves
        # ceil((18+6)/8) = 3 pages
        eng = paged_engine(model, max_batch=3, num_pages=6, page_size=8,
                           max_pages=6)
        gc = GenerationConfig(max_new_tokens=6, eos_token_id=None)
        assert eng.can_admit(18, gc)
        rng = np.random.RandomState(1)
        for _ in range(2):
            eng.add_request(rng.randint(0, cfg.vocab_size, (18,))
                            .astype(np.int32), gc)
        assert eng.free_slots() == 1
        assert not eng.can_admit(18, gc)
        with pytest.raises(RuntimeError, match="exhausted"):
            eng.add_request(rng.randint(0, cfg.vocab_size, (18,))
                            .astype(np.int32), gc)
        load = eng.load()
        assert (load["free_pages"], load["total_pages"],
                load["occupancy"], load["kv_dtype"]) == (0, 6, 1.0, "bf16")


class TestEngineCancellation:
    def test_cancel_mid_decode_releases_slot_and_pages(self, mon):
        model, cfg = tiny_model()
        eng = paged_engine(model, max_batch=2, num_pages=12)
        gc = GenerationConfig(max_new_tokens=30, eos_token_id=None)
        rng = np.random.RandomState(2)
        rid = eng.add_request(rng.randint(0, cfg.vocab_size, (6,))
                              .astype(np.int32), gc)
        eng.decode_segment(2)
        assert eng.partial_tokens(rid) is not None
        assert eng.partial_tokens(rid, 2) == eng.partial_tokens(rid)[2:]
        partial = eng.cancel_request(rid)
        assert len(partial) == 3
        assert eng.free_slots() == 2
        assert eng.alloc.free_pages == eng.num_pages
        assert rid not in eng.collect_finished()
        assert eng.partial_tokens(rid) is None
        assert eng.cancel_request(rid) is None
        assert _events("paddle_tpu_requests_total") == {"admitted": 1,
                                                         "cancelled": 1}

    def test_failed_admission_leaks_no_capacity(self):
        """add_request raising mid-admission (after the slot pop and the
        page reservation) restores both."""
        model, cfg = tiny_model()
        eng = paged_engine(model, max_batch=2, num_pages=12)
        gc = GenerationConfig(max_new_tokens=4, eos_token_id=None)
        orig = eng._install_state
        eng._install_state = lambda *a: (_ for _ in ()).throw(
            RuntimeError("injected admit fault"))
        with pytest.raises(RuntimeError, match="injected"):
            eng.add_request(np.arange(6, dtype=np.int32), gc)
        eng._install_state = orig
        assert eng.free_slots() == 2
        assert eng.alloc.free_pages == eng.num_pages
        rid = eng.add_request(np.arange(6, dtype=np.int32), gc)
        while eng.decode_segment(4):
            pass
        assert len(eng.collect_finished()[rid]) == 4

    def test_capacity_freed_for_next_request(self):
        model, cfg = tiny_model()
        eng = paged_engine(model, max_batch=2, num_pages=3, page_size=8,
                           max_pages=4)
        gc = GenerationConfig(max_new_tokens=10, eos_token_id=None)
        rng = np.random.RandomState(3)
        p1, p2 = _prompts(rng, cfg.vocab_size, [12, 12])
        rid = eng.add_request(p1, gc)
        assert not eng.can_admit(12, gc)
        eng.cancel_request(rid)
        assert eng.can_admit(12, gc)
        rid2 = eng.add_request(p2, gc)
        while eng.decode_segment(4):
            pass
        assert len(eng.collect_finished()[rid2]) == 10


class TestPerRequestConfigs:
    def test_mixed_configs_one_program_per_key(self):
        """A mixed greedy/sampled/eos batch: each request decodes under
        its own config, the greedy one equals the dense ``generate``, and
        the segment runs through at most its two programs (greedy and
        sampled), each built once: the sampling parameters are data."""
        model, cfg = tiny_model(layers=2)
        rng = np.random.RandomState(4)
        p_greedy, p_samp, p_eos = _prompts(rng, cfg.vocab_size, [5, 9, 7])
        dense = CausalLMEngine(model, max_batch=1, max_len=64)
        gc_greedy = GenerationConfig(max_new_tokens=10, eos_token_id=None)
        want = dense.generate(p_greedy[None], gc_greedy)[0, 5:]
        probe = dense.generate(p_eos[None], GenerationConfig(
            max_new_tokens=10, eos_token_id=None))[0, 7:]
        eos = int(probe[3])
        eng = ContinuousBatchingEngine(model, max_batch=3, max_len=64)
        r1 = eng.add_request(p_greedy, gc_greedy)
        r2 = eng.add_request(p_samp, GenerationConfig(
            max_new_tokens=6, do_sample=True, temperature=0.7, top_k=9,
            top_p=0.9, seed=11, eos_token_id=None))
        r3 = eng.add_request(p_eos, GenerationConfig(
            max_new_tokens=10, eos_token_id=eos))
        while eng.decode_segment(3):
            pass
        outs = eng.collect_finished()
        np.testing.assert_array_equal(outs[r1], want)
        assert len(outs[r2]) == 6
        o3 = list(outs[r3])
        assert o3[:4] == [int(t) for t in probe[:3]] + [eos]
        assert set(eng.programs.captures) <= {("segment", 3),
                                              ("segment", 3, "sampled")}
        assert set(eng.programs.captures.values()) == {1}

    def test_per_request_seed_threads_into_decode(self):
        model, cfg = tiny_model()
        p = np.random.RandomState(5).randint(
            0, cfg.vocab_size, (6,)).astype(np.int32)

        def run(seed):
            eng = ContinuousBatchingEngine(model, max_batch=1, max_len=64)
            rid = eng.add_request(p, GenerationConfig(
                max_new_tokens=16, do_sample=True, temperature=3.0,
                seed=seed, eos_token_id=None))
            while eng.decode_segment(4):
                pass
            return list(eng.collect_finished()[rid])

        assert run(1) == run(1)
        assert run(1) != run(2)


class TestServerOnline:
    def test_acceptance_demo_end_to_end(self, mon):
        """>= 8 concurrent requests, mixed prompt lengths and
        per-request configs, interleaved completion, streaming before
        completion, TTFT/queue-depth in the export."""
        srv, eng, cfg = _server(max_queue=16, segment_steps=3)
        try:
            rng = np.random.RandomState(0)
            spec = [(5, 20), (9, 4), (3, 8), (12, 6), (4, 12), (7, 4),
                    (2, 16), (6, 5)]
            handles = []
            for i, (plen, mx) in enumerate(spec):
                p = rng.randint(0, cfg.vocab_size, (plen,)).astype(np.int32)
                gc = GenerationConfig(max_new_tokens=mx,
                                      do_sample=(i % 3 == 0),
                                      temperature=0.9, seed=i,
                                      eos_token_id=None)
                handles.append(srv.submit(p, gc))
            seen = []

            def consume():
                for tok in handles[0].stream(timeout=WAIT):
                    seen.append((tok, handles[0].status))
            t = threading.Thread(target=consume)
            t.start()
            outs = [h.result(timeout=WAIT) for h in handles]
            t.join(WAIT)
            assert not t.is_alive()
            assert [len(o) for o in outs] == [mx for _, mx in spec]
            assert [i for i in range(1, 8) if handles[i].finish_ts
                    < handles[0].finish_ts], "no interleaving observed"
            assert any(s == "running" for _, s in seen)
            assert [tok for tok, _ in seen] == [int(x) for x in outs[0]]
            snap = monitor.snapshot()["metrics"]
            ttft = snap["paddle_tpu_serving_ttft_seconds"]["samples"][0]
            assert ttft["count"] >= 8
            assert ttft["labels"]["server"] == srv.monitor_server
            assert "paddle_tpu_serving_queue_depth" in snap
            prom = monitor.render_prometheus()
            assert "paddle_tpu_serving_ttft_seconds_bucket" in prom
            assert "paddle_tpu_serving_queue_depth" in prom
            # the engine's own series under the reference's names
            assert snap["paddle_tpu_generated_tokens_total"]["samples"][0][
                "value"] == sum(mx for _, mx in spec)
            assert _events("paddle_tpu_requests_total")["admitted"] == 8
            assert "paddle_tpu_decode_tokens_per_sec" in snap
        finally:
            srv.shutdown(drain=False)

    def test_cancel_reclaims_capacity_for_queued(self, mon):
        srv, eng, cfg = _server(max_batch=2, num_pages=10, max_queue=8,
                                segment_steps=2)
        try:
            rng = np.random.RandomState(1)
            long_cfg = GenerationConfig(max_new_tokens=56,
                                        eos_token_id=None)
            h1 = srv.submit(rng.randint(0, cfg.vocab_size, (6,))
                            .astype(np.int32), long_cfg)
            h2 = srv.submit(rng.randint(0, cfg.vocab_size, (6,))
                            .astype(np.int32), long_cfg)
            h3 = srv.submit(rng.randint(0, cfg.vocab_size, (4,))
                            .astype(np.int32),
                            GenerationConfig(max_new_tokens=5,
                                             eos_token_id=None))
            next(iter(h1.stream(timeout=WAIT)))
            assert h3.status == "queued"
            h1.cancel()
            assert len(h3.result(timeout=WAIT)) == 5
            with pytest.raises(RequestCancelled):
                h1.result(timeout=WAIT)
            assert len(h1.tokens_so_far()) >= 1
            assert _events("paddle_tpu_serving_requests_total").get(
                "cancelled") == 1
            h2.cancel()
        finally:
            srv.shutdown(drain=False)

    def test_queue_full_rejection(self, mon):
        srv, eng, cfg = _server(max_batch=1, num_pages=24, max_queue=2,
                                segment_steps=2)
        try:
            rng = np.random.RandomState(2)
            gc = GenerationConfig(max_new_tokens=40, eos_token_id=None)
            hs = [srv.submit(rng.randint(0, cfg.vocab_size, (4,))
                             .astype(np.int32), gc)]
            next(iter(hs[0].stream(timeout=WAIT)))
            for _ in range(2):
                hs.append(srv.submit(rng.randint(0, cfg.vocab_size, (4,))
                                     .astype(np.int32), gc))
            with pytest.raises(QueueFull) as ei:
                srv.submit(rng.randint(0, cfg.vocab_size, (4,))
                           .astype(np.int32), gc)
            assert ei.value.reason == "queue_full"
            assert _events("paddle_tpu_serving_requests_total").get(
                "rejected_queue_full") == 1
            for h in hs:
                h.cancel()
        finally:
            srv.shutdown(drain=False)

    def test_deadline_expired_never_admits(self, mon):
        srv, eng, cfg = _server(max_batch=1, num_pages=24, segment_steps=2)
        try:
            rng = np.random.RandomState(3)
            # h1 holds the one slot for 56 tokens, far longer than h2's
            # deadline even on an idle CPU, where a tiny step takes about
            # half a millisecond
            h1 = srv.submit(rng.randint(0, cfg.vocab_size, (4,))
                            .astype(np.int32),
                            GenerationConfig(max_new_tokens=56,
                                             eos_token_id=None))
            next(iter(h1.stream(timeout=WAIT)))
            h2 = srv.submit(rng.randint(0, cfg.vocab_size, (4,))
                            .astype(np.int32),
                            GenerationConfig(max_new_tokens=4,
                                             eos_token_id=None),
                            timeout_s=0.005)
            with pytest.raises(DeadlineExpired):
                h2.result(timeout=WAIT)
            assert h2.engine_rid is None
            assert h2.tokens_so_far() == []
            assert _events("paddle_tpu_serving_requests_total").get(
                "expired") == 1
            h1.cancel()
        finally:
            srv.shutdown(drain=False)

    def test_drain_finishes_inflight_rejects_new(self):
        srv, eng, cfg = _server(segment_steps=3)
        try:
            rng = np.random.RandomState(4)
            hs = [srv.submit(rng.randint(0, cfg.vocab_size, (n,))
                             .astype(np.int32),
                             GenerationConfig(max_new_tokens=6,
                                              eos_token_id=None))
                  for n in (5, 8, 3, 6)]
            assert srv.drain(timeout=WAIT)
            with pytest.raises(RequestRejected) as ei:
                srv.submit(np.arange(3, dtype=np.int32),
                           GenerationConfig(max_new_tokens=2))
            assert ei.value.reason == "draining"
            for h in hs:
                assert h.status == "finished"
                assert len(h.result(timeout=1)) == 6
        finally:
            srv.shutdown(drain=False)

    def test_scheduler_death_fails_handles_not_hangs(self):
        srv, eng, cfg = _server(segment_steps=2, max_restarts=0)
        try:
            def boom(*a, **kw):
                raise RuntimeError("injected engine fault")
            eng.decode_segment = boom
            h = srv.submit(np.arange(4, dtype=np.int32),
                           GenerationConfig(max_new_tokens=8,
                                            eos_token_id=None))
            with pytest.raises(RequestFailed, match="scheduler died"):
                h.result(timeout=WAIT)
            assert srv.status == "failed"
            with pytest.raises(RequestRejected, match="scheduler died"):
                srv.submit(np.arange(3, dtype=np.int32),
                           GenerationConfig(max_new_tokens=2))
        finally:
            srv.shutdown(drain=False)

    def test_never_fitting_request_fails_fast(self):
        # 2 pages = 16 tokens in all; a 20-token prompt fits max_len (32)
        # but can never reserve its pages: FAILED, not wedged forever
        srv, eng, cfg = _server(max_batch=2, num_pages=2, page_size=8,
                                max_pages=4)
        try:
            h = srv.submit(np.arange(20, dtype=np.int32) % cfg.vocab_size,
                           GenerationConfig(max_new_tokens=4,
                                            eos_token_id=None))
            with pytest.raises(RequestFailed, match="never"):
                h.result(timeout=WAIT)
            with pytest.raises(ValueError, match="max_len"):
                srv.submit(np.arange(40, dtype=np.int32),
                           GenerationConfig(max_new_tokens=4))
        finally:
            srv.shutdown(drain=False)

    def test_chunked_admission_interleaves_decode(self):
        """With ``prefill_chunk`` a long prompt admits one chunk per gap:
        its stream equals the one-shot engine's, and a short request
        admitted first keeps decoding between the chunks."""
        model, cfg = tiny_model()
        rng = np.random.RandomState(6)
        long_p, short_p = _prompts(rng, cfg.vocab_size, [30, 4])
        ref = paged_engine(model).serve(
            [long_p, short_p], GenerationConfig(max_new_tokens=6))
        eng = paged_engine(model, prefill_chunk=8)
        srv = Server(eng, segment_steps=2)
        try:
            hs = srv.submit(short_p, GenerationConfig(max_new_tokens=6))
            hl = srv.submit(long_p, GenerationConfig(max_new_tokens=6))
            np.testing.assert_array_equal(hl.result(timeout=WAIT), ref[0])
            np.testing.assert_array_equal(hs.result(timeout=WAIT), ref[1])
            assert eng.prefill_chunks == 4
            assert hs.first_token_ts < hl.first_token_ts
        finally:
            srv.shutdown(drain=False)


# -- the port's Server against the JAX Server ---------------------------------

PAIR_PAGED = dict(max_batch=2, num_pages=16, page_size=8, max_pages=8)
# the pinned prompts of test_torch_engine.py (seed 10 on make_pair(2,
# None, seed=0)), whose greedy margins it checks over 10 new tokens; a
# budget of at most 10 keeps every stream a prefix of a checked one
PAIR_LENS = [5, 17, 9, 30, 3, 12]
PAIR_NEW = [10, 6, 8, 10, 4, 7]


@pytest.fixture(scope="module")
def pair():
    jm, tm, _ = make_pair(2, None, seed=0)
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32)
               for n in PAIR_LENS]
    return jm, tm, prompts


def _serve_all(srv, prompts, cfgs):
    try:
        hs = [srv.submit(p, c) for p, c in zip(prompts, cfgs)]
        return [[int(t) for t in h.result(timeout=300)] for h in hs]
    finally:
        srv.shutdown(drain=False)


def test_server_streams_equal_the_jax_server(pair):
    """Six requests with their own greedy budgets through two slots, on
    the same weights and prompts: the port's Server streams the JAX
    Server's tokens."""
    jm, tm, prompts = pair
    want = _serve_all(
        JaxServer(JaxPagedEngine(jm, **PAIR_PAGED), segment_steps=4),
        prompts, [JaxGenCfg(max_new_tokens=n) for n in PAIR_NEW])
    got = _serve_all(
        Server(PagedContinuousBatchingEngine(tm, **PAIR_PAGED),
               segment_steps=4),
        prompts, [GenerationConfig(max_new_tokens=n) for n in PAIR_NEW])
    assert got == want
    assert [len(g) for g in got] == PAIR_NEW


@pytest.mark.parametrize("engine", ["dense", "paged_int8"])
def test_other_engines_serve_behind_the_server(pair, engine):
    """The dense engine, and the paged engine switched to int8 pools by
    the Server's ``kv_dtype`` mirror, serve the same requests; the dense
    streams equal the paged bf16 engine's (``test_torch_dense.py`` holds
    the two engines equal on these prompts), the int8 ones are whole."""
    _, tm, prompts = pair
    want = [o.tolist() for o in PagedContinuousBatchingEngine(
        tm, **PAIR_PAGED).serve(prompts, [GenerationConfig(max_new_tokens=n)
                                          for n in PAIR_NEW],
                                segment_steps=4)]
    if engine == "dense":
        srv = Server(ContinuousBatchingEngine(tm, max_batch=2, max_len=64),
                     segment_steps=4, warmup=True)
        assert srv.pressure() is None
    else:
        eng = PagedContinuousBatchingEngine(tm, **PAIR_PAGED)
        srv = Server(eng, segment_steps=4, kv_dtype="int8")
        assert eng.kv_dtype == "int8" and srv.pressure()["kv_dtype"] == "int8"
    got = _serve_all(srv, prompts,
                     [GenerationConfig(max_new_tokens=n) for n in PAIR_NEW])
    assert [len(g) for g in got] == PAIR_NEW
    if engine == "dense":
        assert got == want


def test_warmup_then_no_capture(pair):
    """``Server(warmup=True)`` captures the segment programs of its own
    length in the scheduler thread before serving; the serve afterwards
    adds no program and no capture, and ``load()`` reads the idle engine
    once it drained."""
    _, tm, prompts = pair
    eng = PagedContinuousBatchingEngine(tm, **PAIR_PAGED, prefill_chunk=16)
    srv = Server(eng, segment_steps=4, warmup=True)
    try:
        assert srv.wait_ready(timeout=WAIT) and srv.status == "ok"
        warm = dict(eng.programs.captures)
        assert warm == {("segment", 4): 1, ("segment", 4, "sampled"): 1}
        hs = [srv.submit(p, GenerationConfig(max_new_tokens=5))
              for p in prompts]
        for h in hs:
            assert len(h.result(timeout=WAIT)) == 5
        assert srv.drain(timeout=WAIT)
        assert eng.programs.captures == warm
        load = srv.load()
        assert load["free_slots"] == 2 and load["active_requests"] == 0
        assert load["free_pages"] == load["total_pages"] == 16
    finally:
        srv.shutdown(drain=False)


# -- what the port's engines lack ----------------------------------------------


@pytest.mark.parametrize("kw,item", [
    (dict(draft_k=4), "A7"), (dict(spec_mode="device"), "A7"),
    (dict(speculative=True, draft_k=2), "A7"),
    (dict(max_preemptions=3), "A4c"),
    (dict(admission_mode="optimistic"), "A4c")])
def test_missing_features_fail_at_construction(kw, item):
    """The speculative-decoding knobs (A7) and the memory-pressure knobs of
    A4c are ported: each takes effect on the engine (or the server) at
    construction, and the others keep their defaults."""
    model, _ = tiny_model()
    eng = paged_engine(model)
    srv = Server(eng, start=False, **kw)
    try:
        assert srv.max_preemptions == kw.get("max_preemptions", 5)
        assert eng.admission_mode == kw.get("admission_mode", "reserved")
        assert eng.draft_k == kw.get("draft_k", 0)
        assert eng.spec_mode == kw.get("spec_mode", "host")
        assert srv.speculative is kw.get("speculative", False)
    finally:
        srv.shutdown(drain=False)


@pytest.mark.parametrize("call,item", [
    (lambda s: s.load_adapter("a", {}), "A8"),
    (lambda s: s.unload_adapter("a"), "A8"),
    (lambda s: s.export_kv([1, 2]), "A10"),
    (lambda s: s.import_kv({}), "A10"),
    (lambda s: s.profile(), "A9b")])
def test_missing_features_fail_at_the_call(call, item):
    """What the engine lacks fails at the call: the adapter admin ops (A8,
    ported) on an engine built without ``lora_capacity`` raise the
    reference's RuntimeError naming it; the features not ported yet raise
    NotImplementedError naming their ROADMAP item."""
    model, _ = tiny_model()
    srv = Server(paged_engine(model), start=False,
                 admission_mode="reserved")
    try:
        if item == "A8":
            with pytest.raises(RuntimeError, match="lora_capacity"):
                call(srv)
        else:
            with pytest.raises(NotImplementedError,
                               match=f"not ported yet \\(ROADMAP {item}"):
                call(srv)
    finally:
        srv.shutdown(drain=False)


class TestHTTPFrontend:
    def test_roundtrip_health_metrics_and_streaming(self, mon):
        srv, eng, cfg = _server(max_queue=8, segment_steps=2)
        httpd = serve_http(srv)
        port = httpd.server_address[1]
        try:
            with urlopen(f"http://127.0.0.1:{port}/healthz",
                         timeout=30) as r:
                health = json.load(r)
            assert health["status"] == "ok"
            assert health["free_slots"] == 3
            body = json.dumps({"prompt": [1, 2, 3],
                               "max_new_tokens": 5}).encode()
            with urlopen(Request(f"http://127.0.0.1:{port}/generate",
                                 data=body), timeout=WAIT) as r:
                out = json.load(r)
            assert len(out["tokens"]) == out["n_tokens"] == 5
            assert out["ttft_s"] > 0
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=WAIT)
            conn.request("POST", "/generate", json.dumps(
                {"prompt": [4, 5, 6], "max_new_tokens": 8,
                 "stream": True}), {"Content-Type": "application/json"})
            resp = conn.getresponse()
            lines, stamps = [], []
            while True:
                line = resp.readline()
                if not line:
                    break
                lines.append(json.loads(line))
                stamps.append(time.monotonic())
            conn.close()
            assert [ln["token"] for ln in lines[:-1]] and len(lines) == 9
            assert lines[-1] == {"done": True, "status": "finished",
                                 "n_tokens": 8,
                                 "request_id": lines[-1]["request_id"]}
            assert stamps[-1] > stamps[0]
            with urlopen(f"http://127.0.0.1:{port}/metrics",
                         timeout=30) as r:
                prom = r.read().decode()
            assert "paddle_tpu_serving_ttft_seconds_bucket" in prom
            with urlopen(f"http://127.0.0.1:{port}/stats",
                         timeout=30) as r:
                stats = json.load(r)
            assert stats["server"] == srv.monitor_server
            assert stats["metrics"]["ttft"]["*"]["count"] == 2
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False)

    def test_error_codes(self):
        srv, eng, cfg = _server()
        httpd = serve_http(srv)
        port = httpd.server_address[1]
        url = f"http://127.0.0.1:{port}/generate"
        try:
            for bad in ({"prompt": [1], "temperature": 0},
                        {"prompt": [1], "max_new_tokens": 0},
                        {"prompt": [1], "top_p": 2},
                        {"prompt": []}, {"prompt": "abc"}, {},
                        {"prompt": [1], "adaptor": "x"}):
                with pytest.raises(HTTPError) as ei:
                    urlopen(Request(url, data=json.dumps(bad).encode()),
                            timeout=30)
                assert ei.value.code == 400
            with pytest.raises(HTTPError) as ei:
                urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
            assert ei.value.code == 404
            rng = np.random.RandomState(9)
            blocker = [srv.submit(rng.randint(0, cfg.vocab_size, (4,))
                                  .astype(np.int32),
                                  GenerationConfig(max_new_tokens=48,
                                                   eos_token_id=None))
                       for _ in range(3)]
            next(iter(blocker[0].stream(timeout=WAIT)))
            with pytest.raises(HTTPError) as ei:
                urlopen(Request(url, data=json.dumps(
                    {"prompt": [1, 2], "max_new_tokens": 4,
                     "stream": True, "timeout_s": 0.05}).encode()),
                        timeout=WAIT)
            assert ei.value.code == 504
            for h in blocker:
                h.cancel()
            srv.drain(timeout=WAIT)
            with pytest.raises(HTTPError) as ei:
                urlopen(Request(url, data=json.dumps(
                    {"prompt": [1], "max_new_tokens": 2}).encode()),
                        timeout=30)
            assert ei.value.code == 503
            assert json.load(ei.value)["reason"] == "draining"
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False)

    @pytest.mark.parametrize("method,path,item", [
        ("GET", "/profile", "A9b"), ("POST", "/adapters/load", "A8"),
        ("POST", "/adapters/unload", "A8"), ("POST", "/kv/export", "A10"),
        ("POST", "/kv/import", "A10")])
    def test_routes_not_ported_answer_501(self, method, path, item):
        """The routes of features not ported yet answer 501 naming their
        ROADMAP item. The adapter admin routes (A8) are ported: on an
        engine built without ``lora_capacity`` they answer the reference's
        400 naming it (permanently unsupported there, not a retryable
        503)."""
        model, _ = tiny_model()
        srv = Server(paged_engine(model), start=False)
        httpd = serve_http(srv)
        try:
            req = Request(f"http://127.0.0.1:{httpd.server_address[1]}"
                          f"{path}", method=method,
                          data=b"{}" if method == "POST" else None)
            with pytest.raises(HTTPError) as ei:
                urlopen(req, timeout=30)
            if item == "A8":
                assert ei.value.code == 400
                assert "lora_capacity" in json.load(ei.value)["error"]
                return
            assert ei.value.code == 501
            assert f"ROADMAP {item}" in json.load(ei.value)["error"]
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False)

    @pytest.mark.parametrize("field,value,item", [
        ("speculative", True, "A7"), ("draft_k", 4, "A7"),
        ("adapter", "ft", "A8")])
    def test_request_fields_not_ported_are_400(self, field, value, item):
        """The reference's request fields of features the port once lacked,
        each now ported; ``null`` asks for nothing and is served. The
        speculative-decoding fields (A7): a value is served
        (``speculative`` speculatively, on an engine with a draft window)
        and a malformed ``draft_k`` is a 400 naming it. The ``adapter``
        field (A8): a name is admitted, and on this engine, built without
        ``lora_capacity``, the request fails at admission (a 500 whose
        cause names it, the reference's request-scoped verdict); a
        malformed name is a 400 naming the field."""
        srv, eng, _ = _server(segment_steps=2, draft_k=3)
        httpd = serve_http(srv)
        url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
        try:
            if item == "A7":
                with urlopen(Request(url, data=json.dumps(
                        {"prompt": [1, 2, 1, 2], field: value,
                         "max_new_tokens": 4}).encode()),
                        timeout=WAIT) as r:
                    assert json.load(r)["n_tokens"] == 4
                assert (eng.spec_stats()["forwards"] > 0) is (
                    field == "speculative")
                with pytest.raises(HTTPError) as ei:
                    urlopen(Request(url, data=json.dumps(
                        {"prompt": [1], "draft_k": 0}).encode()),
                        timeout=30)
                assert ei.value.code == 400
                assert "draft_k" in json.load(ei.value)["error"]
            else:
                with pytest.raises(HTTPError) as ei:
                    urlopen(Request(url, data=json.dumps(
                        {"prompt": [1], field: value,
                         "max_new_tokens": 2}).encode()), timeout=WAIT)
                assert ei.value.code == 500
                assert "lora_capacity" in json.load(ei.value)["error"]
                with pytest.raises(HTTPError) as ei:
                    urlopen(Request(url, data=json.dumps(
                        {"prompt": [1], field: ""}).encode()),
                        timeout=30)
                assert ei.value.code == 400
                assert "adapter" in json.load(ei.value)["error"]
            assert srv.queue.depth == 0 and srv.num_active() == 0
            with urlopen(Request(url, data=json.dumps(
                    {"prompt": [1], field: None,
                     "max_new_tokens": 2}).encode()), timeout=WAIT) as r:
                assert json.load(r)["n_tokens"] == 2
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False)


def test_idempotent_retry_and_midstream_resume():
    """``idem_key``: a retried POST attaches to the request the front
    already holds (the same ``request_id``, one admission); a resume with
    ``from_token`` replays only the tail; an unknown key's resume is a
    409."""
    srv, eng, _ = _server(segment_steps=2)
    httpd = serve_http(srv)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
    try:
        body = {"prompt": [5, 6, 7], "max_new_tokens": 6, "idem_key": "k1"}
        with urlopen(Request(url, data=json.dumps(body).encode()),
                     timeout=WAIT) as r:
            first = json.load(r)
        with urlopen(Request(url, data=json.dumps(body).encode()),
                     timeout=WAIT) as r:
            again = json.load(r)
        assert again == first and first["n_tokens"] == 6
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=WAIT)
        conn.request("POST", "/generate", json.dumps(
            dict(body, stream=True, from_token=4)),
            {"Content-Type": "application/json"})
        lines = [json.loads(ln) for ln in
                 conn.getresponse().read().splitlines()]
        conn.close()
        assert [ln["token"] for ln in lines[:-1]] == first["tokens"][4:]
        assert lines[-1]["request_id"] == first["request_id"]
        with pytest.raises(HTTPError) as ei:
            urlopen(Request(url, data=json.dumps(dict(
                body, idem_key="nope", from_token=2)).encode()), timeout=30)
        assert ei.value.code == 409
        assert srv.drain(timeout=WAIT) and srv._next_id == 1
    finally:
        httpd.shutdown()
        srv.shutdown(drain=False)


def test_many_clients_at_once(mon):
    """More client threads than cores submit and stream at once, with the
    interpreter switching threads as often as it can: every request
    finishes whole, the counters agree, nothing leaks."""
    import os
    import sys

    srv, eng, cfg = _server(max_batch=3, max_queue=128, segment_steps=2)
    n_threads = 2 * (os.cpu_count() or 4) + 4
    outs, errors = [], []
    lock = threading.Lock()

    def client(i):
        try:
            for j in range(2):
                p = np.arange(1, 3 + (i + j) % 7, dtype=np.int32)
                h = srv.submit(p, GenerationConfig(max_new_tokens=3))
                toks = list(h.stream(timeout=WAIT))
                with lock:
                    outs.append(len(toks))
        except BaseException as e:          # asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(2 * WAIT)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:1]
        assert outs == [3] * (2 * n_threads)
        assert srv.drain(timeout=WAIT)
        ev = _events("paddle_tpu_serving_requests_total")
        assert ev["queued"] == ev["completed"] == 2 * n_threads
        assert eng.free_slots() == 3
        assert eng.alloc.free_pages == eng.num_pages
    finally:
        sys.setswitchinterval(old)
        srv.shutdown(drain=False)


def test_segment_length_of_a_prewarmed_engine(pair):
    """A ``Server`` whose ``segment_steps`` differs from the length an
    engine was warmed at builds its own segment programs at the first
    step (what the chip check of no capture after warmup would catch);
    ``warmup=True`` builds them before any request instead."""
    _, tm, prompts = pair
    for warm in (False, True):
        eng = PagedContinuousBatchingEngine(tm, **PAIR_PAGED)
        eng.warmup(segment_steps=4)
        srv = Server(eng, segment_steps=8, warmup=warm)
        try:
            assert srv.wait_ready(timeout=WAIT)
            before = dict(eng.programs.captures)
            assert len(srv.submit(prompts[0], GenerationConfig(
                max_new_tokens=9)).result(timeout=WAIT)) == 9
            grew = set(eng.programs.captures) - set(before)
            assert grew == (set() if warm else {("segment", 8)})
        finally:
            srv.shutdown(drain=False)
