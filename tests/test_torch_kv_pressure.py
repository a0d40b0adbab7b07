"""KV memory pressure in the port: optimistic paged admission with
preempt-and-replay, on the CPU.

The scenarios of ``tests/test_kv_pressure.py``, run port against port
(the reference's contract there is bitwise: a preempted greedy request
replays to the unpreempted stream), plus the preemption scenarios of
``tests/test_serving_faults.py`` (the storm dump, ``FaultyEngine`` at the
``"preempt"`` site). Covered:

- ``PageAllocator.check()`` (free and referenced pages partition the pool,
  table rows mirror ownership) and the ``debug_pages`` per-op arming;
- admission modes: optimistic claims prompt + one page and GROWS per gap;
  ``kv_watermark`` pauses new admissions under crowding but never on an
  idle pool; the knobs are validated;
- PARITY: greedy streams under forced preemption equal the same workload
  unpreempted, through ``engine.serve()`` and through ``Server``;
- ACCEPTANCE: optimistic mode completes a workload reserved mode cannot
  admit at equal ``num_pages``, with preemptions, no leaked page, and the
  oldest request never preempted;
- rails: ``max_preemptions`` fails a thrasher with
  ``PreemptionBudgetExceeded``; a request the pool cannot hold even alone
  fails ALONE with ``PagePoolExhausted``; an injected fault at ``"preempt"``
  is an engine-scoped fault the supervisor recovers from;
- races: preempt-then-cancel, preempt-then-engine-restart, pressure during
  a chunked admission;
- queue priority aging, and the ``pressure()`` / ``/healthz`` surface.

Every paged engine runs with ``debug_pages=True``: the allocator's
validator is armed at every page op and every gap. Every Server is shut
down in ``finally``.
"""
import json
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch import (ContinuousBatchingEngine, GenerationConfig,
                              LlamaForCausalLM, PagedContinuousBatchingEngine,
                              llama_config, monitor, tracing)
from paddle_tpu_torch.inference.generation import (ADMISSION_MODES,
                                                   EngineFault,
                                                   PagePoolExhausted)
from paddle_tpu_torch.inference.paged_cache import PageAllocator
from paddle_tpu_torch.serving import (RequestCancelled, RequestFailed, Server,
                                      serve_http)
from paddle_tpu_torch.serving.queue import (DeadlineExpired, RequestHandle,
                                            RequestQueue)
from paddle_tpu_torch.serving.scheduler import PreemptionBudgetExceeded
from paddle_tpu_torch.testing.faults import FaultPlan, FaultyEngine

WAIT = 180
_MODEL = None


def tiny_model():
    """ONE tiny llama shared by the module (1 layer, seeded)."""
    global _MODEL
    if _MODEL is None:
        torch.manual_seed(0)
        cfg = llama_config("tiny", num_hidden_layers=1)
        _MODEL = (LlamaForCausalLM(cfg, device="cpu"), cfg)
    return _MODEL


def paged_engine(model, max_batch=4, num_pages=64, page_size=4,
                 max_pages=8, **kw):
    kw.setdefault("debug_pages", True)
    return PagedContinuousBatchingEngine(
        model, max_batch=max_batch, num_pages=num_pages,
        page_size=page_size, max_pages=max_pages, **kw)


def _greedy(n, eos=None):
    return GenerationConfig(max_new_tokens=n, eos_token_id=eos)


def _prompts(cfg, n, plen=6, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (plen,)).astype(np.int32)
            for _ in range(n)]


def _reference(prompts, maxes, eos=None):
    """Greedy tokens from a big reserved pool (no pressure possible)."""
    model, _ = tiny_model()
    srv = Server(paged_engine(model), segment_steps=4)
    try:
        hs = [srv.submit(p, _greedy(m, eos)) for p, m in zip(prompts, maxes)]
        return [h.result(timeout=WAIT) for h in hs]
    finally:
        srv.shutdown()


def _assert_no_leaks(eng):
    assert eng.free_slots() == eng.max_batch
    assert eng.alloc.free_pages == eng.num_pages
    eng.alloc.check()


# -- allocator invariant validator ---------------------------------------------
class TestAllocatorCheck:
    def _alloc(self, debug=False):
        return PageAllocator(num_pages=8, page_size=4, max_batch=2,
                             max_pages=6, debug=debug)

    def test_clean_states_pass(self):
        a = self._alloc()
        a.check()
        a.ensure(0, 10)
        a.ensure(1, 4)
        a.check()
        a.free_slot(0)
        a.check()

    def test_double_owned_page_detected(self):
        a = self._alloc()
        a.ensure(0, 4)
        a._owned[1] = [a._owned[0][0]]
        with pytest.raises(RuntimeError, match="matching refcount"):
            a.check()

    def test_lost_page_detected(self):
        a = self._alloc()
        a.ensure(0, 4)
        a._owned[0] = []
        a.page_table[0, :] = -1
        with pytest.raises(RuntimeError, match="refcount leak|missing"):
            a.check()

    def test_free_list_duplicate_detected(self):
        a = self._alloc()
        a._free.append(a._free[0])
        with pytest.raises(RuntimeError, match="twice in the free"):
            a.check()

    def test_stale_table_row_detected(self):
        a = self._alloc()
        a.ensure(0, 8)
        a.page_table[0, 0] = 99
        with pytest.raises(RuntimeError, match="row 0 inconsistent"):
            a.check()

    def test_debug_flag_arms_every_op(self):
        a = self._alloc(debug=True)
        a.ensure(0, 8)
        a.page_table[0, 1] = -1
        with pytest.raises(RuntimeError, match="inconsistent"):
            a.ensure(1, 4)


# -- admission-mode knobs ------------------------------------------------------
class TestAdmissionModes:
    def test_knob_validation(self):
        model, _ = tiny_model()
        with pytest.raises(ValueError, match="admission_mode"):
            paged_engine(model, admission_mode="eager")
        for bad in (0, -0.1, 1.5):
            with pytest.raises(ValueError, match="kv_watermark"):
                paged_engine(model, admission_mode="optimistic",
                             kv_watermark=bad)
        assert ADMISSION_MODES == ("reserved", "optimistic")
        with pytest.raises(ValueError, match="max_preemptions"):
            Server(paged_engine(model), max_preemptions=-1, start=False)

    def test_server_mirror_needs_idle_paged_engine(self):
        model, _ = tiny_model()
        dense = ContinuousBatchingEngine(model, max_batch=2, max_len=32)
        with pytest.raises(ValueError, match="paged engine"):
            Server(dense, admission_mode="optimistic", start=False)
        with pytest.raises(ValueError, match="admission_mode"):
            Server(paged_engine(model), admission_mode="nope", start=False)
        eng = paged_engine(model)
        srv = Server(eng, admission_mode="optimistic", start=False)
        assert eng.admission_mode == "optimistic"
        srv.shutdown(drain=False)
        busy = paged_engine(model)
        busy.add_request(np.arange(4, dtype=np.int32), _greedy(4))
        with pytest.raises(ValueError, match="idle"):
            Server(busy, admission_mode="optimistic", start=False)

    def test_optimistic_claim_is_prompt_plus_one_page(self):
        model, _ = tiny_model()
        eng = paged_engine(model, admission_mode="optimistic")
        assert eng._optimistic_claim(6, _greedy(20)) == 6 + eng.page_size
        assert (eng._optimistic_claim(6, _greedy(1))
                == eng._reserved(6, _greedy(1)))
        eng.add_request(np.arange(6, dtype=np.int32), _greedy(20))
        assert eng.alloc.covered_tokens(0) == 12     # 6 + 4 -> 3 pages
        eng.cancel_request(next(iter(eng._slot_req.values())))
        _assert_no_leaks(eng)

    def test_watermark_pauses_new_admissions_but_not_idle(self):
        model, _ = tiny_model()
        eng = paged_engine(model, num_pages=8, admission_mode="optimistic",
                           kv_watermark=0.5)
        cfg = _greedy(8)
        assert eng.can_admit(6, cfg)                 # idle: no watermark
        eng.add_request(np.arange(6, dtype=np.int32), cfg)   # 3 pages
        assert not eng.can_admit(6, cfg)             # 3 + 3 > 0.5 * 8
        # the refusal came from the watermark, not from can_fit
        assert eng.alloc.can_fit(eng._free[0], eng._optimistic_claim(6, cfg))
        eng.cancel_request(next(iter(eng._slot_req.values())))
        _assert_no_leaks(eng)


# -- engine-level grow / preempt / exhaustion guard ----------------------------
class TestEngineGrowPreempt:
    def test_exhaustion_is_loud_and_preempt_unblocks(self):
        """A bare caller that ignores pressure meets PagePoolExhausted from
        decode_segment (never a silently dropped write); preempt_request
        reclaims the victim and decoding goes on."""
        model, mcfg = tiny_model()
        eng = paged_engine(model, num_pages=10, admission_mode="optimistic",
                           kv_watermark=1.0)
        p1, p2 = _prompts(mcfg, 2)
        r1 = eng.add_request(p1, _greedy(24))
        r2 = eng.add_request(p2, _greedy(24))
        with pytest.raises(PagePoolExhausted) as ei:
            for _ in range(8):
                eng.decode_segment(4)
        assert set(ei.value.rids) <= {r1, r2}
        toks = eng.preempt_request(r2)
        assert toks is not None and len(toks) >= 1
        assert eng.preempt_request(r2) is None
        assert eng.alloc.preemptions == 1
        while eng.decode_segment(4):
            pass
        assert len(eng.collect_finished()[r1]) == 24
        _assert_no_leaks(eng)

    def test_serve_parity_under_repeated_preemption(self):
        """``engine.serve()`` on a tight pool preempts the same request
        more than once; its replay budget is measured against the ORIGINAL
        config each time, so no result is truncated."""
        model, mcfg = tiny_model()
        prompts = _prompts(mcfg, 3)
        ref = paged_engine(model).serve(prompts, _greedy(24),
                                        segment_steps=4)
        eng = paged_engine(model, num_pages=12, admission_mode="optimistic",
                           kv_watermark=1.0)
        out = eng.serve(prompts, _greedy(24), segment_steps=4)
        assert eng.alloc.preemptions >= 3
        assert eng.serve_stats["preemptions"] == eng.alloc.preemptions
        for a, b in zip(ref, out):
            assert np.array_equal(a, b)
        _assert_no_leaks(eng)

    def test_grow_noop_in_reserved_mode(self):
        model, mcfg = tiny_model()
        eng = paged_engine(model, num_pages=10)
        eng.add_request(_prompts(mcfg, 1)[0], _greedy(8))
        assert eng.grow_for_segment(4) == []
        while eng.decode_segment(4):
            pass
        eng.collect_finished()
        _assert_no_leaks(eng)

    def test_growth_stamp_skips_redundant_recheck(self):
        """A clean grow_for_segment(n) stamps the engine so decode_segment
        (n) skips its re-check; the stamp is single-shot, an admission
        invalidates it, and the gap's (lens, done) copy goes with it."""
        model, mcfg = tiny_model()
        eng = paged_engine(model, num_pages=64, admission_mode="optimistic",
                           kv_watermark=1.0)
        p = _prompts(mcfg, 2)
        eng.add_request(p[0], _greedy(8))
        assert eng._growth_stamp is None
        assert eng.grow_for_segment(4) == []
        assert eng._growth_stamp == 4 and eng._gap_sync is not None
        eng.add_request(p[1], _greedy(8))
        assert eng._growth_stamp is None and eng._gap_sync is None
        assert eng.grow_for_segment(4) == []
        eng.decode_segment(4)
        assert eng._growth_stamp is None and eng._gap_sync is None
        while eng.decode_segment(4):
            pass
        eng.collect_finished()
        _assert_no_leaks(eng)


# -- server-level preemption ---------------------------------------------------
class TestServerPreemption:
    def test_parity_and_acceptance_under_forced_preemption(self):
        """Greedy tokens under forced preemption equal the unpreempted
        ones; preemptions happened; the oldest request was never
        preempted; no page leaked."""
        model, mcfg = tiny_model()
        prompts = _prompts(mcfg, 4)
        ref = _reference(prompts, [20] * 4)
        eng = paged_engine(model, num_pages=14, admission_mode="optimistic",
                           kv_watermark=1.0)
        srv = Server(eng, segment_steps=4, max_preemptions=50)
        try:
            hs = [srv.submit(p, _greedy(20)) for p in prompts]
            out = [h.result(timeout=WAIT) for h in hs]
            for a, b in zip(ref, out):
                assert np.array_equal(a, b)
            assert eng.alloc.preemptions >= 1
            assert sum(h._preempts for h in hs) >= 1
            assert hs[0]._preempts == 0
            assert srv.drain(timeout=30)
            _assert_no_leaks(eng)
            pr = srv.pressure()
            assert pr["preemptions"] == eng.alloc.preemptions
            assert pr["admission_mode"] == "optimistic"
            assert pr["waiting_on_pages"] == 0 and pr["occupancy"] == 0.0
        finally:
            srv.shutdown()

    def test_optimistic_completes_what_reserved_cannot_admit(self):
        """Equal num_pages: reserved mode cannot ADMIT the request (worst
        case 26 tokens > the 24-token pool); optimistic completes three
        of them, which stop early on an eos taken from the stream."""
        model, mcfg = tiny_model()
        p = _prompts(mcfg, 1)[0]
        ref = list(map(int, _reference([p], [20])[0]))
        # the eos: the first token from position 8 on that is new to the
        # stream, so every request stops exactly there
        k = next(i for i in range(8, 20) if ref[i] not in ref[:i])
        want = ref[:k + 1]

        def build(mode):
            return paged_engine(model, num_pages=6, admission_mode=mode,
                                kv_watermark=1.0)

        res = build("reserved")
        srv = Server(res, segment_steps=4)
        try:
            h = srv.submit(p, _greedy(20, ref[k]))
            with pytest.raises(RequestFailed, match="never be admitted"):
                h.result(timeout=60)
        finally:
            srv.shutdown()
        _assert_no_leaks(res)

        opt = build("optimistic")
        srv2 = Server(opt, segment_steps=4, max_preemptions=50)
        try:
            hs = [srv2.submit(p, _greedy(20, ref[k])) for _ in range(3)]
            out = [list(map(int, h.result(timeout=WAIT))) for h in hs]
            assert out == [want] * 3
            assert opt.alloc.preemptions >= 1
            assert hs[0]._preempts == 0
            assert srv2.drain(timeout=30)
            _assert_no_leaks(opt)
        finally:
            srv2.shutdown()

    def test_preemption_budget_exceeded_typed_failure(self):
        """max_preemptions=0: the first preemption fails its victim with
        PreemptionBudgetExceeded; everyone else completes."""
        model, mcfg = tiny_model()
        eng = paged_engine(model, num_pages=10, admission_mode="optimistic",
                           kv_watermark=1.0)
        srv = Server(eng, segment_steps=4, max_preemptions=0)
        try:
            hs = [srv.submit(p, _greedy(16)) for p in _prompts(mcfg, 3)]
            failed = 0
            for h in hs:
                try:
                    assert len(h.result(timeout=WAIT)) == 16
                except RequestFailed as e:
                    assert isinstance(e.__cause__, PreemptionBudgetExceeded)
                    failed += 1
            assert failed >= 1
            assert hs[0].status == "finished"
            assert srv.drain(timeout=30)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown()

    def test_unsatisfiable_request_fails_alone(self):
        """A request whose growth cannot fit even with the pool to itself
        fails with PagePoolExhausted as its cause, contained (no restart);
        the server goes on serving."""
        model, mcfg = tiny_model()
        eng = paged_engine(model, num_pages=4, admission_mode="optimistic",
                           kv_watermark=1.0)
        srv = Server(eng, segment_steps=4)
        try:
            h = srv.submit(_prompts(mcfg, 1)[0], _greedy(20))
            with pytest.raises(RequestFailed) as ei:
                h.result(timeout=WAIT)
            assert isinstance(ei.value.__cause__, PagePoolExhausted)
            assert srv.restarts == 0
            assert srv.fault_stats()["faults"] == {}
            h2 = srv.submit(_prompts(mcfg, 1)[0], _greedy(4))
            assert len(h2.result(timeout=WAIT)) == 4
            assert srv.drain(timeout=30)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown()

    def test_preempt_then_cancel(self):
        """A preempted handle parked for replay is cancelled: it finishes
        CANCELLED once, never re-admits, and nothing leaks."""
        model, mcfg = tiny_model()
        eng = paged_engine(model, num_pages=10, admission_mode="optimistic",
                           kv_watermark=1.0)
        srv = Server(eng, segment_steps=4, max_preemptions=50)
        try:
            p = _prompts(mcfg, 2)
            h_old = srv.submit(p[0], _greedy(24))
            h_vic = srv.submit(p[1], _greedy(24))
            deadline = time.monotonic() + WAIT
            while h_vic._preempts == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert h_vic._preempts >= 1
            h_vic.cancel()
            with pytest.raises(RequestCancelled):
                h_vic.result(timeout=WAIT)
            assert len(h_old.result(timeout=WAIT)) == 24
            assert srv.drain(timeout=30)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown()

    def test_preempt_then_engine_restart_composes(self):
        """An engine-scoped fault while a preempted handle waits for its
        replay: recovery replays both kinds, greedy tokens are the
        fault-free ones, and fault_stats/drain stay accurate."""
        model, mcfg = tiny_model()
        prompts = _prompts(mcfg, 3)
        ref = _reference(prompts, [16] * 3)
        plan = FaultPlan().raise_at("decode", nth=4,
                                    exc=EngineFault("injected"))
        eng = paged_engine(model, num_pages=10, admission_mode="optimistic",
                           kv_watermark=1.0)
        srv = Server(FaultyEngine(eng, plan), segment_steps=4,
                     max_preemptions=50, max_restarts=3, max_replays=8,
                     restart_backoff_s=0.01)
        try:
            hs = [srv.submit(p, _greedy(16)) for p in prompts]
            out = [h.result(timeout=WAIT) for h in hs]
            for a, b in zip(ref, out):
                assert np.array_equal(a, b)
            assert srv.restarts == 1
            assert eng.alloc.preemptions >= 1
            fs = srv.fault_stats()
            assert fs["faults"].get(("engine", "decode")) == 1
            assert fs["degraded"] is None
            assert srv.drain(timeout=30)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown()

    def test_pressure_during_chunked_admission_aborts_claim(self):
        """Pressure with only the oldest request active makes the in-flight
        chunked admission the victim: its claim aborts, the handle parks
        with a preemption charged and completes by replay."""
        model, mcfg = tiny_model()
        rng = np.random.RandomState(3)
        long_p = rng.randint(0, mcfg.vocab_size, (12,)).astype(np.int32)
        short_p = _prompts(mcfg, 1)[0]
        ref = _reference([short_p, long_p], [20, 8])
        eng = paged_engine(model, num_pages=8, admission_mode="optimistic",
                           kv_watermark=1.0, prefill_chunk=4)
        srv = Server(eng, segment_steps=4, max_preemptions=50)
        try:
            # both queued at once, oldest first: the long prompt's chunked
            # admission begins while the short request grows (a pause
            # here would let the short one finish before it on the CPU)
            h_old = srv.submit(short_p, _greedy(20))
            h_chk = srv.submit(long_p, _greedy(8))
            out = [h_old.result(timeout=WAIT), h_chk.result(timeout=WAIT)]
            assert np.array_equal(out[0], ref[0])
            assert np.array_equal(out[1], ref[1])
            assert eng.alloc.preemptions >= 1
            assert h_old._preempts == 0
            assert srv.drain(timeout=30)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown()

    def test_pressure_aborted_admission_keeps_deadline(self):
        """A handle parked WITHOUT ever completing an admission still
        honours its admission deadline in ``_admit_replays``; one that did
        admit once is deferred, not expired."""
        model, mcfg = tiny_model()
        eng = paged_engine(model, num_pages=4, admission_mode="optimistic",
                           kv_watermark=1.0)
        srv = Server(eng, segment_steps=4, max_preemptions=50)
        srv.shutdown()       # the test thread drives _admit_replays
        hog = eng.add_request(_prompts(mcfg, 1)[0], _greedy(24))
        p = _prompts(mcfg, 1, seed=7)[0]
        dead = RequestHandle(990, p, len(p), _greedy(8),
                             deadline=time.monotonic() - 0.1)
        met = RequestHandle(991, p, len(p), _greedy(8),
                            deadline=time.monotonic() - 0.1)
        met.engine_rid = 12345
        srv._replay.extend([dead, met])
        srv._admit_replays()
        assert dead.status == "expired"
        with pytest.raises(DeadlineExpired):
            dead.result(timeout=1)
        assert met.status == "queued"
        assert met in srv._replay
        eng.cancel_request(hog)
        _assert_no_leaks(eng)

    def test_pressure_surface_healthz(self):
        """/healthz carries the pressure block for a paged engine and omits
        it for a dense one."""
        model, mcfg = tiny_model()
        eng = paged_engine(model, num_pages=10, admission_mode="optimistic",
                           kv_watermark=1.0)
        srv = Server(eng, segment_steps=4, max_preemptions=50)
        httpd = None
        try:
            for h in [srv.submit(p, _greedy(16)) for p in _prompts(mcfg, 3)]:
                h.result(timeout=WAIT)
            httpd = serve_http(srv, port=0)
            port = httpd.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                body = json.loads(r.read())
            assert body["status"] == "ok"
            pr = body["pressure"]
            assert pr["admission_mode"] == "optimistic"
            assert pr["preemptions"] == eng.alloc.preemptions >= 1
            assert pr["free_pages"] == eng.num_pages
        finally:
            if httpd is not None:
                httpd.shutdown()
            srv.shutdown()
        srv2 = Server(ContinuousBatchingEngine(model, max_batch=2,
                                               max_len=32), segment_steps=4)
        httpd2 = None
        try:
            assert srv2.pressure() is None
            httpd2 = serve_http(srv2, port=0)
            port = httpd2.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                assert "pressure" not in json.loads(r.read())
        finally:
            if httpd2 is not None:
                httpd2.shutdown()
            srv2.shutdown()


# -- monitor export ------------------------------------------------------------
class TestMonitorExport:
    def test_preemption_family_exported_and_retired(self):
        """paddle_tpu_kv_preemptions_total{pool,reason} and the per-server
        kv_pressure gauge export while serving and retire with the engine's
        close() and the server's shutdown."""
        monitor.enable()
        monitor.reset()
        try:
            model, mcfg = tiny_model()
            eng = paged_engine(model, num_pages=10,
                               admission_mode="optimistic", kv_watermark=1.0)
            srv = Server(eng, segment_steps=4, max_preemptions=50)
            try:
                for h in [srv.submit(p, _greedy(16))
                          for p in _prompts(mcfg, 3)]:
                    h.result(timeout=WAIT)
                snap = monitor.snapshot()["metrics"]
                samples = snap.get("paddle_tpu_kv_preemptions_total",
                                   {}).get("samples", [])
                assert sum(s["value"] for s in samples) \
                    == eng.alloc.preemptions >= 1
                assert any(s["labels"].get("reason") == "pressure"
                           for s in samples)
                assert snap.get("paddle_tpu_serving_kv_pressure",
                                {}).get("samples")
                pool = eng.alloc.monitor_pool
                pages = snap["paddle_tpu_kv_pages"]["samples"]
                assert {s["labels"]["state"] for s in pages
                        if s["labels"]["pool"] == pool} == {"free", "used"}
            finally:
                srv.shutdown()
            eng.close()
            snap2 = monitor.snapshot()["metrics"]
            for name in ("paddle_tpu_kv_preemptions_total",
                         "paddle_tpu_serving_kv_pressure",
                         "paddle_tpu_kv_pages",
                         "paddle_tpu_kv_page_occupancy_ratio"):
                assert not snap2.get(name, {}).get("samples", []), name
        finally:
            monitor.reset()
            monitor.disable()


# -- the preemption scenarios of the chaos suite -------------------------------
class TestPreemptionFaults:
    def test_preemption_storm_dumps_once(self, tmp_path):
        """The storm trigger fires on preemption DENSITY and re-arms only
        after a full window (driven through _park_preempted)."""
        tracing.clear()
        tracing.enable(dump_dir=str(tmp_path))
        srv = Server(types.SimpleNamespace(max_len=64), start=False)
        srv.STORM_PREEMPTS = 3
        try:
            for k in range(3):
                h = RequestHandle(k, np.arange(3), 3, _greedy(4))
                h._trace_rid = f"{srv.monitor_server}:{k}"
                srv._park_preempted(h)
            dumps = srv.fault_stats()["flight_dumps"]
            assert len(dumps) == 1
            with open(dumps[0]) as f:
                doc = json.load(f)
            assert doc["otherData"]["reason"] == "preemption_storm"
            storm = [e for e in doc["traceEvents"]
                     if e["name"] == "preempt.storm"]
            assert storm and storm[-1]["args"]["count"] == 3
            h = RequestHandle(9, np.arange(3), 3, _greedy(4))
            h._trace_rid = f"{srv.monitor_server}:9"
            srv._park_preempted(h)
            assert len(srv.fault_stats()["flight_dumps"]) == 1
            assert [x._preempts for x in srv._replay] == [1, 1, 1, 1]
        finally:
            srv.shutdown(drain=False)
            tracing.disable()
            tracing.clear()

    def test_storm_without_tracing_keeps_the_window_armed(self):
        """A storm with tracing off writes no dump and does not burn the
        window: the trigger stays armed."""
        assert not tracing.enabled()
        srv = Server(types.SimpleNamespace(max_len=64), start=False)
        srv.STORM_PREEMPTS = 2
        try:
            for k in range(3):
                srv._park_preempted(RequestHandle(k, np.arange(3), 3,
                                                  _greedy(4)))
            assert srv.fault_stats()["flight_dumps"] == []
            assert srv._last_storm_dump < 0
        finally:
            srv.shutdown(drain=False)

    def test_faulty_engine_preempt_site(self):
        """An injected fault at ``"preempt"`` (the pressure-relief loop's
        victim reclaim) is engine-scoped: the server resets the engine and
        replays everyone to the fault-free tokens, and nothing leaks."""
        model, mcfg = tiny_model()
        prompts = _prompts(mcfg, 3)
        ref = _reference(prompts, [16] * 3)
        plan = FaultPlan().raise_at("preempt", nth=1)
        eng = paged_engine(model, num_pages=10, admission_mode="optimistic",
                           kv_watermark=1.0)
        srv = Server(FaultyEngine(eng, plan), segment_steps=4,
                     max_preemptions=50, max_restarts=3, max_replays=8,
                     restart_backoff_s=0.01)
        try:
            hs = [srv.submit(p, _greedy(16)) for p in prompts]
            out = [h.result(timeout=WAIT) for h in hs]
            for a, b in zip(ref, out):
                assert np.array_equal(a, b)
            assert plan.injected == [("preempt", 1, "raise")]
            assert plan.calls["preempt"] >= 2
            assert srv.restarts == 1
            assert srv.fault_stats()["faults"].get(
                ("engine", "pressure")) == 1
            assert srv.drain(timeout=30)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown()

    def test_preemption_budget_fails_thrasher_through_proxy(self):
        """The budget holds through a FaultyEngine proxy too: with
        max_preemptions=0 the victims fail with PreemptionBudgetExceeded,
        the oldest finishes, and every preemption passed the seam."""
        model, mcfg = tiny_model()
        plan = FaultPlan()
        eng = paged_engine(model, num_pages=10, admission_mode="optimistic",
                           kv_watermark=1.0)
        srv = Server(FaultyEngine(eng, plan), segment_steps=4,
                     max_preemptions=0)
        try:
            hs = [srv.submit(p, _greedy(16)) for p in _prompts(mcfg, 3)]
            causes = []
            for h in hs:
                try:
                    h.result(timeout=WAIT)
                except RequestFailed as e:
                    causes.append(type(e.__cause__))
            assert causes and set(causes) == {PreemptionBudgetExceeded}
            assert hs[0].status == "finished"
            assert plan.calls["preempt"] == eng.alloc.preemptions >= 1
            assert srv.drain(timeout=30)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown()


# -- queue priority aging ------------------------------------------------------
class TestPriorityAging:
    def _handle(self, rid, priority, age_s=0.0):
        h = RequestHandle(rid, np.arange(4, dtype=np.int32), 4, _greedy(4),
                          priority=priority)
        h.submit_ts -= age_s
        return h

    def test_validation(self):
        with pytest.raises(ValueError, match="age_after_s"):
            RequestQueue(4, age_after_s=0.0)
        with pytest.raises(ValueError, match="age_after_s"):
            RequestQueue(4, age_after_s=-1)

    def test_static_priority_starves_without_aging(self):
        q = RequestQueue(4)
        q.put(self._handle(0, priority=5, age_s=100.0))
        q.put(self._handle(1, priority=0))
        q.reap(time.monotonic())
        assert q.pop_if(lambda h: True).id == 1

    def test_aging_bumps_long_waiters(self):
        q = RequestQueue(4, age_after_s=10.0)
        q.put(self._handle(0, priority=5, age_s=100.0))
        q.put(self._handle(1, priority=0))
        q.reap(time.monotonic())
        assert q.pop_if(lambda h: True).id == 0
        assert q.pop_if(lambda h: True).id == 1

    def test_fifo_within_effective_level_preserved(self):
        q = RequestQueue(4, age_after_s=10.0)
        a = self._handle(0, priority=1, age_s=11.0)
        b = self._handle(1, priority=0)
        c = self._handle(2, priority=0)
        q.put(b)
        q.put(c)
        q.put(a)
        q.reap(time.monotonic())
        assert [q.pop_if(lambda h: True).id for _ in range(3)] == [1, 2, 0]

    def test_server_passes_age_after_s_through(self):
        model, _ = tiny_model()
        srv = Server(paged_engine(model), age_after_s=0.5, start=False)
        assert srv.queue.age_after_s == 0.5
        srv.shutdown(drain=False)
