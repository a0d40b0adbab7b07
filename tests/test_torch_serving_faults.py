"""Chaos suite for the port's fault-isolated serving path, on the CPU.

The scenarios of ``tests/test_serving_faults.py`` against
``paddle_tpu_torch.serving``, driven by the port's deterministic injection
harness (``paddle_tpu_torch.testing.faults``):

- per-request CONTAINMENT: a fault at a request-scoped seam (admission
  call, prefill inside the abort guard, a chunk of a chunked admission)
  fails ONLY that request with its cause; the others finish with the
  fault-free tokens and nothing leaks;
- supervised ENGINE RECOVERY: an engine-scoped fault in
  ``decode_segment`` triggers reset + replay within ``max_restarts``;
  greedy requests finish with the fault-free tokens; ``max_replays`` and
  ``max_restarts`` both hold, the latter falling through to the fatal path;
- the STALL WATCHDOG, the HTTP satellites (client disconnect reclaims,
  a failed server's 503s), shutdown and drain during warmup,
  ``tools/monitor_report.py`` reading the port's JSONL unchanged, the
  flight recorder, and the overload control plane (unit and wired into the
  Server).

The preemption scenarios (the storm dump, ``PreemptionBudgetExceeded``,
``FaultyEngine`` at ``"preempt"``) are in ``tests/test_torch_kv_pressure.py``.
Not here, with the items that bring them: ``NetworkFaultPlan`` and the
elastic fleet's router (A10), the ``serve_bench`` chaos soak (A3). Every
Server is shut down in ``finally``.
"""
import importlib.util
import json
import os
import threading
import time
import types
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch

from paddle_tpu_torch import (CausalLMEngine, GenerationConfig,
                              LlamaForCausalLM, PagedContinuousBatchingEngine,
                              llama_config, monitor, tracing)
from paddle_tpu_torch.inference.generation import (EngineFault,
                                                   RequestFault,
                                                   classify_fault)
from paddle_tpu_torch.serving import (ControlPlane, ControlPolicy,
                                      ElasticController, RequestCancelled,
                                      RequestFailed, RequestHandle,
                                      RequestQueue, RequestRejected, Server,
                                      serve_http)
from paddle_tpu_torch.testing.faults import (SITES, FaultPlan, FaultyEngine,
                                             InjectedFault)
from torch_jax_state import jax_reference_state  # noqa: F401

WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models and ops are
    tiny, and a thread pool on a machine whose cores other test workers
    hold waits for its threads at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_model(layers=1, seed=0):
    torch.manual_seed(seed)
    cfg = llama_config("tiny", num_hidden_layers=layers)
    return LlamaForCausalLM(cfg, device="cpu"), cfg


def paged_engine(model, max_batch=3, num_pages=24, page_size=8,
                 max_pages=8, **kw):
    # the allocator's invariant check runs after every page operation: a
    # reclaim bug on any abort/retire path fails at the faulty op
    kw.setdefault("debug_pages", True)
    return PagedContinuousBatchingEngine(
        model, max_batch=max_batch, num_pages=num_pages,
        page_size=page_size, max_pages=max_pages, **kw)


def faulty_server(plan=None, model_layers=1, **kw):
    """(server, RAW engine, model cfg): the engine is wrapped in a
    FaultyEngine when a plan is given; capacity assertions go against the
    raw engine."""
    model, cfg = tiny_model(layers=model_layers)
    eng_keys = ("max_batch", "num_pages", "page_size", "max_pages",
                "prefill_buckets", "prefill_chunk")
    eng_kw = {k: kw.pop(k) for k in list(kw) if k in eng_keys}
    raw = paged_engine(model, **eng_kw)
    eng = FaultyEngine(raw, plan) if plan is not None else raw
    return Server(eng, **kw), raw, cfg


@pytest.fixture()
def mon():
    monitor.enable()
    monitor.reset()
    yield monitor
    monitor.reset()
    monitor.disable()


@pytest.fixture()
def tr(tmp_path):
    tracing.clear()
    tracing.enable(dump_dir=str(tmp_path))
    yield tracing
    tracing.disable()
    tracing.clear()


def _greedy(n):
    return GenerationConfig(max_new_tokens=n, eos_token_id=None)


def _oracle(prompts, maxes, max_len=64):
    """Expected greedy tokens per prompt, from ``CausalLMEngine`` on the
    same model (``tiny_model()``'s weights)."""
    model, _ = tiny_model()
    dense = CausalLMEngine(model, max_batch=1, max_len=max_len)
    return [dense.generate(p[None], _greedy(m))[0, len(p):]
            for p, m in zip(prompts, maxes)]


def _assert_no_leaks(eng):
    assert eng.free_slots() == eng.max_batch
    assert eng.alloc.free_pages == eng.num_pages


class TestTaxonomy:
    def test_classify_fault(self):
        assert classify_fault(RequestFault("x"), "decode") == "request"
        assert classify_fault(EngineFault("x"), "admit") == "engine"
        for site in ("admit", "prefill", "chunk"):
            assert classify_fault(RuntimeError("x"), site) == "request"
        for site in ("decode", "collect", "cancel"):
            assert classify_fault(RuntimeError("x"), site) == "engine"
        assert classify_fault(KeyboardInterrupt(), "admit") == "fatal"
        assert classify_fault(SystemExit(), "decode") == "fatal"


class TestFaultPlan:
    def test_nth_and_times_deterministic(self):
        plan = FaultPlan()
        plan.raise_at("decode", nth=2, times=2)
        plan.fire("decode")
        with pytest.raises(InjectedFault, match="call 2"):
            plan.fire("decode")
        with pytest.raises(InjectedFault):
            plan.fire("decode")
        plan.fire("decode")
        assert [(s, n) for s, n, _ in plan.injected] == [
            ("decode", 2), ("decode", 3)]
        assert plan.calls["decode"] == 4

    def test_sites_are_independent_and_validated(self):
        plan = FaultPlan().raise_at("admit", nth=1)
        plan.fire("decode")
        with pytest.raises(InjectedFault):
            plan.fire("admit")
        with pytest.raises(ValueError, match="unknown site"):
            plan.raise_at("nope")
        assert set(SITES) == {"admit", "prefill", "chunk", "decode",
                              "collect", "preempt"}

    def test_hang_bounded_and_releasable(self):
        plan = FaultPlan().hang_at("decode", nth=1, seconds=30)
        t = threading.Timer(0.05, plan.release_hangs)
        t.start()
        t0 = time.monotonic()
        plan.fire("decode")
        assert time.monotonic() - t0 < 5
        t.join()

    def test_custom_exception_passthrough(self):
        plan = FaultPlan().raise_at("decode",
                                    exc=EngineFault("device lost"))
        with pytest.raises(EngineFault, match="device lost"):
            plan.fire("decode")

    def test_kill_arms_from_the_current_call(self):
        plan = FaultPlan()
        plan.fire("decode")
        plan.fire("decode")
        plan.kill("decode")
        for _ in range(3):
            with pytest.raises(EngineFault, match="replica killed"):
                plan.fire("decode")
        assert [n for _, n, _ in plan.injected] == [3, 4, 5]

    def test_plan_reassignment_rearms_proxy_seams(self):
        """``fe.plan = new_plan`` stays on the PROXY and rearms every seam,
        the engine-internal prefill shadow included; warmup's prefills do
        not pass the prefill seam."""
        model, cfg = tiny_model()
        raw = paged_engine(model)
        fe = FaultyEngine(raw, FaultPlan())
        fe.decode_segment(1)
        fe.plan = FaultPlan().raise_at("decode", nth=1)
        assert "plan" not in vars(raw)
        with pytest.raises(InjectedFault):
            fe.decode_segment(1)
        fe.plan = FaultPlan().raise_at("prefill", nth=1)
        fe.warmup(2)
        assert fe.plan.calls["prefill"] == 0
        p = np.random.RandomState(0).randint(
            0, cfg.vocab_size, (6,)).astype(np.int32)
        with pytest.raises(InjectedFault):
            fe.add_request(p, _greedy(4))
        assert raw.free_slots() == raw.max_batch
        assert raw.alloc.free_pages == raw.num_pages
        raw.alloc.check()


class TestEngineReset:
    def test_reset_state_reclaims_everything_and_still_serves(self):
        model, cfg = tiny_model()
        eng = paged_engine(model, max_batch=2, num_pages=12)
        rng = np.random.RandomState(0)
        p = rng.randint(0, cfg.vocab_size, (6,)).astype(np.int32)
        want = _oracle([p], [5])[0]
        eng.add_request(p, _greedy(30))
        eng.add_request(rng.randint(0, cfg.vocab_size, (4,))
                        .astype(np.int32), _greedy(30))
        eng.decode_segment(2)
        eng.reset_state()
        _assert_no_leaks(eng)
        assert eng.collect_finished() == {}
        rid = eng.add_request(p, _greedy(5))
        while eng.decode_segment(4):
            pass
        np.testing.assert_array_equal(eng.collect_finished()[rid], want)
        _assert_no_leaks(eng)


class TestRequestContainment:
    def test_prefill_fault_fails_one_alone_with_parity(self, mon):
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, 100, (n,)).astype(np.int32)
                   for n in (5, 7, 4)]
        want = _oracle([prompts[0], prompts[2]], [8, 6])
        plan = FaultPlan().raise_at("prefill", nth=2)
        srv, eng, cfg = faulty_server(plan, max_batch=3, segment_steps=2)
        try:
            h1 = srv.submit(prompts[0], _greedy(8))
            h2 = srv.submit(prompts[1], _greedy(8))
            h3 = srv.submit(prompts[2], _greedy(6))
            with pytest.raises(RequestFailed, match="injected fault"):
                h2.result(timeout=WAIT)
            np.testing.assert_array_equal(h1.result(timeout=WAIT), want[0])
            np.testing.assert_array_equal(h3.result(timeout=WAIT), want[1])
            assert srv.restarts == 0 and srv.status == "ok"
            assert srv.fault_stats()["faults"] == {("request", "admit"): 1}
            assert srv.drain(timeout=WAIT)
            _assert_no_leaks(eng)
            s = monitor.snapshot()["metrics"][
                "paddle_tpu_serving_faults_total"]["samples"][0]
            assert (s["labels"]["kind"], s["labels"]["site"],
                    s["value"]) == ("request", "admit", 1)
        finally:
            srv.shutdown(drain=False)

    def test_admit_seam_fault_fails_one_alone(self):
        plan = FaultPlan().raise_at("admit", nth=1)
        srv, eng, cfg = faulty_server(plan, max_batch=2, segment_steps=2)
        try:
            h1 = srv.submit(np.arange(4, dtype=np.int32), _greedy(4))
            with pytest.raises(RequestFailed, match="injected fault"):
                h1.result(timeout=WAIT)
            h2 = srv.submit(np.arange(5, dtype=np.int32), _greedy(4))
            assert len(h2.result(timeout=WAIT)) == 4
            assert srv.drain(timeout=WAIT)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown(drain=False)

    def test_chunk_fault_fails_long_request_alone(self, mon):
        rng = np.random.RandomState(2)
        long_p = rng.randint(0, 100, (20,)).astype(np.int32)
        short_p = rng.randint(0, 100, (4,)).astype(np.int32)
        want = _oracle([short_p], [6])[0]
        plan = FaultPlan().raise_at("chunk", nth=2)
        srv, eng, cfg = faulty_server(
            plan, max_batch=2, num_pages=24, page_size=8, max_pages=8,
            prefill_chunk=8, segment_steps=2)
        try:
            hl = srv.submit(long_p, _greedy(6))
            hs = srv.submit(short_p, _greedy(6))
            with pytest.raises(RequestFailed, match="injected fault"):
                hl.result(timeout=WAIT)
            np.testing.assert_array_equal(hs.result(timeout=WAIT), want)
            assert srv.fault_stats()["faults"] == {("request", "chunk"): 1}
            assert srv.drain(timeout=WAIT)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown(drain=False)


class TestEngineRecovery:
    def test_decode_fault_recovers_with_identical_tokens(self, mon):
        rng = np.random.RandomState(3)
        p1 = rng.randint(0, 100, (6,)).astype(np.int32)
        p2 = rng.randint(0, 100, (9,)).astype(np.int32)
        want = _oracle([p1, p2], [10, 7])
        plan = FaultPlan().raise_at(
            "decode", nth=2, exc=EngineFault("injected device loss"))
        srv, eng, cfg = faulty_server(plan, max_batch=2, segment_steps=2,
                                      restart_backoff_s=0.01)
        try:
            h1 = srv.submit(p1, _greedy(10))
            h2 = srv.submit(p2, _greedy(7))
            np.testing.assert_array_equal(h1.result(timeout=WAIT), want[0])
            np.testing.assert_array_equal(h2.result(timeout=WAIT), want[1])
            assert srv.restarts == 1
            fs = srv.fault_stats()
            assert fs["faults"] == {("engine", "decode"): 1}
            assert len(fs["recovery_s"]) == 1
            assert fs["degraded"] is None and srv.status == "ok"
            assert h1._replays <= 1 and h2._replays <= 1
            h3 = srv.submit(p1, _greedy(3))
            assert len(h3.result(timeout=WAIT)) == 3
            assert srv.drain(timeout=WAIT)
            _assert_no_leaks(eng)
            snap = monitor.snapshot()["metrics"]
            assert snap["paddle_tpu_serving_restarts_total"]["samples"][0][
                "value"] == 1
            assert "paddle_tpu_serving_recovery_seconds" in snap
            ev = {s["labels"]["event"]: s["value"] for s in
                  snap["paddle_tpu_requests_total"]["samples"]}
            assert ev["engine_reset"] == 1
        finally:
            srv.shutdown(drain=False)

    def test_sampled_replay_continues_its_stream(self):
        """A sampled request draws by a hash of (seed, position), so after
        a restart its replay continues on the SAME stream: its tokens equal
        a fault-free run's (the reference's replay moves to a fresh noise
        stream instead)."""
        cfg = GenerationConfig(max_new_tokens=12, do_sample=True,
                               temperature=1.5, seed=7)
        p = np.arange(1, 8, dtype=np.int32)
        srv, _, _ = faulty_server(None, max_batch=2, segment_steps=2)
        try:
            want = srv.submit(p, cfg).result(timeout=WAIT)
        finally:
            srv.shutdown(drain=False)
        plan = FaultPlan().raise_at("decode", nth=3,
                                    exc=EngineFault("device loss"))
        srv, eng, _ = faulty_server(plan, max_batch=2, segment_steps=2,
                                    restart_backoff_s=0.01)
        try:
            h = srv.submit(p, cfg)
            np.testing.assert_array_equal(h.result(timeout=WAIT), want)
            assert srv.restarts == 1 and h._replays == 1
        finally:
            srv.shutdown(drain=False)

    def test_engine_fault_during_admission_replays_request(self):
        plan = FaultPlan().raise_at(
            "admit", nth=1, exc=EngineFault("admission device loss"))
        srv, eng, cfg = faulty_server(plan, max_batch=2, segment_steps=2,
                                      restart_backoff_s=0.01)
        try:
            h = srv.submit(np.arange(5, dtype=np.int32), _greedy(4))
            assert len(h.result(timeout=WAIT)) == 4
            assert srv.restarts == 1
            assert h._replays == 1
            assert srv.drain(timeout=WAIT)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown(drain=False)

    def test_chunked_replay_rides_chunked_admission(self):
        rng = np.random.RandomState(4)
        long_p = rng.randint(0, 100, (20,)).astype(np.int32)
        want = _oracle([long_p], [10])[0]
        plan = FaultPlan().raise_at(
            "decode", nth=5, exc=EngineFault("mid-decode loss"))
        srv, eng, cfg = faulty_server(
            plan, max_batch=2, num_pages=24, page_size=8, max_pages=8,
            prefill_chunk=8, segment_steps=2, restart_backoff_s=0.01)
        try:
            h = srv.submit(long_p, _greedy(10))
            np.testing.assert_array_equal(h.result(timeout=WAIT), want)
            assert srv.restarts == 1
            assert h._replays == 1
            assert srv.drain(timeout=WAIT)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown(drain=False)

    def test_replay_budget_fails_request_server_survives(self):
        plan = FaultPlan().raise_at(
            "decode", nth=1, times=2, exc=EngineFault("flaky device"))
        srv, eng, cfg = faulty_server(plan, max_batch=2, segment_steps=2,
                                      max_replays=1,
                                      restart_backoff_s=0.01)
        try:
            h = srv.submit(np.arange(5, dtype=np.int32), _greedy(6))
            with pytest.raises(RequestFailed,
                               match="exceeded its replay budget"):
                h.result(timeout=WAIT)
            assert srv.restarts == 2
            h2 = srv.submit(np.arange(4, dtype=np.int32), _greedy(3))
            assert len(h2.result(timeout=WAIT)) == 3
            assert srv.status in ("ok", "draining")
            assert srv.drain(timeout=WAIT)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown(drain=False)

    def test_rebuild_failure_fails_inflight_never_hangs(self):
        """``reset_state()`` itself raising during recovery (what a sticky
        CUDA error does) fails the handles in flight, loudly, with the
        rebuild's cause; nothing hangs."""
        plan = FaultPlan().raise_at(
            "decode", nth=1, exc=EngineFault("device loss"))
        srv, eng, cfg = faulty_server(plan, max_batch=2, segment_steps=2,
                                      restart_backoff_s=0.01)
        try:
            def broken_rebuild():
                raise RuntimeError("rebuild also failed")
            eng.reset_state = broken_rebuild
            h = srv.submit(np.arange(4, dtype=np.int32), _greedy(6))
            with pytest.raises(RequestFailed, match="rebuild"):
                h.result(timeout=WAIT)
            assert srv.status == "failed"
            assert srv.fault_stats()["degraded"] is None
            assert ("engine", "reset") in srv.fault_stats()["faults"]
        finally:
            srv.shutdown(drain=False)

    def test_admission_engine_fault_with_zero_restarts_terminal(self):
        plan = FaultPlan().raise_at(
            "admit", nth=1, exc=EngineFault("admission device loss"))
        srv, eng, cfg = faulty_server(plan, max_batch=2, segment_steps=2,
                                      max_restarts=0)
        try:
            h = srv.submit(np.arange(4, dtype=np.int32), _greedy(4))
            with pytest.raises(RequestFailed, match="scheduler died"):
                h.result(timeout=WAIT)
            assert srv.status == "failed"
        finally:
            srv.shutdown(drain=False)

    def test_chunked_replay_ignores_admission_deadline(self):
        plan = FaultPlan().raise_at(
            "decode", nth=3, exc=EngineFault("mid-decode loss"))
        srv, eng, cfg = faulty_server(
            plan, max_batch=2, num_pages=24, page_size=8, max_pages=8,
            prefill_chunk=8, segment_steps=2, warmup=True,
            restart_backoff_s=1.0)
        try:
            assert srv.wait_ready(timeout=WAIT)
            h = srv.submit(np.arange(12, dtype=np.int32) % 97,
                           _greedy(8), timeout_s=0.8)
            assert len(h.result(timeout=WAIT)) == 8
            assert srv.restarts == 1
            assert h._replays == 1
        finally:
            srv.shutdown(drain=False)

    def test_restart_budget_falls_through_to_fatal(self):
        plan = FaultPlan().raise_at(
            "decode", nth=1, times=1000,
            exc=EngineFault("persistent device loss"))
        srv, eng, cfg = faulty_server(plan, max_batch=2, segment_steps=2,
                                      max_restarts=1, max_replays=100,
                                      restart_backoff_s=0.01)
        try:
            h = srv.submit(np.arange(4, dtype=np.int32), _greedy(6))
            with pytest.raises(RequestFailed, match="scheduler died"):
                h.result(timeout=WAIT)
            assert srv.status == "failed"
            assert srv.restarts == 1
            assert srv.wait_ready(timeout=10)
            with pytest.raises(RequestRejected,
                               match="scheduler died") as ei:
                srv.submit(np.arange(3, dtype=np.int32), _greedy(2))
            assert ei.value.reason == "shutdown"
        finally:
            srv.shutdown(drain=False)


class TestStallWatchdog:
    def test_timeout_below_idle_heartbeat_rejected(self):
        model, _ = tiny_model()
        eng = paged_engine(model)
        with pytest.raises(ValueError, match="idle_wait_s"):
            Server(eng, idle_wait_s=0.02, stall_timeout_s=0.03, start=False)
        with pytest.raises(ValueError, match="> 0"):
            Server(eng, stall_timeout_s=0, start=False)

    def test_hang_flips_healthz_degraded_then_recovers(self, mon):
        plan = FaultPlan().hang_at("decode", nth=1, seconds=60)
        srv, eng, cfg = faulty_server(plan, max_batch=2, segment_steps=2,
                                      stall_timeout_s=0.2)
        httpd = serve_http(srv)
        port = httpd.server_address[1]

        def healthz():
            try:
                with urlopen(f"http://127.0.0.1:{port}/healthz",
                             timeout=10) as r:
                    return r.status, json.load(r)
            except HTTPError as e:
                return e.code, json.load(e)

        try:
            h = srv.submit(np.arange(4, dtype=np.int32), _greedy(4))
            deadline = time.monotonic() + 30
            code = body = None
            while time.monotonic() < deadline:
                code, body = healthz()
                if body["status"] == "degraded":
                    break
                time.sleep(0.02)
            assert body["status"] == "degraded", body
            assert code == 503
            assert ("stall", "loop") in srv.fault_stats()["faults"]
            deg = monitor.snapshot()["metrics"][
                "paddle_tpu_serving_degraded"]["samples"][0]
            assert deg["value"] == 1
            with pytest.raises(RequestRejected, match="degraded") as ei:
                srv.submit(np.arange(3, dtype=np.int32), _greedy(2))
            assert ei.value.reason == "degraded"
            with pytest.raises(HTTPError) as he:
                urlopen(Request(f"http://127.0.0.1:{port}/generate",
                                data=json.dumps({"prompt": [1, 2],
                                                 "max_new_tokens": 2})
                                .encode()), timeout=10)
            assert he.value.code == 503
            assert json.load(he.value)["reason"] == "degraded"
            plan.release_hangs()
            assert len(h.result(timeout=WAIT)) == 4
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                code, body = healthz()
                if body["status"] == "ok":
                    break
                time.sleep(0.02)
            assert body["status"] == "ok" and code == 200
        finally:
            plan.release_hangs()
            httpd.shutdown()
            srv.shutdown(drain=False)


class TestHTTPSatellites:
    def test_client_disconnect_reclaims_slot_and_pages(self):
        import http.client
        srv, eng, cfg = faulty_server(None, max_batch=2, segment_steps=2,
                                      max_pages=512)
        httpd = serve_http(srv)
        port = httpd.server_address[1]
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=60)
            conn.request("POST", "/generate", json.dumps(
                {"prompt": [3, 1, 4], "max_new_tokens": 4000,
                 "stream": True}), {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert b"token" in resp.readline()
            conn.sock.close()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if (eng.free_slots() == eng.max_batch
                        and eng.alloc.free_pages == eng.num_pages):
                    break
                time.sleep(0.02)
            _assert_no_leaks(eng)
            h = srv.submit(np.arange(3, dtype=np.int32), _greedy(3))
            assert len(h.result(timeout=WAIT)) == 3
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False)

    def test_failed_server_healthz_503_and_reject(self):
        plan = FaultPlan().raise_at("decode", nth=1, exc=EngineFault("boom"))
        srv, eng, cfg = faulty_server(plan, max_batch=2, segment_steps=2,
                                      max_restarts=0)
        httpd = serve_http(srv)
        port = httpd.server_address[1]
        try:
            h = srv.submit(np.arange(4, dtype=np.int32), _greedy(4))
            with pytest.raises(RequestFailed):
                h.result(timeout=WAIT)
            assert srv.status == "failed"
            with pytest.raises(HTTPError) as ei:
                urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10)
            assert ei.value.code == 503
            body = json.load(ei.value)
            assert body["status"] == "failed" and body["restarts"] == 0
            with pytest.raises(HTTPError) as ei:
                urlopen(Request(f"http://127.0.0.1:{port}/generate",
                                data=json.dumps({"prompt": [1],
                                                 "max_new_tokens": 2})
                                .encode()), timeout=10)
            assert ei.value.code == 503
            err = json.load(ei.value)
            assert err["reason"] == "shutdown"
            assert "scheduler died" in err["error"]
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False)


class TestWarmupLifecycle:
    def test_shutdown_during_warmup_returns_promptly(self):
        srv, eng, cfg = faulty_server(None, max_batch=2, segment_steps=2,
                                      warmup=True)
        try:
            h = srv.submit(np.arange(4, dtype=np.int32), _greedy(4))
            srv.shutdown(drain=False, timeout=WAIT)
            assert srv.wait_ready(timeout=10)
            assert srv.status == "stopped"
            assert h.done and h.status == "cancelled"
            with pytest.raises(RequestCancelled):
                h.result(timeout=10)
        finally:
            srv.shutdown(drain=False)

    def test_drain_during_warmup_completes_queued(self):
        srv, eng, cfg = faulty_server(None, max_batch=2, segment_steps=2,
                                      warmup=True)
        try:
            hs = [srv.submit(np.arange(n, dtype=np.int32) % 97, _greedy(4))
                  for n in (3, 5)]
            assert srv.drain(timeout=WAIT)
            for h in hs:
                assert h.status == "finished"
                assert len(h.result(timeout=10)) == 4
            _assert_no_leaks(eng)
        finally:
            srv.shutdown(drain=False)


def _monitor_report():
    spec = importlib.util.spec_from_file_location(
        "monitor_report", os.path.join(os.path.dirname(__file__), "..",
                                       "tools", "monitor_report.py"))
    mr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mr)
    return mr


class TestTooling:
    def test_monitor_report_reads_the_ports_jsonl(self, mon, tmp_path):
        """A recovered engine fault's series, written by the port's
        ``monitor.write_jsonl``, rendered by ``tools/monitor_report.py``
        unchanged: the serving view shows the fault columns and the
        engine's families."""
        plan = FaultPlan().raise_at("decode", nth=2,
                                    exc=EngineFault("injected"))
        srv, raw, _ = faulty_server(plan, segment_steps=2,
                                    restart_backoff_s=0.01)
        try:
            assert len(srv.submit(np.arange(1, 6, dtype=np.int32),
                                  _greedy(6)).result(timeout=WAIT)) == 6
            out = tmp_path / "serve.jsonl"
            assert monitor.write_jsonl(str(out)) > 0
        finally:
            srv.shutdown(drain=False)
        mr = _monitor_report()
        with open(out) as f:
            records = mr.load_jsonl(f)
        rendered = mr.render(records, serving=True)
        assert "paddle_tpu_serving_faults_total" in rendered
        assert "kind=engine" in rendered and "site=decode" in rendered
        assert "paddle_tpu_serving_restarts_total" in rendered
        assert "paddle_tpu_serving_recovery_seconds" in rendered
        assert "paddle_tpu_serving_ttft_seconds" in rendered
        # the engine's families, under the reference's names, are part
        # of the serving view
        assert "paddle_tpu_generated_tokens_total" in rendered
        assert "paddle_tpu_requests_total" in rendered
        assert "paddle_tpu_kv_admission_seconds" in rendered


class TestFlightRecorder:
    def test_engine_fault_dumps_and_names_site(self, tr):
        plan = FaultPlan().raise_at("decode", nth=2,
                                    exc=EngineFault("injected"))
        srv, raw, _ = faulty_server(plan, restart_backoff_s=0.01,
                                    segment_steps=4)
        try:
            hs = [srv.submit(np.arange(1, 7, dtype=np.int32) + i,
                             _greedy(10)) for i in range(2)]
            for h in hs:
                h.result(timeout=WAIT)
            fs = srv.fault_stats()
            assert fs["restarts"] == 1
            assert fs["flight_dumps"], "engine fault left no dump"
            path = fs["flight_dumps"][-1]
            doc = json.load(open(path))
            assert doc["otherData"]["reason"] == "engine_fault_decode"
            assert doc["otherData"]["env"]["backend"] == "cpu"
            faults = [e for e in doc["traceEvents"] if e["name"] == "fault"]
            assert faults and faults[-1]["args"]["site"] == "decode"
            assert faults[-1]["args"]["kind"] == "engine"
            inject = [e for e in doc["traceEvents"]
                      if e["name"] == "fault.injected"]
            assert inject and inject[-1]["args"]["site"] == "decode"
            httpd = serve_http(srv, port=0)
            try:
                body = json.loads(urlopen(
                    f"http://127.0.0.1:{httpd.server_address[1]}/healthz",
                    timeout=10).read())
                assert body["flight_dump"] == path
            finally:
                httpd.shutdown()
        finally:
            srv.shutdown()
        _assert_no_leaks(raw)

    def test_restart_backoff_replay_traced(self, tr):
        plan = FaultPlan().raise_at("decode", nth=2,
                                    exc=EngineFault("injected"))
        srv, raw, _ = faulty_server(plan, restart_backoff_s=0.01,
                                    segment_steps=4)
        try:
            h = srv.submit(np.arange(1, 7, dtype=np.int32), _greedy(10))
            h.result(timeout=WAIT)
            ph = [e["phase"] for e in h.timeline()]
            i = ph.index
            assert i("replay") < ph.index("admit", i("replay"))
            names = [e["phase"] for e in tracing.events()]
            assert "backoff" in names and "restart" in names \
                and "recover" in names
            j = names.index
            assert j("backoff") < j("restart") < j("recover")
            assert "engine.segment" in names and "engine.prefill" in names
        finally:
            srv.shutdown()
        _assert_no_leaks(raw)

    def test_no_dump_when_tracing_disabled(self):
        assert not tracing.enabled()
        plan = FaultPlan().raise_at("decode", nth=2,
                                    exc=EngineFault("injected"))
        srv, raw, _ = faulty_server(plan, restart_backoff_s=0.01,
                                    segment_steps=4)
        try:
            h = srv.submit(np.arange(1, 7, dtype=np.int32), _greedy(10))
            h.result(timeout=WAIT)
            fs = srv.fault_stats()
            assert fs["restarts"] == 1
            assert fs["flight_dumps"] == []
            assert h.timeline() == []
        finally:
            srv.shutdown()
        _assert_no_leaks(raw)

    def test_dying_scheduler_dumps(self, tr):
        plan = FaultPlan().raise_at("decode", nth=1, exc=EngineFault("x"))
        srv, _, _ = faulty_server(plan, segment_steps=2, max_restarts=0)
        try:
            with pytest.raises(RequestFailed):
                srv.submit(np.arange(4, dtype=np.int32),
                           _greedy(4)).result(timeout=WAIT)
            reasons = [json.load(open(p))["otherData"]["reason"]
                       for p in srv.fault_stats()["flight_dumps"]]
            assert reasons == ["engine_fault_decode", "scheduler_fatal"]
        finally:
            srv.shutdown(drain=False)


class TestControlPlaneUnit:
    """The overload control plane's host-side surface through explicit
    synthetic clocks (the same code paths a server ticks through)."""

    def test_policy_validation(self):
        with pytest.raises(ValueError, match="shed_burn"):
            ControlPolicy(shed_burn=0)
        with pytest.raises(ValueError, match="non-decreasing"):
            ControlPolicy(rung_up=(0.5, 0.4, 0.8, 0.9))
        with pytest.raises(ValueError, match="engage thresholds"):
            ControlPolicy(rung_up=(0.5, 0.9))
        with pytest.raises(ValueError, match="scale_up_depth"):
            ControlPolicy(scale_up_depth=0.2, scale_down_depth=0.5)
        with pytest.raises(ValueError, match="ControlPolicy"):
            ControlPlane(object())

    def test_shed_window_lifecycle(self):
        pol = ControlPolicy(shed_burn=2.0, shed_min_count=2,
                            tick_interval_s=0.0)
        cp = ControlPlane(pol, fast_window_s=10.0)
        stats = {"hot": {"burn_fast": 3.0, "met": 1, "missed": 3},
                 "cold": {"burn_fast": 0.1, "met": 4, "missed": 0},
                 "thin": {"burn_fast": 9.0, "met": 1, "missed": 0},
                 "idle": {"burn_fast": None}}
        dec = cp.tick(100.0, queue_depth=0, max_queue=64,
                      tenant_stats=stats)
        assert dec["shed"] == [("hot", 110.0)]
        assert cp.shed_check("hot", 104.0) == pytest.approx(6.0)
        assert cp.shed_check("cold", 104.0) is None
        assert cp.shed_check(None, 104.0) is None
        assert dec["rung"] >= 1
        assert cp.snapshot()["shed_active"] == ["hot"]
        dec = cp.tick(105.0, queue_depth=0, max_queue=64,
                      tenant_stats={"hot": stats["hot"]})
        assert dec["shed"] == []
        assert cp.shed_check("hot", 105.0) == pytest.approx(10.0)
        dec = cp.tick(116.0, queue_depth=0, max_queue=64, tenant_stats={})
        assert dec["unshed"] == ["hot"]
        assert cp.shed_check("hot", 116.5) is None

    def test_ladder_engages_immediately_disengages_one_per_dwell(self):
        cp = ControlPlane(ControlPolicy(tick_interval_s=0.0,
                                        rung_dwell_s=2.0,
                                        rung_hysteresis=0.15))
        dec = cp.tick(0.0, queue_depth=60, max_queue=64, tenant_stats=None)
        assert (dec["prev_rung"], dec["rung"]) == (0, 4)
        assert cp.snapshot()["rung_action"] == "prefix_pause"
        assert cp.tick(1.0, queue_depth=0, max_queue=64,
                       tenant_stats=None)["rung"] == 4
        rungs = [cp.tick(3.0 + 2.5 * i, queue_depth=0, max_queue=64,
                         tenant_stats=None)["rung"] for i in range(4)]
        assert rungs == [3, 2, 1, 0]

    def test_ladder_does_not_flap_inside_the_hysteresis_band(self):
        cp = ControlPlane(ControlPolicy(tick_interval_s=0.0,
                                        rung_dwell_s=1.0,
                                        rung_hysteresis=0.15))
        assert cp.tick(0.0, queue_depth=33, max_queue=64,
                       tenant_stats=None)["rung"] == 1
        for i in range(1, 12):
            depth = 26 if i % 2 else 33
            assert cp.tick(2.0 * i, queue_depth=depth, max_queue=64,
                           tenant_stats=None)["rung"] == 1
        assert cp.tick(30.0, queue_depth=8, max_queue=64,
                       tenant_stats=None)["rung"] == 0

    def test_tick_rate_limits_itself(self):
        cp = ControlPlane(ControlPolicy(tick_interval_s=1.0))
        assert cp.tick(0.0, queue_depth=0, max_queue=8,
                       tenant_stats=None) is not None
        assert cp.tick(0.5, queue_depth=0, max_queue=8,
                       tenant_stats=None) is None
        assert cp.tick(1.5, queue_depth=0, max_queue=8,
                       tenant_stats=None) is not None

    def test_degrade_cfg_and_quota_cap(self):
        """Rung 2 caps the budget on a copy; rung 3 also clears
        ``speculative`` on it."""
        cp = ControlPlane(ControlPolicy(brownout_max_new=3,
                                        tick_interval_s=0.0))
        cfg = GenerationConfig(max_new_tokens=64, temperature=0.5)
        assert cp.degrade_cfg(cfg) is cfg
        assert cp.quota_cap(4) == 4
        cp.rung = 1
        assert cp.degrade_cfg(cfg) is cfg
        assert cp.quota_cap(4) == 2 and cp.quota_cap(1) == 1
        cp.rung = 2
        out = cp.degrade_cfg(cfg)
        assert out is not cfg and out.max_new_tokens == 3
        assert out.temperature == 0.5 and cfg.max_new_tokens == 64
        cp.rung = 3
        spec = GenerationConfig(max_new_tokens=64, speculative=True,
                                draft_k=4)
        out = cp.degrade_cfg(spec)
        assert out.max_new_tokens == 3 and out.speculative is False
        assert out.draft_k == 4 and spec.speculative is True
        assert vars(out).keys() == vars(cfg).keys()
        assert cp.degrade_cfg(GenerationConfig(
            max_new_tokens=2)).max_new_tokens == 2

    def test_elastic_flap_resistance_under_oscillating_load(self):
        pol = ControlPolicy(scale_up_depth=4.0, scale_down_depth=0.5,
                            scale_signals=3, scale_cooldown_s=10.0)
        ec = ElasticController(pol, min_replicas=1, max_replicas=4)
        assert [ec.decide(float(t), routable=2,
                          queue_depth=(20 if t % 2 == 0 else 0))
                for t in range(24)] == [0] * 24

    def test_elastic_sustained_signal_fires_once_per_cooldown(self):
        pol = ControlPolicy(scale_up_depth=4.0, scale_down_depth=0.5,
                            scale_signals=3, scale_cooldown_s=10.0)
        ec = ElasticController(pol, min_replicas=1, max_replicas=4)
        assert [ec.decide(float(t), routable=2, queue_depth=20)
                for t in range(10)] == [0, 0, 1, 0, 0, 0, 0, 0, 0, 0]
        assert [ec.decide(13.0 + t, routable=3, queue_depth=30)
                for t in range(3)] == [1, 0, 0]
        assert [ec.decide(40.0 + t, routable=4, queue_depth=99)
                for t in range(4)] == [0] * 4
        down = ElasticController(pol, min_replicas=2)
        assert [down.decide(float(t), routable=2, queue_depth=0)
                for t in range(6)] == [0] * 6
        burn = ElasticController(pol, min_replicas=1, max_replicas=4)
        assert [burn.decide(float(t), routable=1, queue_depth=0,
                            burn_max=5.0) for t in range(3)] == [0, 0, 1]


class TestPenaltyBand:
    def test_aging_stays_in_band_until_window_expires(self):
        q = RequestQueue(max_size=16, age_after_s=0.01)
        now = time.monotonic()
        hot = RequestHandle(1, np.arange(3), 3, _greedy(4), priority=0,
                            tenant="hot")
        cold = RequestHandle(2, np.arange(3), 3, _greedy(4), priority=0,
                             tenant="cold")
        q.penalize("hot", 8, now + 30.0)
        q.put(hot)
        q.put(cold)
        eff = {h.id: e for e, _, h in q._heap}
        assert eff[1] == 8 and eff[2] == 0
        q.reap(now + 1.0)
        eff = {h.id: e for e, _, h in q._heap}
        assert eff[2] < 0 and eff[1] == 1
        assert q.pop_if(lambda h: True) is cold
        q.put(cold)
        q.reap(now + 31.0)
        eff = {h.id: e for e, _, h in q._heap}
        assert eff[1] < 0
        q2 = RequestQueue(max_size=4)
        h3 = RequestHandle(3, np.arange(3), 3, _greedy(4), priority=1,
                           tenant="hot")
        q2.penalize("hot", 8, now + 30.0)
        q2.put(h3)
        assert q2._heap[0][0] == 9
        q2.unpenalize("hot")
        assert q2._heap[0][0] == 1


class TestOverloadControl:
    """The control plane wired into the Server: shed 429s with
    Retry-After, their trace/metric/healthz surfaces, the shed-storm dump,
    and brownout degrading only FUTURE admissions."""

    def test_shed_rejects_with_retry_after_and_traces(self, mon, tr):
        srv, eng, _ = faulty_server(
            None, max_batch=2, segment_steps=2,
            control_policy=ControlPolicy(tick_interval_s=0.0))
        try:
            with srv.control._lock:
                srv.control._shed_until["hot"] = time.monotonic() + 300.0
            with pytest.raises(RequestRejected, match="fast-burn") as ei:
                srv.submit(np.arange(4, dtype=np.int32), _greedy(4),
                           tenant="hot")
            assert ei.value.reason == "shed"
            assert 0 < ei.value.retry_after_s <= 300.0
            h = srv.submit(np.arange(4, dtype=np.int32), _greedy(4),
                           tenant="cold")
            assert len(h.result(timeout=WAIT)) == 4
            shed_ev = [e for e in tr.events() if e["phase"] == "control.shed"]
            assert shed_ev and shed_ev[-1]["tenant"] == "hot"
            assert shed_ev[-1]["reason"] == "burn_rate"
            s = monitor.snapshot()["metrics"][
                "paddle_tpu_serving_sheds_total"]["samples"][0]
            assert (s["labels"]["tenant"], s["labels"]["reason"],
                    s["value"]) == ("hot", "burn_rate", 1)
            ctl = srv.load()["control"]
            assert ctl["sheds"] == {"hot": {"burn_rate": 1}}
            assert ctl["shed_active"] == ["hot"]
            with srv.control._lock:
                srv.control._shed_until["hot"] = time.monotonic() - 0.1
            h = srv.submit(np.arange(4, dtype=np.int32), _greedy(3),
                           tenant="hot")
            assert len(h.result(timeout=WAIT)) == 3
            assert srv.drain(timeout=WAIT)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown(drain=False)

    def test_http_429_retry_after_and_healthz_control_block(self):
        srv, eng, _ = faulty_server(None, max_batch=2, segment_steps=2,
                                    control_policy=ControlPolicy())
        httpd = serve_http(srv)
        port = httpd.server_address[1]
        try:
            with srv.control._lock:
                srv.control._shed_until["hot"] = time.monotonic() + 300.0
            body = json.dumps({"prompt": [1, 2], "max_new_tokens": 2,
                               "tenant": "hot"}).encode()
            with pytest.raises(HTTPError) as ei:
                urlopen(Request(f"http://127.0.0.1:{port}/generate",
                                data=body), timeout=10)
            assert ei.value.code == 429
            ra = ei.value.headers.get("Retry-After")
            assert ra is not None and 1 <= int(ra) <= 300
            err = json.load(ei.value)
            assert err["reason"] == "shed"
            assert 0 < err["retry_after_s"] <= 300.0
            with urlopen(f"http://127.0.0.1:{port}/healthz",
                         timeout=10) as r:
                hb = json.loads(r.read())
            assert hb["control"]["rung"] == 0
            assert hb["control"]["rung_action"] == "off"
            assert hb["control"]["sheds"]["hot"]["burn_rate"] >= 1
            assert hb["control"]["shed_active"] == ["hot"]
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False)

    def test_queue_full_429_derives_retry_after_from_depth(self):
        srv = Server(types.SimpleNamespace(max_len=64), start=False,
                     max_queue=1)
        httpd = serve_http(srv)
        port = httpd.server_address[1]
        try:
            srv.submit(np.arange(3, dtype=np.int32), _greedy(2))
            with pytest.raises(HTTPError) as ei:
                urlopen(Request(f"http://127.0.0.1:{port}/generate",
                                data=json.dumps({"prompt": [1],
                                                 "max_new_tokens": 2})
                                .encode()), timeout=10)
            assert ei.value.code == 429
            err = json.load(ei.value)
            assert err["reason"] == "queue_full"
            assert err["retry_after_s"] > 0
            assert int(ei.value.headers["Retry-After"]) >= 1
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False)

    def test_shed_storm_dumps_once_per_window(self, tr):
        srv = Server(types.SimpleNamespace(max_len=64), start=False,
                     control_policy=ControlPolicy())
        srv.SHED_STORM = 3
        try:
            for _ in range(3):
                srv._note_shed("hot", "burn_rate")
            dumps = srv.fault_stats()["flight_dumps"]
            assert len(dumps) == 1
            doc = json.load(open(dumps[0]))
            assert doc["otherData"]["reason"] == "shed_storm"
            storm = [e for e in doc["traceEvents"]
                     if e["name"] == "control.shed_storm"]
            assert storm and storm[-1]["args"]["count"] == 3
            assert len([e for e in doc["traceEvents"]
                        if e["name"] == "control.shed"]) == 3
            srv._note_shed("hot", "burn_rate")
            assert len(srv.fault_stats()["flight_dumps"]) == 1
        finally:
            srv.shutdown(drain=False)

    def test_brownout_degrades_future_admissions_only(self, tr):
        pol = ControlPolicy(brownout_max_new=3, tick_interval_s=0.0,
                            rung_dwell_s=3600.0)
        srv, eng, _ = faulty_server(None, max_batch=2, segment_steps=2,
                                    control_policy=pol)
        try:
            h1 = srv.submit(np.arange(1, 5, dtype=np.int32), _greedy(8))
            deadline = time.monotonic() + 60
            while h1.status == "queued":
                assert time.monotonic() < deadline, "never admitted"
                time.sleep(0.005)
            with srv.control._lock:
                srv.control.rung = 2
                srv.control._rung_since = time.monotonic()
            h2 = srv.submit(np.arange(2, 7, dtype=np.int32), _greedy(8))
            assert len(h1.result(timeout=WAIT)) == 8
            assert len(h2.result(timeout=WAIT)) == 3
            assert h2.cfg.max_new_tokens == 3
            assert srv.drain(timeout=WAIT)
            _assert_no_leaks(eng)
        finally:
            srv.shutdown(drain=False)

    def test_tenant_quota_defers_only_its_tenant(self):
        """A tenant at its quota defers in the queue while another
        tenant's request behind it admits."""
        srv, eng, _ = faulty_server(None, max_batch=3, segment_steps=2,
                                    tenant_quotas={"a": 1}, start=False)
        try:
            ha = [srv.submit(np.arange(1, 5, dtype=np.int32), _greedy(6),
                             tenant="a") for _ in range(2)]
            hb = srv.submit(np.arange(2, 6, dtype=np.int32), _greedy(2),
                            tenant="b")
            srv._thread.start()
            assert len(hb.result(timeout=WAIT)) == 2
            for h in ha:
                assert len(h.result(timeout=WAIT)) == 6
            # b admitted while a's second request waited for a's first
            assert hb.admit_ts < ha[0].finish_ts <= ha[1].admit_ts
        finally:
            srv.shutdown(drain=False)
