"""The port's replica router (``paddle_tpu_torch.serving.router``), on the
CPU: the counterparts of the reference's ``tests/test_router.py`` classes,
port against port (its contracts there are bitwise), plus one parity case
against the reference's ``Router`` and the adapter-affinity case of
``tests/test_lora_serving.py::TestRouterAffinity``.

A ``Router`` over N in-process replica Servers routes least-loaded around
unhealthy replicas, FAILS OVER a request whose replica dies or degrades
mid-stream with bitwise greedy parity (one stable rid, one uninterrupted
stream), opens / half-opens / closes per-replica circuit breakers,
supervises crashed replicas back to life with bounded exponential backoff,
and drains / rolling-restarts one replica at a time with zero failed
requests; ``Server.load()`` is the one lock-light snapshot feeding both the
router and ``/healthz``; the router's metric and trace surfaces. Every
Router and Server is shut down in ``finally``.
"""
import json
import threading
import time

import numpy as np
import pytest

import torch

from paddle_tpu_torch import monitor, tracing
from paddle_tpu_torch.inference.generation import (
    EngineFault, GenerationConfig, PagedContinuousBatchingEngine)
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.serving import (FailoverBudgetExceeded, ReplicaSpec,
                                      RequestFailed, RequestRejected,
                                      Router, Server, serve_http)
from paddle_tpu_torch.testing.faults import FaultPlan, FaultyEngine
from torch_jax_state import jax_reference_state  # noqa: F401

CFG = llama_config("tiny", num_hidden_layers=1)
PROMPT = np.arange(1, 9, dtype=np.int32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_engine(max_batch=2, num_pages=24, page_size=8, max_pages=8,
                **kw):
    # fresh model per engine, SAME seed (the default generator's): the
    # fleet's weights are bitwise equal, the property greedy failover
    # parity rides on
    return PagedContinuousBatchingEngine(
        LlamaForCausalLM(CFG, device="cpu"), max_batch=max_batch,
        num_pages=num_pages, page_size=page_size, max_pages=max_pages,
        **kw)


def make_spec(engine_factory=make_engine, **server_kw):
    server_kw.setdefault("segment_steps", 2)
    server_kw.setdefault("idle_wait_s", 0.005)
    return ReplicaSpec(engine_factory, server_kwargs=server_kw)


def faulty_fleet(n, server_kw=None, faulty_builds=None):
    """Spec whose FIRST build of each replica slot is FaultyEngine-
    wrapped (supervisor rebuilds come up clean): returns
    (spec, plans) with plans[i] the i-th build's FaultPlan."""
    plans = {}
    builds = {"n": 0}
    faulty = set(range(n) if faulty_builds is None else faulty_builds)

    def factory():
        i = builds["n"]
        builds["n"] += 1
        eng = make_engine()
        if i in faulty:
            plans[i] = FaultPlan()
            return FaultyEngine(eng, plans[i])
        return eng

    kw = dict(server_kw or {})
    kw.setdefault("max_restarts", 0)   # a killed replica DIES instead
    #                                    of recovering in place — the
    #                                    router must absorb it
    return make_spec(factory, **kw), plans


@pytest.fixture(scope="module")
def ref_server():
    """One unfaulted single-replica Server for bitwise references."""
    srv = Server(make_engine(), segment_steps=2, idle_wait_s=0.005)
    yield srv
    srv.shutdown(drain=False)


def ref_tokens(ref_server, prompt, max_new):
    h = ref_server.submit(np.asarray(prompt, np.int32),
                          GenerationConfig(max_new_tokens=max_new))
    return h.result(timeout=120).tolist()


class TestLoadSnapshot:
    """Satellite: Server.load() + /healthz unification — one lock-light
    host-side snapshot, never blocking behind the scheduler."""

    def test_load_keys_and_healthz_consume_same_snapshot(self):
        from urllib.request import urlopen

        srv = Server(make_engine(), segment_steps=2)
        try:
            snap = srv.load()
            for k in ("status", "healthy", "queue_depth",
                      "active_requests", "restarts", "free_slots",
                      "active_slots", "max_batch", "free_pages",
                      "total_pages", "occupancy"):
                assert k in snap, k
            assert snap["status"] == "ok" and snap["healthy"]
            assert snap["free_slots"] == 2 and snap["active_slots"] == 0
            httpd = serve_http(srv, port=0)
            try:
                port = httpd.server_address[1]
                with urlopen(f"http://127.0.0.1:{port}/healthz",
                             timeout=10) as r:
                    body = json.loads(r.read())
                # healthz IS the load() snapshot (fields may move
                # between reads; the SHAPE must match)
                assert set(snap) <= set(body)
                assert body["healthy"] is True
            finally:
                httpd.shutdown()
        finally:
            srv.shutdown(drain=False)

    def test_load_never_blocks_while_scheduler_holds_the_gap(self):
        """Regression: load() must stay readable while the scheduler
        thread is wedged inside a step (that is exactly when a router
        needs it to route AROUND this replica)."""
        plan = FaultPlan().hang_at("decode", nth=1, seconds=8.0)
        srv = Server(FaultyEngine(make_engine(), plan),
                     segment_steps=2, idle_wait_s=0.005)
        try:
            srv.submit(PROMPT, GenerationConfig(max_new_tokens=8))
            deadline = time.monotonic() + 30
            while plan.calls["decode"] < 1:
                assert time.monotonic() < deadline, "hang never engaged"
                time.sleep(0.005)
            t0 = time.monotonic()
            for _ in range(20):
                snap = srv.load()
            dt = time.monotonic() - t0
            assert dt < 0.5, f"20 load() reads took {dt:.3f}s mid-hang"
            assert snap["active_requests"] >= 1
        finally:
            plan.release_hangs()
            srv.shutdown(drain=False)


class TestRouterBasics:
    def test_knob_validation(self):
        with pytest.raises(ValueError, match="replicas"):
            Router(make_spec(), replicas=0, start=False)
        with pytest.raises(ValueError, match="breaker_threshold"):
            Router(make_spec(), replicas=1, breaker_threshold=0,
                   start=False)
        with pytest.raises(ValueError, match="callable"):
            ReplicaSpec("not a factory")
        with pytest.raises(ValueError, match="contradicts"):
            Router([make_spec(), make_spec()], replicas=3, start=False)

    def test_routes_and_matches_single_server(self, ref_server):
        r = Router(make_spec(), replicas=2, monitor_interval_s=0.02)
        try:
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=8))
            toks = h.result(timeout=120).tolist()
            assert toks == ref_tokens(ref_server, PROMPT, 8)
            assert h.failovers == 0
            snap = r.load()
            assert snap["status"] == "ok" and snap["healthy"]
            assert [e["status"] for e in snap["replicas"]] == ["ok",
                                                              "ok"]
            assert all(e["breaker"]["state"] == "closed"
                       for e in snap["replicas"])
        finally:
            r.shutdown(drain=False)

    def test_drained_replica_excluded_from_routing(self):
        r = Router(make_spec(), replicas=2, monitor_interval_s=0.02)
        try:
            assert r.drain(0, timeout=30)   # no in-flight work: instant
            for _ in range(2):
                h = r.submit(PROMPT, GenerationConfig(max_new_tokens=4))
                h.result(timeout=120)
                assert h.replica == 1   # replica 0 is out of rotation
            snap = r.load()
            assert snap["replicas"][0]["status"] == "draining"
            assert snap["status"] == "degraded"   # partial fleet...
            assert snap["healthy"]                # ...still serves
        finally:
            r.shutdown(drain=False)

    def test_prompt_that_can_never_fit_rejected_at_submit(self):
        r = Router(make_spec(), replicas=1, monitor_interval_s=0.02)
        try:
            with pytest.raises(ValueError, match="max_len"):
                r.submit(np.arange(1, 30, dtype=np.int32),
                         GenerationConfig(max_new_tokens=4096))
        finally:
            r.shutdown(drain=False)

    def test_heterogeneous_fleet_routes_to_the_replica_that_fits(
            self, ref_server):
        """A list of DIFFERING specs: a per-replica capacity verdict
        (ValueError from the small replica) must route the request to
        the larger one, not fail it fleet-wide; a request fitting NO
        spec still fails terminally."""
        small = make_spec(lambda: make_engine(max_pages=4))  # max_len 32
        big = make_spec()                                    # max_len 64
        r = Router([small, big], monitor_interval_s=0.02)
        try:
            # 8 + 40 = 48: over the small replica's 32, inside 64 —
            # idle-tie routing tries small first, gets the capacity
            # verdict, and lands on big
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=40))
            toks = h.result(timeout=120).tolist()
            assert h.replica == 1
            assert toks == ref_tokens(ref_server, PROMPT, 40)
            # fitting NO spec is still caught at submit (the precheck
            # uses the fleet's LARGEST max_len)
            with pytest.raises(ValueError, match="max_len"):
                r.submit(np.arange(1, 30, dtype=np.int32),
                         GenerationConfig(max_new_tokens=40))
        finally:
            r.shutdown(drain=False)


class TestFailover:
    def test_replica_killed_mid_stream_bitwise_parity(self,
                                                      ref_server):
        """THE failover contract: the serving replica dies mid-stream,
        the request migrates with its emitted prefix, the client sees
        ONE uninterrupted stream whose tokens are bitwise what an
        unfaulted run produces, and the router timeline records
        route -> failover -> route under the stable router rid."""
        spec, plans = faulty_fleet(2)
        tracing.clear()
        tracing.enable()
        r = Router(spec, replicas=2, monitor_interval_s=0.02,
                   replica_backoff_s=0.05, degraded_poll_s=0.1)
        try:
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=24))
            stream = h.stream(timeout=120)
            toks = [next(stream)]       # first token pins the replica
            first_rep = h.replica
            plans[first_rep].kill("decode")
            toks.extend(stream)         # the SAME iterator keeps going
            assert h.status == "finished"
            assert h.failovers >= 1 and h.replica != first_rep
            assert toks == ref_tokens(ref_server, PROMPT, 24)
            phases = [e["phase"] for e in h.timeline()]
            assert "route" in phases and "failover" in phases
            assert phases.index("route") < phases.index("failover") \
                < len(phases) - 1 - phases[::-1].index("route")
            # the finish rides the same router-scoped timeline
            assert phases[-1] == "finish" or "finish" in phases
        finally:
            r.shutdown(drain=False)
            tracing.disable()
            tracing.clear()

    def test_failover_budget_typed_failure(self):
        """Every replica the request lands on dies under it: past
        max_failovers the request fails with FailoverBudgetExceeded as
        its typed cause instead of migrating forever."""
        builds = {"n": 0}
        plans = {}

        def factory():
            i = builds["n"]
            builds["n"] += 1
            plans[i] = FaultPlan().kill("decode", nth=1)
            return FaultyEngine(make_engine(), plans[i])

        spec = make_spec(factory, max_restarts=0)
        r = Router(spec, replicas=2, max_failovers=0,
                   monitor_interval_s=0.02, replica_backoff_s=0.05,
                   degraded_poll_s=0.1)
        try:
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=8))
            with pytest.raises(RequestFailed) as ei:
                h.result(timeout=120)
            assert isinstance(ei.value.__cause__,
                              FailoverBudgetExceeded)
        finally:
            r.shutdown(drain=False)


class TestBreaker:
    def test_opens_after_k_failures_then_half_open_recovers(self):
        """Replica 0 faults; its Server recovers IN PLACE (the Server's
        supervised recovery) but the router has already moved on: the
        breaker OPENs at the threshold, routing avoids replica 0 while
        open (no hammering a sick replica), and after the backoff the
        next request is the HALF-OPEN probe that closes it."""
        builds = {"n": 0}
        plan = FaultPlan()   # armed mid-test, once both replicas are
        #                      warm — the warm-up traffic must not
        #                      trip it

        def factory():
            i = builds["n"]
            builds["n"] += 1
            if i == 0:
                return FaultyEngine(make_engine(), plan)
            return make_engine()

        spec = make_spec(factory, max_restarts=3,
                         restart_backoff_s=0.2)
        r = Router(spec, replicas=2, breaker_threshold=1,
                   breaker_backoff_s=2.0, monitor_interval_s=0.02,
                   degraded_poll_s=0.05)
        try:
            # warm BOTH replicas (compile off the measured path, so
            # the post-failover requests run fast inside the breaker's
            # open window): first request pins idle-tie replica 0;
            # submitting the second while it is mid-flight routes
            # least-loaded to replica 1
            wa = r.submit(PROMPT, GenerationConfig(max_new_tokens=16))
            next(wa.stream(timeout=120))
            assert wa.replica == 0
            wb = r.submit(PROMPT, GenerationConfig(max_new_tokens=4))
            wb.result(timeout=120)
            assert wb.replica == 1
            wa.result(timeout=120)
            # ONE single-shot engine fault on replica 0's next decode:
            # it degrades (in-place recovery backoff) then returns to
            # health WITHOUT a supervisor rebuild — the breaker, not
            # the supervisor, governs its re-entry
            plan.raise_at("decode", nth=plan.calls["decode"] + 1,
                          exc=lambda: EngineFault("injected"))
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=8))
            h.result(timeout=120)           # failed over to replica 1
            assert h.failovers >= 1 and h.replica == 1
            b0 = r.load()["replicas"][0]["breaker"]
            assert b0["opens"] == 1
            assert b0["state"] in ("open", "half_open")
            # while OPEN, new work avoids replica 0 even once its own
            # recovery finished (both replicas warm: this completes
            # well inside the 2s window)
            h2 = r.submit(PROMPT, GenerationConfig(max_new_tokens=4))
            h2.result(timeout=120)
            assert h2.replica == 1
            # wait out the open window AND replica 0's own recovery,
            # then the next request is the half-open probe
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                s0 = r.load()["replicas"][0]
                if (s0["status"] == "ok"
                        and s0["breaker"]["state"] != "open"):
                    break
                time.sleep(0.05)
            h3 = r.submit(PROMPT, GenerationConfig(max_new_tokens=4))
            h3.result(timeout=120)
            assert h3.replica == 0          # the probe
            assert h3.failovers == 0
            b0 = r.load()["replicas"][0]["breaker"]
            assert b0["state"] == "closed" and b0["failures"] == 0
            assert r.load()["breaker_opens"] == 1
        finally:
            r.shutdown(drain=False)


class TestProbeRelease:
    def test_cancelled_half_open_probe_frees_the_probe_slot(self):
        """Regression: a half-open probe request that ends CANCELLED
        (neither replica-success nor replica-failure) must release the
        probe slot — before the fix rep.probing stayed True forever
        and the recovered replica was never routed to again."""
        r = Router(make_spec(), replicas=1, breaker_threshold=1,
                   breaker_backoff_s=0.05, monitor_interval_s=0.02,
                   degraded_poll_s=0.05)
        try:
            rep = r._replicas[0]
            # force the breaker state machine by hand (driving a real
            # engine fault here would add seconds for no extra truth):
            # open, elapsed -> the next pick is the half-open probe
            with r._lock:
                rep.breaker = 2          # BREAKER_OPEN
                rep.open_until = 0.0     # already elapsed
                rep.opens = 1
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=32))
            deadline = time.monotonic() + 10
            while h.replica is None and time.monotonic() < deadline:
                time.sleep(0.005)
            h.cancel()                   # the probe dies a user-cancel
            deadline = time.monotonic() + 30
            while not h.done and time.monotonic() < deadline:
                time.sleep(0.005)
            assert h.status == "cancelled"
            # the probe slot is free again: the next request routes
            # (it becomes the new probe) and closes the breaker
            h2 = r.submit(PROMPT, GenerationConfig(max_new_tokens=4))
            h2.result(timeout=120)
            assert h2.replica == 0
            assert r.load()["replicas"][0]["breaker"]["state"] \
                == "closed"
        finally:
            r.shutdown(drain=False)


class TestDrainAndRollingRestart:
    def test_fleet_drain_rejects_new_work_but_finishes_inflight(self):
        """Satellite: drain rejects new work with 503 (HTTP) /
        RequestRejected(draining) while in-flight handles run to
        completion."""
        import http.client

        r = Router(make_spec(), replicas=2, monitor_interval_s=0.02)
        httpd = serve_http(r, port=0)
        try:
            port = httpd.server_address[1]
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=32))
            drained = {}

            def _drain():
                drained["ok"] = r.drain(timeout=120)

            t = threading.Thread(target=_drain, daemon=True)
            t.start()
            deadline = time.monotonic() + 10
            while not r.load()["status"] == "draining":
                assert time.monotonic() < deadline
                time.sleep(0.005)
            with pytest.raises(RequestRejected) as ei:
                r.submit(PROMPT, GenerationConfig(max_new_tokens=2))
            assert ei.value.reason == "draining"
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=30)
            conn.request("POST", "/generate", json.dumps(
                {"prompt": [1, 2, 3], "max_new_tokens": 2}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 503
            assert json.loads(resp.read())["reason"] == "draining"
            conn.close()
            t.join(timeout=120)
            assert drained.get("ok") is True
            assert h.status == "finished"
            assert len(h.tokens_so_far()) == 32
        finally:
            httpd.shutdown()
            r.shutdown(drain=False)

    def test_rolling_restart_zero_failed_requests(self):
        """Restart the whole fleet one replica at a time while
        requests keep arriving: every handle finishes, none fail —
        the fleet-level analogue of reset_state()."""
        r = Router(make_spec(), replicas=2, monitor_interval_s=0.02)
        try:
            handles = [r.submit(PROMPT,
                                GenerationConfig(max_new_tokens=16))
                       for _ in range(2)]
            done = threading.Event()

            def _traffic():
                while not done.is_set():
                    try:
                        handles.append(r.submit(
                            PROMPT, GenerationConfig(max_new_tokens=4)))
                    except RequestRejected:
                        pass    # a 1-replica window may be busy;
                        #         rejection is backpressure, not failure
                    time.sleep(0.05)

            t = threading.Thread(target=_traffic, daemon=True)
            t.start()
            try:
                assert r.rolling_restart(timeout=120)
            finally:
                done.set()
                t.join(timeout=10)
            for h in handles:
                h.result(timeout=120)      # raises on any non-finish
                assert h.status == "finished"
            snap = r.load()
            assert [e["status"] for e in snap["replicas"]] == ["ok",
                                                              "ok"]
            # deliberate restarts are counted — but NOT against the
            # supervision budget (max_replica_restarts stays whole)
            assert all(e["deliberate_restarts"] >= 1
                       for e in snap["replicas"])
            assert all(e["restarts"] == 0 for e in snap["replicas"])
        finally:
            r.shutdown(drain=False)


class TestSupervisor:
    def test_restarts_dead_replica_within_backoff_bound(self):
        """A killed replica is detected, named in fleet /healthz with
        its breaker state, and rebuilt within monitor_interval +
        backoff + build time."""
        from urllib.request import urlopen

        spec, plans = faulty_fleet(2, faulty_builds=[0])
        # 2s restart backoff: the down window must be wide enough for
        # healthz to observe the casualty before resurrection
        r = Router(spec, replicas=2, monitor_interval_s=0.02,
                   replica_backoff_s=2.0, breaker_threshold=1,
                   degraded_poll_s=0.1)
        httpd = serve_http(r, port=0)
        try:
            port = httpd.server_address[1]
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=24))
            it = h.stream(timeout=120)
            next(it)
            assert h.replica == 0      # idle tie routes to replica 0
            t_kill = time.monotonic()
            plans[0].kill("decode")
            # wait for the supervisor to DETECT the death (the victim
            # was mid-decode: its scheduler dies within one segment)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                s0 = r.load()["replicas"][0]
                if s0["status"] != "ok":
                    break
                time.sleep(0.01)
            # fleet healthz NAMES the casualty while it is down
            with urlopen(f"http://127.0.0.1:{port}/healthz",
                         timeout=10) as resp:
                body = json.loads(resp.read())
            assert resp.status == 200  # one dead replica degrades,
            #                            never fails, the fleet
            rep0 = body["replicas"][0]
            assert rep0["status"] in ("failed", "restarting",
                                      "warming")
            assert rep0["breaker"]["state"] in ("open", "half_open",
                                                "closed")
            assert body["status"] in ("degraded", "ok")
            list(it)                   # failover to 1, completes
            assert h.status == "finished" and h.replica == 1
            # ... and the supervisor brings it back within its bound
            # (poll interval + 2s backoff + engine build; generous
            # CI slack)
            deadline = t_kill + 60
            while time.monotonic() < deadline:
                s0 = r.load()["replicas"][0]
                if s0["status"] == "ok":
                    break
                time.sleep(0.05)
            assert s0["status"] == "ok", s0
            assert s0["restarts"] == 1
            # the rebuilt replica actually serves
            assert r.drain(1, timeout=30)   # push traffic to 0
            h2 = r.submit(PROMPT, GenerationConfig(max_new_tokens=4))
            h2.result(timeout=120)
            assert h2.replica == 0
        finally:
            httpd.shutdown()
            r.shutdown(drain=False)


class TestMetrics:
    def test_router_series_created_and_retired(self):
        monitor.enable()
        monitor.reset()
        try:
            spec, plans = faulty_fleet(2, faulty_builds=[0])
            r = Router(spec, replicas=2, breaker_threshold=1,
                       monitor_interval_s=0.02, replica_backoff_s=0.1,
                       degraded_poll_s=0.1)
            label = r.monitor_router
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=16))
            next(h.stream(timeout=120))
            plans[h.replica].kill("decode")
            h.result(timeout=120)
            assert h.failovers >= 1

            def router_series():
                out = []
                for name, meta in monitor.snapshot()["metrics"].items():
                    for s in meta["samples"]:
                        if s["labels"].get("router") == label:
                            out.append((name, s["labels"],
                                        s["value"]))
                return out

            series = router_series()
            names = {n for n, _, _ in series}
            assert "paddle_tpu_router_requests_total" in names
            assert "paddle_tpu_router_failovers_total" in names
            assert "paddle_tpu_router_breaker_state" in names
            fo = [v for n, lb, v in series
                  if n == "paddle_tpu_router_requests_total"
                  and lb["outcome"] == "failover"]
            assert sum(fo) >= 1
            r.shutdown(drain=False)
            assert router_series() == [], (
                "router series survived shutdown")
        finally:
            monitor.reset()
            monitor.disable()


class TestChaosAcceptance:
    """The fleet acceptance: 3 in-process replicas under seeded load,
    one replica killed mid-flight — 100% of requests complete with
    bitwise greedy parity vs unfaulted runs, fleet healthz names the
    dead replica + breaker state, the supervisor restarts it within
    its backoff bound, and a rolling restart over the live fleet
    finishes with zero failed handles."""

    def test_three_replicas_one_killed_all_complete_bitwise(
            self, ref_server):
        rng = np.random.RandomState(7)
        prompts = [rng.randint(1, 200, (int(n),)).astype(np.int32)
                   for n in rng.randint(4, 12, size=6)]
        budgets = [int(b) for b in rng.randint(8, 20, size=6)]
        refs = [ref_tokens(ref_server, p, b)
                for p, b in zip(prompts, budgets)]

        spec, plans = faulty_fleet(3)
        r = Router(spec, replicas=3, monitor_interval_s=0.02,
                   replica_backoff_s=0.25, breaker_threshold=2,
                   degraded_poll_s=0.1, max_failovers=3)
        try:
            # every first build stalls at its second decode segment until
            # released, so the victim is still mid-request when the kill
            # lands however slowly this thread runs (a loaded host)
            for plan in plans.values():
                plan.hang_at("decode", nth=2, seconds=60.0)
            handles = []
            for p, b in zip(prompts, budgets):
                handles.append(r.submit(
                    p, GenerationConfig(max_new_tokens=b)))
                time.sleep(0.02)       # seeded stagger
            # kill whichever replica serves the FIRST request, once it
            # is demonstrably mid-flight
            it = handles[0].stream(timeout=120)
            next(it)
            victim = handles[0].replica
            plans[victim].kill("decode")
            for plan in plans.values():
                plan.release_hangs()
            outs = [h.result(timeout=180).tolist() for h in handles]
            assert outs == refs, "failover broke greedy parity"
            assert sum(h.failovers for h in handles) >= 1
            # the supervisor resurrects the victim within its bound
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                sv = r.load()["replicas"][victim]
                if sv["status"] == "ok":
                    break
                time.sleep(0.05)
            assert sv["status"] == "ok" and sv["restarts"] == 1
            # rolling restart over the LIVE fleet: zero failed handles
            more = [r.submit(p, GenerationConfig(max_new_tokens=4))
                    for p in prompts[:3]]
            assert r.rolling_restart(timeout=120)
            for h in more:
                h.result(timeout=120)
                assert h.status == "finished"
            assert r.load()["status"] == "ok"
        finally:
            r.shutdown(drain=False)


class TestAgainstReference:
    def test_routed_streams_equal_the_reference_router(self):
        """The port's Router and the reference's, each over two replicas of
        the same weights (carried across), serve the same prompts: equal
        greedy streams, no failover on either."""
        from paddle_tpu.inference.generation import \
            GenerationConfig as JaxGenCfg
        from paddle_tpu.inference.generation import \
            PagedContinuousBatchingEngine as JaxEngine
        from paddle_tpu.serving import ReplicaSpec as JaxSpec
        from paddle_tpu.serving import Router as JaxRouter

        from test_torch_llama import make_pair

        _, tm, _ = make_pair(2, 2, seed=5)
        kw = dict(max_batch=2, num_pages=24, page_size=8, max_pages=8)
        state = {k: v.detach().clone() for k, v in tm.state_dict().items()}

        def port_engine():
            m = LlamaForCausalLM(llama_config(
                "tiny", num_hidden_layers=2, num_key_value_heads=2),
                device="cpu")
            m.load_state_dict(state)
            return PagedContinuousBatchingEngine(m, **kw)

        def jax_engine():
            # a model per replica: the reference's engines swap parameters
            # into their model, which replicas must not share
            return JaxEngine(make_pair(2, 2, seed=5)[0], **kw)

        rng = np.random.RandomState(3)
        prompts = [rng.randint(1, 200, (n,)).astype(np.int32)
                   for n in (5, 9, 12, 7)]
        skw = {"segment_steps": 2, "idle_wait_s": 0.005}
        jr = JaxRouter(JaxSpec(jax_engine, server_kwargs=skw), replicas=2,
                       monitor_interval_s=0.02)
        tr = Router(ReplicaSpec(port_engine, server_kwargs=skw), replicas=2,
                    monitor_interval_s=0.02)
        try:
            jh = [jr.submit(p, JaxGenCfg(max_new_tokens=10))
                  for p in prompts]
            th = [tr.submit(p, GenerationConfig(max_new_tokens=10))
                  for p in prompts]
            want = [np.asarray(h.result(timeout=120)).tolist() for h in jh]
            got = [np.asarray(h.result(timeout=120)).tolist() for h in th]
        finally:
            tr.shutdown(drain=False, timeout=30)
            jr.shutdown(drain=False, timeout=30)
        assert got == want
        assert tr.failovers == jr.failovers == 0


class TestRouterAffinity:
    def test_prefers_adapter_resident_replica(self):
        """Requests naming an adapter resident on replica 1 only route
        there, past the index-0 tie-break; base requests still route."""
        from test_torch_lora_serving import make_adapter

        def factory():
            m = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=1),
                                 device="cpu")
            return PagedContinuousBatchingEngine(
                m, max_batch=4, num_pages=64, page_size=4, max_pages=8,
                lora_capacity=3, lora_rank=4, lora_targets=("q", "v"))

        router = Router(ReplicaSpec(factory,
                                    server_kwargs={"segment_steps": 4}),
                        replicas=2)
        try:
            model = router._replicas[1].server.engine.model
            router._replicas[1].server.load_adapter(
                "aff", make_adapter(model, 171))
            for _ in range(3):
                h = router.submit(PROMPT, GenerationConfig(
                    max_new_tokens=4, adapter="aff"))
                h.result(60)
                assert h.replica == 1
            h = router.submit(PROMPT, GenerationConfig(max_new_tokens=4))
            assert len(h.result(60)) == 4
        finally:
            router.shutdown(drain=False, timeout=30)


class TestPortSurface:
    def test_profile_not_ported_and_devices_passed_through(self):
        """``Router.profile`` (ported, A9b) is the exact merge of its live
        replicas' ``Server.profile`` shards, as the reference's; a spec
        pinned to a device list hands it to its factory (one card: the same
        device for every replica)."""
        from paddle_tpu_torch.monitor import ledger

        seen = []

        def factory(devices):
            seen.append(list(devices))
            return make_engine()

        dev = [torch.device("cpu")]
        ledger.reset()
        ledger.enable()
        r = Router([ReplicaSpec(factory, devices=dev),
                    ReplicaSpec(factory, devices=dev)],
                   monitor_interval_s=0.02)
        try:
            assert seen == [dev, dev]
            h = r.submit(PROMPT, GenerationConfig(max_new_tokens=4))
            assert len(h.result(timeout=120)) == 4
            fleet = r.profile()
            shards = [rep.server.profile() for rep in r._replicas]
            want = ledger.merge_profiles(shards)
            assert fleet["replicas"] == 2
            assert fleet["programs"] and fleet["programs"] == \
                want["programs"]
            assert fleet["top"] == want["top"]
        finally:
            r.shutdown(drain=False, timeout=30)
            ledger.disable()
            ledger.reset()
        with pytest.raises(ValueError, match="non-empty"):
            ReplicaSpec(factory, devices=[])
