"""The port's cross-process fleet on the CPU: ``RemoteReplica``,
``spawn_replica`` / ``RemoteReplicaSpec``, ``DisaggregatedFront``, the
``/kv/*`` routes and the wire seams of ``NetworkFaultPlan``.

The counterparts of the reference's ``tests/test_remote.py``,
``tests/test_wire_hardening.py`` and ``tests/test_serving_faults.py``'s
``TestNetworkFaultPlan`` and ``TestElasticFleet``, port against port (the
reference's contracts there are bitwise). Replica processes run
``python -m paddle_tpu_torch.serving.remote --device cpu`` with one
intra-op thread; the two shared by the module are spawned once. The
monolithic reference is an in-process ``Server`` over the same seeded
weights. Every Server, Router, HTTP front and process is shut down in
``finally`` or a fixture's teardown.

The port's ``/profile`` is not ported (ROADMAP A9b): where the reference
merges program ledgers across the wire, the port's replica answers 501 and
``RemoteReplica.profile`` raises naming it. Where the reference counts jit
misses after a chaos round, the port counts graph captures (none).
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import monitor, tracing
from paddle_tpu_torch.inference.generation import (
    GenerationConfig, PagedContinuousBatchingEngine)
from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
from paddle_tpu_torch.serving import (ControlPolicy, DisaggregatedFront,
                                      KVIntegrityError, RemoteReplica,
                                      RemoteReplicaSpec, ReplicaSpec,
                                      RequestFailed, Router, Server,
                                      decode_kv_payload, serve_http)
from paddle_tpu_torch.serving.remote import spawn_replica
from paddle_tpu_torch.serving import http as port_http
from paddle_tpu_torch.testing.faults import (NET_SITES, FaultPlan,
                                             NetworkFaultPlan)

CFG = llama_config("tiny", num_hidden_layers=2)
PROMPT = list(range(1, 18))        # 17 tokens -> 2 FULL blocks of 8
REPLICA_ARGS = ["--device", "cpu", "--layers", "2", "--num-pages", "32",
                "--page-size", "8", "--max-pages", "8",
                "--max-batch", "2", "--segment-steps", "2"]
REPLICA_ENV = {"OMP_NUM_THREADS": "1", "FLAGS_enable_monitor": "1"}
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_engine(layers=2, **kw):
    """The replica CLI's engine, in process: the same seeded weights."""
    kw.setdefault("max_batch", 2)
    kw.setdefault("num_pages", 32)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_pages", 8)
    kw.setdefault("prefix_cache", True)
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=layers),
                             device="cpu")
    return PagedContinuousBatchingEngine(model, **kw)


@pytest.fixture(scope="module")
def ref24():
    srv = Server(make_engine(), segment_steps=2, idle_wait_s=0.005)
    try:
        h = srv.submit(np.asarray(PROMPT, np.int32),
                       GenerationConfig(max_new_tokens=24))
        return [int(t) for t in h.result(timeout=WAIT)]
    finally:
        srv.shutdown(drain=False, timeout=30)


def _spawn():
    proc, url = spawn_replica(REPLICA_ARGS, env=REPLICA_ENV)
    return RemoteReplica(url, proc=proc)


@pytest.fixture(scope="module")
def fleet():
    """One shared pair of replica processes (prefill, decode) with equal
    seeded weights."""
    reps = []
    try:
        reps.append(_spawn())
        reps.append(_spawn())
        assert all(r.wait_ready(WAIT) for r in reps)
        yield reps[0], reps[1]
    finally:
        for r in reps:
            r.shutdown(drain=False)


def _post(url, path, body, ctype="application/json"):
    from urllib.parse import urlsplit

    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        raw = body if isinstance(body, bytes) else json.dumps(body).encode()
        conn.request("POST", path, body=raw, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        data = resp.read()
        try:
            return resp.status, json.loads(data)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return resp.status, {"raw": data}
    finally:
        conn.close()


def _greedy(n):
    return GenerationConfig(max_new_tokens=n, eos_token_id=None)


def _toks(handle, timeout=WAIT):
    return [int(t) for t in handle.result(timeout=timeout)]


def live_server(prefix=False, **kw):
    """(server, raw engine, httpd, port), one layer, ``debug_pages`` on."""
    eng = make_engine(layers=1, max_batch=3, num_pages=24,
                      prefix_cache=prefix, debug_pages=True)
    srv = Server(eng, segment_steps=2, **kw)
    httpd = serve_http(srv)
    return srv, eng, httpd, httpd.server_address[1]


def shut(reps, httpds, srvs):
    for r in reps:
        r.close()
    for h in httpds:
        h.shutdown()
    for s in srvs:
        s.shutdown(drain=False, timeout=30)


def _healthz(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _settled(eng):
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            eng.free_slots() != eng.max_batch
            or eng.alloc.free_pages + eng.alloc.cached_pages
            != eng.num_pages):
        time.sleep(0.02)
    assert eng.free_slots() == eng.max_batch
    assert eng.alloc.free_pages + eng.alloc.cached_pages == eng.num_pages
    eng.alloc.check()


# -- the replica process -------------------------------------------------------

class TestReplicaProcess:
    def test_cuda_default_raises_without_a_card(self):
        """The CLI serves on the card unless told ``--device cpu``: here,
        without CUDA, the child dies before its ready marker and
        ``spawn_replica`` raises."""
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError, match="did not become ready"):
            spawn_replica(["--layers", "1"], env=REPLICA_ENV,
                          startup_timeout_s=60)

    def test_spec_validation(self):
        with pytest.raises(ValueError, match="exactly one"):
            RemoteReplicaSpec()
        with pytest.raises(ValueError, match="exactly one"):
            RemoteReplicaSpec(args=[], url="http://127.0.0.1:1")


def test_kernel_launches_collector_reads_the_counts():
    """``paddle_tpu_kernel_launches`` is ``ops.launch_counts()`` at
    collect time, a graph replay's credit included."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import _launches

    def read():
        return {s["labels"]["kernel"]: s["value"] for s in monitor.snapshot()[
            "metrics"]["paddle_tpu_kernel_launches"]["samples"]}

    assert read() == {k: float(v) for k, v in ops.launch_counts().items()}
    fn = ops.KERNELS["paged_decode"]
    before = fn.launches
    try:
        _launches.credit(fn, 3)
        assert read()["paged_decode"] == before + 3
    finally:
        fn.launches = before


class TestRemoteReplicaParity:
    """The Server-shaped duck type across the wire."""

    def test_remote_submit_byte_identical(self, fleet, ref24):
        pre, _ = fleet
        h = pre.submit(np.asarray(PROMPT, np.int32), _greedy(24))
        assert _toks(h) == ref24

    def test_healthz_read_surface_is_cached(self, fleet):
        pre, _ = fleet
        snap = pre.load()
        for k in ("status", "queue_depth", "active_requests",
                  "free_slots", "free_pages", "max_len"):
            assert k in snap, k
        assert pre.status in ("ok", "draining")
        assert pre.queue.depth == snap["queue_depth"]
        assert pre.engine.max_len == snap["max_len"]
        assert pre.engine.alloc.free_pages >= 0
        assert pre.engine.prefix_cache
        assert "adapter-x" not in pre.engine.adapters

    def test_local_capacity_verdict_raises_value_error(self, fleet):
        pre, _ = fleet
        with pytest.raises(ValueError, match="max_len"):
            pre.submit(np.asarray(PROMPT, np.int32), _greedy(10_000))

    def test_kernel_launches_series_over_the_wire(self, fleet):
        """A replica's ``/metrics.json`` carries each kernel's launches in
        that process (all 0 on the CPU, where the plain versions run)."""
        from urllib.request import urlopen

        from paddle_tpu_torch import ops

        pre, _ = fleet
        with urlopen(pre.base_url + "/metrics.json", timeout=30) as r:
            snap = json.loads(r.read())["metrics"]
        got = {s["labels"]["kernel"]: s["value"] for s in
               snap["paddle_tpu_kernel_launches"]["samples"]}
        assert got == {k: 0.0 for k in ops.KERNELS}

    def test_streaming_cancel_shears_the_socket(self, fleet):
        pre, _ = fleet
        h = pre.submit(np.asarray(PROMPT, np.int32), _greedy(40))
        it = h.stream(timeout=WAIT)
        next(it)
        h.cancel()
        deadline = time.monotonic() + 30
        while not h.done and time.monotonic() < deadline:
            time.sleep(0.02)
        assert h.status == "cancelled"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            snap = pre.load()
            if (snap.get("active_requests", 1) == 0
                    and snap.get("queue_depth", 1) == 0):
                break
            time.sleep(0.05)
        assert pre.load().get("active_requests") == 0


class TestDisaggregatedHandoff:
    """prefill -> /kv/export -> /kv/import -> decode: the monolithic
    stream, idempotent, kill-tolerant."""

    def test_handoff_byte_identical_and_idempotent(self, fleet, ref24):
        pre, dec = fleet
        front = DisaggregatedFront(pre, dec)
        h = front.generate(np.asarray(PROMPT, np.int32), _greedy(24))
        assert _toks(h) == ref24
        assert front.handoffs >= 1
        out = front.ship(PROMPT)
        assert out["imported"] == 0
        assert out["deduped"] >= 1
        assert out["coverage"] == 16

    def test_export_frames_chain_hashes(self, fleet):
        from paddle_tpu_torch.inference.paged_cache import _chain_root

        pre, _ = fleet
        _toks(pre.submit(np.asarray(PROMPT, np.int32), _greedy(1)))
        payload = decode_kv_payload(pre.export_kv_raw(PROMPT))
        assert payload["coverage"] == 16 and len(payload["blocks"]) == 2
        assert payload["blocks"][0]["parent"] == _chain_root(b"").hex()
        assert payload["blocks"][1]["parent"] == payload["blocks"][0]["hash"]
        assert all(len(b["tokens"]) == 8 for b in payload["blocks"])
        assert payload["layers"][0]["k"].dtype == torch.float32

    def test_decode_kill_mid_stream_replays_on_prefill(self, fleet, ref24):
        pre, _ = fleet
        victim = _spawn()
        try:
            assert victim.wait_ready(WAIT)
            front = DisaggregatedFront(pre, victim)
            h = front.generate(np.asarray(PROMPT, np.int32), _greedy(24))
            it = h.stream(timeout=WAIT)
            got = [int(next(it)) for _ in range(4)]
            victim.proc.kill()
            got += [int(t) for t in it]
            assert got == ref24
            assert front.failovers >= 1
        finally:
            victim.shutdown(drain=False)


class TestRouterOverRemote:
    """The Router runs on the remote duck type unchanged."""

    def test_router_failover_on_process_kill(self, ref24):
        spec = RemoteReplicaSpec(args=REPLICA_ARGS, env=REPLICA_ENV)
        router = Router(spec, replicas=2, monitor_interval_s=0.1,
                        max_replica_restarts=0)
        try:
            assert router.wait_ready(WAIT)
            assert router.status == "ok"
            h = router.submit(np.asarray(PROMPT, np.int32), _greedy(24))
            it = h.stream(timeout=WAIT)
            got = [int(next(it)) for _ in range(2)]
            router._replicas[h.replica].server.proc.kill()
            got += [int(t) for t in it]
            assert got == ref24
            assert h.failovers >= 1
            assert router.load()["healthy"]
        finally:
            router.shutdown(drain=False, timeout=30)


class TestWireFormatRollup:
    """Digests across a real process boundary merge exactly."""

    @staticmethod
    def _drive(rep, n, max_new):
        for _ in range(n):
            _toks(rep.submit(np.asarray(PROMPT, np.int32), _greedy(max_new)))

    def test_latency_digest_round_trip_merge_exact(self, fleet):
        from paddle_tpu_torch.monitor.slo import LatencyDigest, fleet_rollup

        pre, dec = fleet
        self._drive(pre, 2, 8)
        self._drive(dec, 2, 16)
        s1, s2 = pre.slo.digests_dict(), dec.slo.digests_dict()
        for s in (s1, s2):
            assert "metrics" in s and "tpot" in s["metrics"], s.keys()
        out = fleet_rollup([s1, s2])
        tenant = next(iter(s1["metrics"]["tpot"]))
        d1 = LatencyDigest.from_dict(s1["metrics"]["tpot"][tenant])
        d2 = LatencyDigest.from_dict(s2["metrics"]["tpot"][tenant])
        merged = LatencyDigest.from_dict(s1["metrics"]["tpot"][tenant])
        merged.merge(d2)
        fleet_tpot = out["metrics"]["tpot"]["*"]
        assert fleet_tpot["count"] == d1.count + d2.count
        assert fleet_tpot["p99"] == round(merged.percentile(99), 6)
        if d1.percentile(99) != d2.percentile(99):
            avg = round((d1.percentile(99) + d2.percentile(99)) / 2.0, 6)
            assert fleet_tpot["p99"] != avg

    def test_rolling_tpot_p50_over_the_wire(self, fleet):
        pre, _ = fleet
        p50 = pre.slo.rolling_tpot_p50(min_count=1)
        assert p50 is None or p50 > 0

    def test_profile_is_not_ported_across_the_wire(self, fleet):
        """The program ledger is ported: a replica process started without
        ``FLAGS_enable_ledger`` answers ``/profile`` with its empty shard."""
        pre, _ = fleet
        shard = pre.profile()
        assert shard["programs"] == {} and shard["server"]

    def test_ledger_shards_merge_exactly_across_processes(self):
        """Two replica processes started with ``FLAGS_enable_ledger=1``
        serve non-empty ``/profile`` shards; the program ids agree across
        the processes (no per-process hash), every record survives the
        wire, and the merge of the two holds each shared program's
        dispatches as the sum of the shards' (``tests/test_remote.py``'s
        contract for the reference)."""
        from paddle_tpu_torch.monitor.ledger import (_ProgramRecord,
                                                     merge_profiles)

        reps = []
        try:
            for _ in range(2):
                proc, url = spawn_replica(
                    REPLICA_ARGS, env=dict(REPLICA_ENV,
                                           FLAGS_enable_ledger="1"))
                reps.append(RemoteReplica(url, proc=proc))
            assert all(r.wait_ready(WAIT) for r in reps)
            for i, rep in enumerate(reps):
                TestWireFormatRollup._drive(rep, 1 + i, 8)
            s1, s2 = (r.profile() for r in reps)
            assert s1["programs"] and s2["programs"]
            for pid, rec in s1["programs"].items():
                back = _ProgramRecord.from_dict(rec).to_dict()
                for k in ("program", "dispatches", "compiles", "flops",
                          "bytes_accessed"):
                    assert back[k] == rec[k], k
            common = set(s1["programs"]) & set(s2["programs"])
            assert {s1["programs"][p]["name"] for p in common} >= {
                "cb_prefill", "cb_segment", "cb_admit_state"}
            out = merge_profiles([s1, s2])
            for pid in common:
                assert (out["programs"][pid]["dispatches"]
                        == s1["programs"][pid]["dispatches"]
                        + s2["programs"][pid]["dispatches"])
                assert out["programs"][pid]["flops"] == \
                    s1["programs"][pid]["flops"]
        finally:
            for r in reps:
                r.shutdown(drain=False)


class TestStrictBodies:
    """Unknown keys and type confusions are a 400 naming the offender."""

    def test_kv_export_unknown_field_is_named_400(self, fleet):
        pre, _ = fleet
        status, body = _post(pre.base_url, "/kv/export",
                             {"tokens": PROMPT, "slat": ""})
        assert status == 400 and "slat" in body["error"]

    def test_kv_export_bad_tokens_is_400(self, fleet):
        pre, _ = fleet
        for bad in ([], ["a"], "nope", [True]):
            status, body = _post(pre.base_url, "/kv/export",
                                 {"tokens": bad})
            assert status == 400, bad
            assert "tokens" in body["error"]

    def test_kv_export_bad_salt_is_400(self, fleet):
        pre, _ = fleet
        status, body = _post(pre.base_url, "/kv/export",
                             {"tokens": PROMPT, "salt": 7})
        assert status == 400 and "salt" in body["error"]

    def test_kv_import_empty_and_garbage_bodies_are_400(self, fleet):
        pre, _ = fleet
        for raw in (b"", b"junk"):
            status, _ = _post(pre.base_url, "/kv/import", raw,
                              ctype="application/octet-stream")
            assert status == 400

    def test_kv_unknown_op_is_404(self, fleet):
        pre, _ = fleet
        status, _ = _post(pre.base_url, "/kv/exfiltrate", {})
        assert status == 404

    def test_generate_non_bool_stream_is_named_400(self, fleet):
        pre, _ = fleet
        status, body = _post(pre.base_url, "/generate", {
            "prompt": PROMPT, "max_new_tokens": 4, "stream": "false"})
        assert status == 400 and "stream" in body["error"]

    def test_generate_unknown_field_still_named_400(self, fleet):
        pre, _ = fleet
        status, body = _post(pre.base_url, "/generate", {
            "prompt": PROMPT, "max_new_tokens": 4, "adaptor": "x"})
        assert status == 400 and "adaptor" in body["error"]

    def test_kv_endpoints_on_incapable_server_are_permanent_400(self):
        srv = Server(make_engine(prefix_cache=False), segment_steps=2)
        httpd = serve_http(srv, port=0)
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            status, body = _post(url, "/kv/export", {"tokens": PROMPT})
            assert status == 400 and "prefix_cache" in body["error"]
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False, timeout=30)

    def test_oversized_import_is_413_at_the_shipper(self, monkeypatch):
        """A body over ``MAX_KV_BODY_BYTES`` is refused with 413 and the
        shipper sees that status (the refused body is read off the socket
        first, so a large one does not end in a reset), and the server
        serves on."""
        srv, eng, httpd, port = live_server(prefix=True)
        rep = RemoteReplica(f"http://127.0.0.1:{port}")
        monkeypatch.setattr(port_http, "MAX_KV_BODY_BYTES", 1 << 20)
        try:
            assert rep.wait_ready(WAIT)
            with pytest.raises(RuntimeError, match="/kv/import -> 413"):
                rep.import_kv_raw(b"\0" * (3 << 20))
            assert len(_toks(rep.submit(PROMPT, _greedy(4)))) == 4
            eng.alloc.check()
        finally:
            shut([rep], [httpd], [srv])


# -- the network fault plan ----------------------------------------------------

class TestNetworkFaultPlan:
    """The wire seam: bounded delay, drop, mid-stream half-close, corrupt,
    in a site namespace of its own."""

    def test_namespace_and_actions(self):
        assert set(NET_SITES) == {"generate", "kv_import"}
        plan = NetworkFaultPlan()
        plan.delay_at("generate", nth=1, seconds=0.01)
        plan.drop_at("generate", nth=2)
        plan.half_close_at("generate", nth=3, after=2)
        t0 = time.monotonic()
        assert plan.fire("generate") is None
        assert time.monotonic() - t0 >= 0.01
        with pytest.raises(ConnectionResetError, match="drop"):
            plan.fire("generate")
        assert plan.fire("generate") == {"action": "half_close", "after": 2}
        assert plan.fire("generate") is None
        assert plan.injected == [("generate", 1, "delay"),
                                 ("generate", 2, "drop"),
                                 ("generate", 3, "half_close")]
        assert plan.calls == {"generate": 4, "kv_import": 0}
        with pytest.raises(ValueError, match="unknown site"):
            plan.drop_at("decode")
        with pytest.raises(ValueError, match="unknown site"):
            FaultPlan().raise_at("generate")
        slow = NetworkFaultPlan().delay_at("kv_import", seconds=30)
        t = threading.Timer(0.05, slow.release_hangs)
        t.start()
        t0 = time.monotonic()
        slow.fire("kv_import")
        assert time.monotonic() - t0 < 5
        t.join()

    def test_corrupt_spec_fire_log_and_validation(self):
        plan = NetworkFaultPlan()
        plan.corrupt_at("kv_import", nth=1, mode="flip")
        plan.corrupt_at("generate", nth=1, mode="truncate", after=3)
        assert plan.fire("kv_import") == {
            "action": "corrupt", "mode": "flip", "after": 1}
        assert plan.fire("generate") == {
            "action": "corrupt", "mode": "truncate", "after": 3}
        assert plan.fire("generate") is None
        assert plan.injected == [("kv_import", 1, "corrupt"),
                                 ("generate", 1, "corrupt")]
        with pytest.raises(ValueError, match="mode"):
            plan.corrupt_at("generate", mode="scramble")
        with pytest.raises(ValueError, match="after"):
            plan.corrupt_at("generate", after=0)
        with pytest.raises(ValueError, match="unknown site"):
            plan.corrupt_at("decode")

    def test_drop_and_half_close_against_live_replica(self):
        """A dropped /generate is the replica-unreachable error; a
        half-close tears the stream after exactly N tokens, the handle
        resolves FAILED, and the server reclaims the request."""
        srv, eng, httpd, port = live_server()
        rep = RemoteReplica(f"http://127.0.0.1:{port}", wire_retries=0,
                            max_resumes=0)
        plan = NetworkFaultPlan()
        rep.fault_plan = plan
        try:
            assert rep.wait_ready(timeout=WAIT)
            plan.drop_at("generate", nth=1)
            with pytest.raises(RuntimeError, match="unreachable"):
                rep.submit(np.arange(4, dtype=np.int32), _greedy(4))
            h = rep.submit(np.arange(4, dtype=np.int32), _greedy(4))
            assert len(h.result(timeout=WAIT)) == 4
            plan.half_close_at("generate", nth=3, after=2)
            h = rep.submit(np.arange(4, dtype=np.int32), _greedy(6))
            with pytest.raises(RequestFailed, match="stream"):
                h.result(timeout=WAIT)
            assert len(h.tokens_so_far()) == 2
            assert plan.injected == [("generate", 1, "drop"),
                                     ("generate", 3, "half_close")]
            _settled(eng)
            plan.drop_at("kv_import", nth=1)
            with pytest.raises(ConnectionResetError):
                rep.import_kv_raw(b"\x00" * 16)
            assert plan.calls["kv_import"] == 1
        finally:
            shut([rep], [httpd], [srv])


# -- wire hardening: the chaos matrix --------------------------------------------

class TestGenerateChaos:
    def test_matrix_token_parity(self):
        """delay / drop / half-close / corrupt(flip) / corrupt(truncate)
        against a live stream land the unfaulted tokens, by retry or by
        resume, and leak no capacity."""
        srv, eng, httpd, port = live_server()
        rep = RemoteReplica(f"http://127.0.0.1:{port}")
        try:
            assert rep.wait_ready(timeout=WAIT)
            ref = _toks(rep.submit(PROMPT, _greedy(8)))
            assert len(ref) == 8

            def faulted(arm):
                plan = NetworkFaultPlan()
                arm(plan)
                rep.fault_plan = plan
                try:
                    return _toks(rep.submit(PROMPT, _greedy(8)))
                finally:
                    rep.fault_plan = None

            assert faulted(lambda p: p.delay_at(
                "generate", nth=1, seconds=0.02)) == ref
            assert faulted(lambda p: p.drop_at("generate", nth=1)) == ref
            assert rep.submit_retries == 1
            assert faulted(lambda p: p.half_close_at(
                "generate", nth=1, after=2)) == ref
            assert rep.resumes == 1
            assert faulted(lambda p: p.corrupt_at(
                "generate", nth=1, mode="flip", after=2)) == ref
            assert faulted(lambda p: p.corrupt_at(
                "generate", nth=1, mode="truncate", after=1)) == ref
            assert rep.resumes == 3
            _settled(eng)
        finally:
            shut([rep], [httpd], [srv])

    def test_resume_disabled_fails_fast(self):
        srv, _, httpd, port = live_server()
        rep = RemoteReplica(f"http://127.0.0.1:{port}", wire_retries=0,
                            max_resumes=0)
        try:
            assert rep.wait_ready(timeout=WAIT)
            plan = NetworkFaultPlan()
            plan.half_close_at("generate", nth=1, after=1)
            rep.fault_plan = plan
            h = rep.submit(PROMPT, _greedy(6))
            with pytest.raises(RequestFailed, match="stream"):
                h.result(timeout=WAIT)
            assert rep.resumes == 0
        finally:
            shut([rep], [httpd], [srv])


class TestKVChaos:
    def test_matrix_and_corrupt_never_installs(self):
        """Every kv_import fault is refused whole: the decode pool holds
        nothing after them (the clean import then installs every block,
        none dedup), the validator stays green, and a replay through a slow
        wire dedups."""
        srv_a, _, httpd_a, port_a = live_server(prefix=True)
        srv_b, eng_b, httpd_b, port_b = live_server(prefix=True)
        rep_a = RemoteReplica(f"http://127.0.0.1:{port_a}")
        rep_b = RemoteReplica(f"http://127.0.0.1:{port_b}")
        try:
            assert rep_a.wait_ready(timeout=WAIT)
            assert rep_b.wait_ready(timeout=WAIT)
            _toks(rep_a.submit(PROMPT, _greedy(1)))
            raw = rep_a.export_kv_raw(PROMPT)
            free0 = eng_b.alloc.free_pages

            def faulted(arm):
                plan = NetworkFaultPlan()
                arm(plan)
                rep_b.fault_plan = plan
                try:
                    return rep_b.import_kv_raw(raw)
                finally:
                    rep_b.fault_plan = None

            with pytest.raises(ConnectionResetError):
                faulted(lambda p: p.drop_at("kv_import", nth=1))
            with pytest.raises(KVIntegrityError):
                faulted(lambda p: p.half_close_at("kv_import", nth=1))
            with pytest.raises(KVIntegrityError, match="integrity|truncated"):
                faulted(lambda p: p.corrupt_at("kv_import", nth=1,
                                               mode="flip"))
            with pytest.raises(KVIntegrityError):
                faulted(lambda p: p.corrupt_at("kv_import", nth=1,
                                               mode="truncate"))
            assert rep_b.integrity_rejects == 3
            assert _healthz(port_b)["wire"]["integrity_rejects"] >= 2
            assert eng_b.alloc.free_pages == free0
            eng_b.alloc.check()
            out = rep_b.import_kv_raw(raw)
            assert out["imported"] == 2 and out["deduped"] == 0
            assert eng_b.alloc.free_pages == free0 - 2
            eng_b.alloc.check()
            out = faulted(lambda p: p.delay_at("kv_import", nth=1,
                                               seconds=0.02))
            assert out["imported"] == 0 and out["deduped"] == 2
            assert eng_b.alloc.free_pages == free0 - 2
            eng_b.alloc.check()
        finally:
            shut([rep_a, rep_b], [httpd_a, httpd_b], [srv_a, srv_b])


class TestIdempotentSubmit:
    def test_retried_post_single_admission(self):
        srv, eng, httpd, port = live_server()
        try:
            body = {"prompt": PROMPT, "max_new_tokens": 6, "stream": False,
                    "idem_key": "dedup-test#0"}
            s1, r1 = _post(f"http://127.0.0.1:{port}", "/generate", body)
            s2, r2 = _post(f"http://127.0.0.1:{port}", "/generate", body)
            assert s1 == 200 and s2 == 200
            assert r1["request_id"] == r2["request_id"]
            assert r1["tokens"] == r2["tokens"] and len(r1["tokens"]) == 6
            assert _healthz(port)["wire"]["idem_attaches"] == 1
            _settled(eng)
        finally:
            shut([], [httpd], [srv])

    def test_resume_miss_is_409(self):
        srv, _, httpd, port = live_server()
        try:
            status, body = _post(f"http://127.0.0.1:{port}", "/generate", {
                "prompt": PROMPT, "max_new_tokens": 4, "stream": False,
                "idem_key": "never-seen#7", "from_token": 2})
            assert status == 409 and body["reason"] == "resume_miss"
            assert _healthz(port)["wire"]["resume_misses"] == 1
        finally:
            shut([], [httpd], [srv])


class TestResumeOrdering:
    def test_resume_precedes_failover_in_trace(self):
        tracing.clear()
        tracing.enable()
        srv, _, httpd, port = live_server()
        rep = RemoteReplica(f"http://127.0.0.1:{port}")
        try:
            assert rep.wait_ready(timeout=WAIT)
            ref = _toks(rep.submit(PROMPT, _greedy(8)))
            plan = NetworkFaultPlan()
            plan.half_close_at("generate", nth=1, after=2)
            rep.fault_plan = plan
            h = rep.submit(PROMPT, _greedy(8))
            assert _toks(h) == ref
            assert rep.resumes == 1
            phases = [e["phase"] for e in tracing.events(rid=h._trace_rid)]
            assert "failover" not in phases
            assert phases.index("first_token") \
                < phases.index("wire.resume") < phases.index("finish")
            assert _healthz(port)["wire"]["idem_attaches"] == 1
        finally:
            shut([rep], [httpd], [srv])
            tracing.disable()
            tracing.clear()


class TestFrontIntegrityFallback:
    def test_reship_then_local_prefill_fallback(self):
        """A corrupt ship is re-shipped once; a corrupt re-ship decodes on
        the prefill replica (pages never travelled); past the integrity
        budget the front stops shipping."""
        srv_a, _, httpd_a, port_a = live_server(prefix=True)
        srv_b, eng_b, httpd_b, port_b = live_server(prefix=True)
        rep_a = RemoteReplica(f"http://127.0.0.1:{port_a}")
        rep_b = RemoteReplica(f"http://127.0.0.1:{port_b}")
        try:
            assert rep_a.wait_ready(timeout=WAIT)
            assert rep_b.wait_ready(timeout=WAIT)
            ref = _toks(rep_a.submit(PROMPT, _greedy(8)))
            front = DisaggregatedFront(rep_a, rep_b,
                                       max_integrity_failures=2)
            plan = NetworkFaultPlan()
            plan.corrupt_at("kv_import", nth=1, mode="flip")
            plan.corrupt_at("kv_import", nth=2, mode="truncate")
            rep_b.fault_plan = plan
            free0 = eng_b.alloc.free_pages
            assert _toks(front.generate(PROMPT, _greedy(8))) == ref
            assert front.reships == 1 and front.integrity_rejects == 2
            assert front.failovers == 0 and rep_b.integrity_rejects == 2
            assert eng_b.alloc.free_pages == free0
            eng_b.alloc.check()
            assert _toks(front.generate(PROMPT, _greedy(8))) == ref
            assert plan.calls["kv_import"] == 2
        finally:
            shut([rep_a, rep_b], [httpd_a, httpd_b], [srv_a, srv_b])


class TestZeroNewCaptures:
    def test_recovery_paths_capture_nothing(self):
        """Retry, resume, idem attach, integrity reject and re-ship are host
        work: after two clean disaggregated rounds, a chaos round adds no
        graph capture on either engine."""
        srv_a, eng_a, httpd_a, port_a = live_server(prefix=True)
        srv_b, eng_b, httpd_b, port_b = live_server(prefix=True)
        rep_a = RemoteReplica(f"http://127.0.0.1:{port_a}")
        rep_b = RemoteReplica(f"http://127.0.0.1:{port_b}")
        try:
            assert rep_a.wait_ready(timeout=WAIT)
            assert rep_b.wait_ready(timeout=WAIT)
            front = DisaggregatedFront(rep_a, rep_b)
            ref = _toks(front.generate(PROMPT, _greedy(6)))
            assert _toks(front.generate(PROMPT, _greedy(6))) == ref
            before = [dict(e.programs.captures) for e in (eng_a, eng_b)]
            plan_a = NetworkFaultPlan()
            plan_a.drop_at("generate", nth=1)
            rep_a.fault_plan = plan_a
            plan_b = NetworkFaultPlan()
            plan_b.corrupt_at("kv_import", nth=1, mode="flip")
            plan_b.half_close_at("generate", nth=1, after=1)
            rep_b.fault_plan = plan_b
            assert _toks(front.generate(PROMPT, _greedy(6))) == ref
            assert rep_a.submit_retries >= 1 and rep_b.resumes >= 1
            assert front.reships == 1
            assert [dict(e.programs.captures)
                    for e in (eng_a, eng_b)] == before
        finally:
            shut([rep_a, rep_b], [httpd_a, httpd_b], [srv_a, srv_b])


# -- the elastic fleet -------------------------------------------------------------

class TestElasticFleet:
    """Scale-down drains (never fails an in-flight handle) and parks the
    slot; scale-up revives it from its own spec; every event traced."""

    @pytest.fixture()
    def tr(self, tmp_path):
        tracing.clear()
        tracing.enable(dump_dir=str(tmp_path))
        yield tracing
        tracing.disable()
        tracing.clear()

    def test_scale_down_never_fails_inflight_then_revives(self, tr):
        spec = ReplicaSpec(lambda: make_engine(layers=1, prefix_cache=False),
                           server_kwargs={"segment_steps": 2,
                                          "idle_wait_s": 0.005})
        r = Router(spec, replicas=2, monitor_interval_s=0.05)
        try:
            assert r.wait_ready(timeout=WAIT)
            hs = [r.submit(np.arange(1, 6, dtype=np.int32), _greedy(12))
                  for _ in range(4)]
            assert r.scale_to(1, timeout=WAIT) == 1
            for h in hs:
                assert len(h.result(timeout=WAIT)) == 12
            snap = r.load()
            assert len(snap["scaled_down"]) == 1
            assert snap["replicas"][snap["scaled_down"][0]]["status"] \
                == "scaled_down"
            assert snap["status"] == "ok"
            h = r.submit(np.arange(3, dtype=np.int32), _greedy(4))
            assert len(h.result(timeout=WAIT)) == 4
            assert r.scale_to(2, timeout=WAIT) == 2
            assert r.load()["scaled_down"] == []
            hs = [r.submit(np.arange(3, dtype=np.int32), _greedy(4))
                  for _ in range(4)]
            for h in hs:
                assert len(h.result(timeout=WAIT)) == 4
            ev = [e for e in tr.events() if e["phase"] == "control.scale"]
            assert [e["action"] for e in ev] == ["down", "up"]
        finally:
            r.shutdown(drain=False, timeout=30)

    def test_elastic_knob_validation(self):
        spec = ReplicaSpec(lambda: make_engine(layers=1))
        with pytest.raises(ValueError, match="elastic"):
            Router(spec, replicas=2, elastic=object(), start=False)
        with pytest.raises(ValueError, match="elastic_interval_s"):
            Router(spec, replicas=2, elastic=ControlPolicy(),
                   elastic_interval_s=0, start=False)

    def test_router_series_with_monitor_on(self):
        """The elastic gauges land under the router's label and retire at
        shutdown."""
        monitor.enable()
        monitor.reset()
        try:
            spec = ReplicaSpec(lambda: make_engine(layers=1),
                               server_kwargs={"segment_steps": 2})
            r = Router(spec, replicas=2, monitor_interval_s=0.05)
            label = r.monitor_router
            assert r.scale_to(1, timeout=WAIT) == 1
            names = {n for n, meta in monitor.snapshot()["metrics"].items()
                     for s in meta["samples"]
                     if s["labels"].get("router") == label}
            assert {"paddle_tpu_router_replicas",
                    "paddle_tpu_router_scale_events_total"} <= names
            r.shutdown(drain=False, timeout=30)
            left = {n for n, meta in monitor.snapshot()["metrics"].items()
                    for s in meta["samples"]
                    if s["labels"].get("router") == label}
            assert not left
        finally:
            monitor.reset()
            monitor.disable()
