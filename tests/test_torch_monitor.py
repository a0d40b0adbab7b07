"""The port's host modules of the serving front against the JAX package's:
the same operations give the same bytes.

- ``monitor``: identical ``render_prometheus()`` text, ``snapshot()``
  metrics, ``write_jsonl`` records and errors for the same instrument
  operations (the metrics this test creates; the registries are
  process-wide, and the two device-memory collectors differ by design:
  allocator stats of the CUDA devices here, XLA's or the live
  ``jax.Array`` bytes there);
- the engine and serving series a ``Server`` exports over each package's
  paged engine, for one request: the same names, types, help and labels,
  and the same counts;
- ``monitor.slo``: ``SLOTracker.digests_dict()`` and ``fleet_rollup`` JSON
  equal byte for byte, and a JAX shard merges with a port shard;
- ``serving.queue``: the same ``RequestQueue`` pop order under priorities,
  aging and a penalty band;
- ``serving.control``: the same ``ControlPlane`` and ``ElasticController``
  decisions over one scripted input sequence;
- ``testing.faults``: the same ``FaultPlan`` firing schedule for one seed;
- ``tracing``: the same ``timeline(rid)`` phases (and attribute names) for
  one request through each package's ``Server``.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu.monitor as jmon
import paddle_tpu.tracing as jtrace
from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxPagedEngine
from paddle_tpu.monitor import slo as jslo
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu.serving import control as jcontrol
from paddle_tpu.serving import queue as jqueue
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import GenerationConfig, PagedContinuousBatchingEngine
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import tracing as ttrace
from paddle_tpu_torch.monitor import slo as tslo
from paddle_tpu_torch.serving import Server
from paddle_tpu_torch.serving import control as tcontrol
from paddle_tpu_torch.serving import queue as tqueue
from paddle_tpu_torch.testing import faults as tfaults

from test_torch_llama import make_pair
from torch_jax_state import jax_reference_state  # noqa: F401

PREFIX = "paddle_tpu_parity_"
DEVICE_COLLECTORS = ("paddle_tpu_hbm_bytes", "paddle_tpu_live_array_bytes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models and ops are
    tiny, and a thread pool on a machine whose cores other test workers
    hold waits for its threads at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def both_enabled():
    for m in (jmon, tmon):
        m.enable()
    yield
    for m in (jmon, tmon):
        m.disable()


def _ours(snap):
    return {k: v for k, v in snap["metrics"].items() if k.startswith(PREFIX)}


def _prom_blocks(text):
    """The exposition lines of the metrics this test made."""
    return [ln for ln in text.splitlines()
            if ln.split()[2 if ln.startswith("#") else 0].startswith(PREFIX)]


def _drive(mon):
    """One fixed script of instrument operations."""
    c = mon.counter(PREFIX + "requests_total", "requests by event",
                    ("server", "event"))
    c.labels(server="s0", event="queued").inc()
    c.labels(server="s0", event="queued").inc(2)
    c.labels(server="s1", event="failed").inc(0.5)
    mon.counter(PREFIX + "plain_total", "no labels").inc(3)
    g = mon.gauge(PREFIX + "depth", "queue \\ depth\nper server",
                  ("server",))
    g.labels(server='s"0').set(4)
    g.labels(server="s1").inc(2.5)
    g.labels(server="s1").dec()
    h = mon.histogram(PREFIX + "ttft_seconds", "ttft", ("server",))
    for v in (1e-7, 3e-4, 0.02, 0.02, 7.0, 100.0):
        h.labels(server="s0").observe(v)
    hb = mon.histogram(PREFIX + "custom_seconds", "custom buckets",
                       buckets=(0.5, 0.1, 1.0))
    for v in (0.05, 0.5, 0.75, 3.0):
        hb.observe(v)
    mon.register_callback(PREFIX + "cb_scalar", "scalar callback",
                          lambda: 7)
    mon.register_callback(PREFIX + "cb_list", "labelled callback",
                          lambda: [({"pool": "a"}, 1.0),
                                   ({"pool": "b"}, 2.5)])
    mon.register_callback(PREFIX + "cb_broken", "raises",
                          lambda: 1 / 0)
    d = mon.gauge(PREFIX + "retired", "to remove", ("engine", "bucket"))
    for e in ("engine0", "engine1"):
        for b in ("16", "32"):
            d.labels(engine=e, bucket=b).set(1)
    return mon.remove_series(PREFIX + "retired", engine="engine0")


def test_registry_exposition_equals_the_reference(both_enabled, tmp_path):
    removed = [_drive(m) for m in (jmon, tmon)]
    assert removed == [2, 2]
    js, ts = jmon.snapshot(), tmon.snapshot()
    assert _ours(js) == _ours(ts)
    assert PREFIX + "cb_broken" not in _ours(ts)
    text = _prom_blocks(tmon.render_prometheus())
    assert text == _prom_blocks(jmon.render_prometheus())
    assert f"# TYPE {PREFIX}ttft_seconds histogram" in text
    recs = []
    for m, name in ((jmon, "j.jsonl"), (tmon, "t.jsonl")):
        m.write_jsonl(str(tmp_path / name), extra={"run": "x"})
        with open(tmp_path / name) as f:
            rows = [json.loads(ln) for ln in f]
        recs.append([{k: v for k, v in r.items() if k != "ts"}
                     for r in rows if r["metric"].startswith(PREFIX)])
    assert recs[0] == recs[1] and recs[0]
    for path in ("/metrics.json", "/nope"):
        a, b = jmon.http_payload(path), tmon.http_payload(path)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[1] == b[1]
    assert jmon.http_payload("/metrics")[1] == tmon.http_payload(
        "/metrics")[1]
    for m in (jmon, tmon):
        m.reset()
    assert _ours(jmon.snapshot()) == _ours(tmon.snapshot())


@pytest.mark.parametrize("op", ["negative", "labels", "kind", "labelnames",
                                "unlabeled"])
def test_registry_errors_equal_the_reference(op):
    def run(mon):
        name = PREFIX + "err_" + op
        try:
            if op == "negative":
                mon.counter(name, "x").inc(-1)
            elif op == "labels":
                mon.counter(name, "x", ("a",)).labels(b="1")
            elif op == "kind":
                mon.counter(name, "x")
                mon.gauge(name, "x")
            elif op == "labelnames":
                mon.counter(name, "x", ("a",))
                mon.counter(name, "x", ("b",))
            else:
                mon.counter(name, "x", ("a",)).inc()
        except Exception as e:
            return type(e).__name__, str(e)
        return None
    got = run(tmon)
    assert got is not None and got == run(jmon)


def test_device_collectors_are_absent_on_the_cpu():
    """Without an initialized CUDA device the port reports neither device
    collector (the reference reports host live-array bytes there)."""
    snap = tmon.snapshot()["metrics"]
    for name in DEVICE_COLLECTORS:
        assert name not in snap
        assert name in tmon._CALLBACKS


# -- one request through each package's Server --------------------------------

ENGINE_FAMILIES = ("paddle_tpu_requests_total",
                   "paddle_tpu_generated_tokens_total",
                   "paddle_tpu_prefill_requests_total",
                   "paddle_tpu_prefill_chunks_total",
                   "paddle_tpu_kv_admission_seconds",
                   "paddle_tpu_decode_tokens_per_sec")
SERVING_FAMILIES = ("paddle_tpu_serving_requests_total",
                    "paddle_tpu_serving_queue_depth",
                    "paddle_tpu_serving_active_requests",
                    "paddle_tpu_serving_kv_pressure",
                    "paddle_tpu_serving_ttft_seconds",
                    "paddle_tpu_serving_tpot_seconds",
                    "paddle_tpu_serving_tenant_tokens_total",
                    "paddle_tpu_serving_tenant_kv_page_seconds_total")
COUNTS = ("paddle_tpu_requests_total", "paddle_tpu_generated_tokens_total",
          "paddle_tpu_prefill_requests_total",
          "paddle_tpu_prefill_chunks_total",
          "paddle_tpu_serving_requests_total",
          "paddle_tpu_serving_tenant_tokens_total")
KW = dict(max_batch=2, num_pages=16, page_size=8, max_pages=8,
          prefill_chunk=16)


@pytest.fixture(scope="module")
def served():
    """Per package: (snapshot, the request's timeline, server label,
    engine label, stats) after two requests, one of them chunked, with
    the monitor and tracing on."""
    jm, tm, _ = make_pair(1, None, seed=3)
    out = {}
    for name, mon, tr, srv_cls, eng_cls, cfg_cls, model in (
            ("jax", jmon, jtrace, JaxServer, JaxPagedEngine, JaxGenCfg, jm),
            ("port", tmon, ttrace, Server, PagedContinuousBatchingEngine,
             GenerationConfig, tm)):
        mon.enable()
        mon.reset()
        tr.enable()
        tr.clear()
        try:
            eng = eng_cls(model, **KW)
            srv = srv_cls(eng, segment_steps=4)
            try:
                hs = [srv.submit(np.arange(1, 1 + n, dtype=np.int32),
                                 cfg_cls(max_new_tokens=9), tenant="t0")
                      for n in (6, 20)]
                for h in hs:
                    assert len(h.result(timeout=300)) == 9
                out[name] = (mon.snapshot()["metrics"],
                             [h.timeline() for h in hs],
                             srv.monitor_server, eng._monitor_engine,
                             srv.stats())
            finally:
                srv.shutdown(drain=False)
        finally:
            tr.disable()
            tr.clear()
            mon.reset()
            mon.disable()
    return out


def _mine(rec, server, engine):
    """A family's samples of this server / engine, labels normalized."""
    out = []
    for s in rec["samples"]:
        lab = dict(s["labels"])
        if lab.pop("server", server) != server:
            continue
        if lab.pop("engine", engine) != engine:
            continue
        out.append((tuple(sorted(lab.items())),
                    {k: v for k, v in s.items() if k != "labels"}))
    return sorted(out, key=lambda x: x[0])


@pytest.mark.parametrize("family", ENGINE_FAMILIES + SERVING_FAMILIES)
def test_server_series_equal_the_reference(served, family):
    (js, _, jsrv, jeng, _), (ts, _, tsrv, teng, _) = (served["jax"],
                                                     served["port"])
    assert family in ts and family in js
    assert (ts[family]["type"], ts[family]["help"]) == \
        (js[family]["type"], js[family]["help"])
    jsam, tsam = _mine(js[family], jsrv, jeng), _mine(ts[family], tsrv, teng)
    assert [k for k, _ in tsam] == [k for k, _ in jsam]
    if family in COUNTS:
        assert tsam == jsam
    else:      # timings: the same number of observations
        assert [v.get("count") for _, v in tsam] == \
            [v.get("count") for _, v in jsam]


def test_timeline_phases_equal_the_reference(served):
    for jt, tt in zip(served["jax"][1], served["port"][1]):
        assert [e["phase"] for e in tt] == [e["phase"] for e in jt]
        assert [sorted(e) for e in tt] == [sorted(e) for e in jt]
        assert tt[-1]["phase"] == "finish" and tt[-1]["n_tokens"] == 9


def test_stats_shape_equals_the_reference(served):
    js, ts = served["jax"][4], served["port"][4]
    assert sorted(ts) == sorted(js)
    assert ts["tenants"]["t0"]["tokens"] == js["tenants"]["t0"]["tokens"]
    assert {m: sorted(v) for m, v in ts["metrics"].items()} == \
        {m: sorted(v) for m, v in js["metrics"].items()}


# -- SLO digests ----------------------------------------------------------------


def _feed(slo, policy_kw):
    tr = slo.SLOTracker(policy=slo.SLOPolicy(**policy_kw), window_s=10.0)
    rng = np.random.RandomState(7)
    for i in range(60):
        tenant = ("a", "b", None)[i % 3]
        ttft, tpot = float(rng.lognormal(-3, 1)), float(rng.lognormal(-5, 1))
        tr.observe("ttft", tenant, ttft)
        tr.observe("queue_wait", tenant, float(rng.uniform(0, 0.1)))
        if i % 11 == 5:
            tr.record_failure(tenant)
        else:
            tr.record_finish(tenant, ttft, tpot, ttft + 20 * tpot, 21,
                             kv_page_seconds=float(rng.uniform(0, 3)))
    return tr


def test_slo_wire_format_equals_the_reference(both_enabled):
    kw = dict(ttft_p99_s=0.1, tpot_p99_s=0.01, e2e_p99_s=0.5,
              goodput_target=0.9)
    jt, tt = _feed(jslo, kw), _feed(tslo, kw)
    jd, td = jt.digests_dict(), tt.digests_dict()
    # the rolling TPOT and the burn windows read the clock; both feeds run
    # inside one window, so the whole shards are equal
    assert json.dumps(td, sort_keys=True) == json.dumps(jd, sort_keys=True)
    assert json.dumps(tslo.fleet_rollup([td]), sort_keys=True) == \
        json.dumps(jslo.fleet_rollup([jd]), sort_keys=True)
    # a JAX shard and a port shard merge, in either package, into the
    # rollup of two JAX shards
    two = json.dumps(jslo.fleet_rollup([jd, jd]), sort_keys=True)
    assert json.dumps(tslo.fleet_rollup([jd, td]), sort_keys=True) == two
    assert json.dumps(jslo.fleet_rollup([td, jd]), sort_keys=True) == two
    d = tslo.LatencyDigest.from_dict(jslo.LatencyDigest().to_dict())
    assert d.to_dict() == jslo.LatencyDigest().to_dict()
    assert tslo.tenant_key(None) == jslo.tenant_key(None) == "-"


# -- the queue, the control plane, the fault plan -----------------------------


def _queue_order(q_mod, cfg):
    q = q_mod.RequestQueue(16, age_after_s=0.5)
    t0 = 1000.0
    handles = []
    for i, (prio, tenant, waited) in enumerate(
            [(3, "a", 0.0), (0, "b", 0.0), (0, "a", 0.2), (5, None, 4.0),
             (1, "b", 1.1), (0, "a", 0.0), (2, None, 0.0), (1, "c", 0.7)]):
        h = q_mod.RequestHandle(i, [1], 1, cfg, priority=prio,
                                tenant=tenant)
        h.submit_ts = t0 - waited
        handles.append(h)
    q.penalize("a", 4, t0 + 5.0)
    for h in handles[:6]:
        q.put(h)
    handles[2]._cancel_requested = True
    order = [h.id for h in q.reap(t0)]
    for h in handles[6:]:
        q.put(h)
    order.append(q.pop_if(lambda h: True).id)
    order.append(q.pop_admittable(lambda h: True,
                                  lambda h: h.tenant != "b").id)
    q.unpenalize("a")
    q.reap(t0 + 1.0)
    while q.depth:
        order.append(q.pop_if(lambda h: True).id)
    return order


def test_queue_pop_order_equals_the_reference():
    got = _queue_order(tqueue, GenerationConfig(max_new_tokens=2))
    assert got == _queue_order(jqueue, JaxGenCfg(max_new_tokens=2))
    assert sorted(got) == list(range(8))


def _control_decisions(c_mod):
    pol = c_mod.ControlPolicy(shed_burn=2.0, shed_min_count=2,
                              tick_interval_s=0.5, rung_dwell_s=2.0,
                              brownout_max_new=4)
    cp = c_mod.ControlPlane(pol, fast_window_s=8.0)
    out = []
    script = [(0.0, 10, None), (0.2, 60, None),
              (1.0, 60, {"x": {"burn_fast": 3.0, "met": 1, "missed": 4}}),
              (2.0, 30, {"x": {"burn_fast": 1.0, "met": 3, "missed": 1}}),
              (4.5, 12, None), (7.0, 2, {}), (9.6, 0, {}), (12.1, 0, {}),
              (14.7, 50, {"y": {"burn_fast": 9.0, "met": 0,
                                "missed": 9}}), (30.0, 0, {})]
    for now, depth, stats in script:
        dec = cp.tick(now, queue_depth=depth, max_queue=64,
                      tenant_stats=stats)
        out.append((dec, cp.snapshot(), cp.shed_check("x", now),
                    cp.quota_cap(6)))
    ec = c_mod.ElasticController(pol, min_replicas=1, max_replicas=3)
    out.append([ec.decide(float(t), routable=1 + t % 2,
                          queue_depth=(30 if t < 9 else 0),
                          burn_max=(0.0 if t % 5 else 3.0))
                for t in range(30)])
    out.append(c_mod.max_burn({"a": {"burn_fast": 1.5},
                               "b": {"burn_fast": None}}))
    return out


def test_control_plane_decisions_equal_the_reference():
    got = _control_decisions(tcontrol)
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        _control_decisions(jcontrol), sort_keys=True, default=str)
    assert tcontrol.RUNG_ACTIONS == jcontrol.RUNG_ACTIONS


def _fault_schedule(f_mod):
    plan = f_mod.FaultPlan()
    plan.random_raises(["decode", "admit"], rate=0.3, seed=11)
    plan.raise_at("collect", nth=3, times=2)
    plan.hang_at("chunk", nth=2, seconds=0.0)
    plan.release_hangs()
    log = []
    for i in range(120):
        site = ("decode", "admit", "collect", "chunk", "prefill")[i % 5]
        try:
            plan.fire(site)
            log.append((site, None))
        except Exception as e:
            log.append((site, type(e).__name__, str(e)))
    return log, plan.injected, plan.calls


def test_fault_plan_schedule_equals_the_reference():
    got = _fault_schedule(tfaults)
    assert got == _fault_schedule(jfaults)
    assert tfaults.SITES == jfaults.SITES
    assert sum(1 for _, n, a in got[1] if a == "raise") > 10


@pytest.mark.parametrize("flag,mod", [("FLAGS_enable_monitor", tmon),
                                      ("FLAGS_enable_trace", ttrace)])
def test_set_flags_pushes_to_the_module(flag, mod):
    """``set_flags`` switches the monitor and the trace ring, as the
    reference's does; ``enable()``/``disable()`` go through the flag."""
    from paddle_tpu_torch import get_flags, set_flags

    try:
        set_flags({flag: True})
        assert mod.enabled() and get_flags(flag)[flag] is True
        mod.disable()
        assert not mod.enabled() and get_flags(flag)[flag] is False
        mod.enable()
        assert mod.enabled()
    finally:
        set_flags({flag: False})
    assert not mod.enabled()


def test_engine_close_retires_its_series():
    """``close()`` drops the engine's per-instance series (its tokens/s
    gauge and the prefill families labelled with it), as the reference's
    does; the unlabelled totals stay."""
    _, tm, _ = make_pair(1, None, seed=3)
    tmon.enable()
    try:
        eng = PagedContinuousBatchingEngine(tm, **KW)
        eng.serve([np.arange(1, 20, dtype=np.int32)],
                  GenerationConfig(max_new_tokens=9), segment_steps=4)
        label = eng._monitor_engine

        def mine():
            snap = tmon.snapshot()["metrics"]
            return sorted(n for n in ("paddle_tpu_decode_tokens_per_sec",
                                      "paddle_tpu_prefill_requests_total",
                                      "paddle_tpu_prefill_chunks_total")
                          for smp in snap.get(n, {}).get("samples", [])
                          if smp["labels"].get("engine") == label)
        # serve() admits one-shot (19 tokens, bucket 32): no chunk series
        assert mine() == ["paddle_tpu_decode_tokens_per_sec",
                          "paddle_tpu_prefill_requests_total"]
        eng.close()
        eng.close()                       # idempotent
        assert mine() == []
        assert tmon.snapshot()["metrics"][
            "paddle_tpu_generated_tokens_total"]["samples"]
    finally:
        tmon.reset()
        tmon.disable()
