"""Speculative decoding in paddle_tpu_torch's serving front and in its
interplay with the paged engine's memory pressure, restarts and prefix
cache: the port against itself, on the CPU.

- the ``Server``'s ``draft_k`` / ``spec_mode`` / ``speculative`` knobs
  (validated as the reference's, mirrored onto an idle engine, the server's
  default opt-in copying the caller's config), warmup capturing the spec
  programs so a speculating request captures nothing;
- ``serve_http``'s ``speculative`` and ``draft_k`` fields, and brownout
  rung 3 (``spec_off``) clearing ``speculative`` at admission;
- ``paddle_tpu_spec_draft_tokens_total`` exported per engine and retired by
  ``close()``; ``spec_stats()`` holding ``emitted == slot_steps +
  accepted`` and surviving ``reset_state()``;
- a speculating request preempted mid-draft under an optimistic pool, one
  replayed through an engine restart, and one admitted warm off a cached
  prefix (copy-on-write of the shared page before its first window write)
  all give the plain engine's stream, token for token. The streams are
  held under the usual guard: every greedy choice beats the runner-up by
  at least ``MARGIN`` in the uncached forward.

Every ``Server`` is shut down in ``finally``.
"""
import json
import time
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch

from paddle_tpu_torch import (ContinuousBatchingEngine, GenerationConfig,
                              LlamaForCausalLM, PagedContinuousBatchingEngine,
                              llama_config, monitor)
from paddle_tpu_torch.inference.generation import EngineFault
from paddle_tpu_torch.serving import Server, serve_http
from paddle_tpu_torch.serving.control import ControlPolicy
from paddle_tpu_torch.testing import FaultPlan, FaultyEngine

WAIT = 120
MARGIN = 1e-4
REP = np.tile(np.array([5, 6, 7, 8], np.int32), 6)       # drafts accepted
RND = np.random.RandomState(0).randint(0, 64, (9,)).astype(np.int32)
_MODEL = []


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the tiny model's ops are
    small, and a thread pool on a machine whose cores the other test
    workers hold waits for its threads at every op (tens of times slower
    than one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model():
    """The 2-layer tiny model, seeded, built once per module."""
    if not _MODEL:
        torch.manual_seed(0)
        _MODEL.append(LlamaForCausalLM(llama_config("tiny"), device="cpu"))
    return _MODEL[0]


@pytest.fixture()
def mon():
    monitor.enable()
    monitor.reset()
    yield monitor
    monitor.reset()
    monitor.disable()


def greedy(n, **kw):
    return GenerationConfig(max_new_tokens=n, **kw)


def run(eng, prompts, configs, steps=4):
    rids = [eng.add_request(p, c) for p, c in zip(prompts, configs)]
    while eng.decode_segment(steps):
        pass
    done = eng.collect_finished()
    return [np.asarray(done[r]).tolist() for r in rids]


def paged(**kw):
    base = dict(max_batch=2, num_pages=24, page_size=8, max_pages=8,
                debug_pages=True)
    return PagedContinuousBatchingEngine(model(), **{**base, **kw})


def plain_streams(prompts, n):
    """The plain paged engine's greedy streams, checked for near-ties."""
    outs = run(paged(num_pages=32, max_pages=16), prompts,
               [greedy(n)] * len(prompts))
    for p, s in zip(prompts, outs):
        seq = np.concatenate([p, s[:-1]]).astype(np.int64)
        with torch.no_grad():
            logits = model()(torch.from_numpy(seq)[None])[0, len(p) - 1:]
        assert logits.argmax(-1).tolist() == s
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() >= MARGIN, \
            "pinned prompt has a near-tie: pick another"
    return outs


# -- the Server's knobs -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["host", "device"])
def test_server_knobs_default_opt_in_and_no_capture_after_warmup(mode):
    """``Server(draft_k=4, spec_mode=..., speculative=True, warmup=True)``
    over an engine built without a draft window: the knobs land on the
    engine, warmup captures the mode's spec programs, and a greedy request
    that did not opt in speculates (the server's default, on a copy of its
    config) and gives the plain stream; a sampled one decodes plain. No
    capture after warmup."""
    want = plain_streams([REP], 12)[0]
    eng = paged()
    srv = Server(eng, segment_steps=3, warmup=True, draft_k=4,
                 spec_mode=mode, speculative=True)
    try:
        assert srv.wait_ready(WAIT) and srv.status == "ok"
        assert (eng.draft_k, eng.spec_mode) == (4, mode)
        spec = (("spec_step", 4) if mode == "host"
                else ("spec_device", 3, 4, "ngram"))
        assert spec in eng.programs.captures
        assert spec + ("sampled",) in eng.programs.captures
        warm = dict(eng.programs.captures)
        cfg = greedy(12)
        assert srv.submit(REP, cfg).result(timeout=WAIT).tolist() == want
        assert cfg.speculative is False          # the caller's object
        st = eng.spec_stats()
        assert st["forwards"] > 0 and st["accepted"] > 0
        assert (st["host_syncs"] == 0) is (mode == "device")
        h = srv.submit(RND, GenerationConfig(max_new_tokens=5,
                                             do_sample=True, seed=2))
        assert len(h.result(timeout=WAIT)) == 5 and not h.cfg.speculative
        assert eng.programs.captures == warm
    finally:
        srv.shutdown(drain=False)


def test_server_knob_validation():
    eng = ContinuousBatchingEngine(model(), max_batch=1, max_len=64)
    for kw, what in ((dict(draft_k=-2), "draft_k"),
                     (dict(draft_k=True), "draft_k"),
                     (dict(speculative=True), "speculative"),
                     (dict(draft_k=3, spec_mode="turbo"), "spec_mode")):
        with pytest.raises(ValueError, match=what):
            Server(eng, start=False, **kw)
    assert (eng.draft_k, eng.spec_mode) == (3, "host")   # the one that took
    srv = Server(eng, start=False, draft_k=5, spec_mode="device")
    try:
        assert (eng.draft_k, eng.spec_mode) == (5, "device")
    finally:
        srv.shutdown(drain=False)
    eng.add_request(REP[:8], greedy(4))
    for kw in (dict(draft_k=2), dict(spec_mode="host")):
        with pytest.raises(ValueError, match="idle engine"):
            Server(eng, start=False, **kw)


def test_http_speculative_fields():
    """``POST /generate`` with ``speculative`` (and a ``draft_k`` capping
    the engine's) speculates and returns the unspeculated tokens."""
    eng = paged()
    srv = Server(eng, segment_steps=2, draft_k=4)
    httpd = serve_http(srv)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"

    def post(**body):
        data = json.dumps(dict(prompt=REP.tolist(), max_new_tokens=10,
                               **body)).encode()
        with urlopen(Request(url, data=data), timeout=WAIT) as r:
            return json.load(r)["tokens"]

    try:
        plain = post()
        assert eng.spec_stats()["forwards"] == 0
        assert post(speculative=True) == plain
        n = eng.spec_stats()["proposed"]
        assert n > 0 and n % 4 == 0
        assert post(speculative=True, draft_k=2) == plain
        assert eng.spec_stats()["proposed"] > n
    finally:
        httpd.shutdown()
        srv.shutdown(drain=False)


def test_spec_off_rung_clears_speculative():
    """Brownout rung 3 clears ``speculative`` on a request's config at
    admission (the server's default opt-in included): it decodes plain;
    back at rung 0 the next one speculates again."""
    want = plain_streams([REP], 12)[0]
    eng = paged()
    pol = ControlPolicy(rung_dwell_s=1e9, tick_interval_s=0.0)
    srv = Server(eng, segment_steps=3, draft_k=4, speculative=True,
                 control_policy=pol)
    try:
        srv.control.rung = 3
        srv.control._rung_since = time.monotonic()
        h = srv.submit(REP, greedy(12))
        assert h.result(timeout=WAIT).tolist() == want
        assert h.cfg.speculative is False
        assert eng.spec_stats()["forwards"] == 0
        srv.control.rung = 0
        h = srv.submit(REP, greedy(12))
        assert h.result(timeout=WAIT).tolist() == want
        assert h.cfg.speculative is True
        assert eng.spec_stats()["forwards"] > 0
    finally:
        srv.shutdown(drain=False)


# -- accounting -------------------------------------------------------------------


def test_spec_series_exported_and_retired(mon):
    eng = ContinuousBatchingEngine(model(), max_batch=1, max_len=128,
                                   draft_k=6)
    run(eng, [REP], [greedy(16, speculative=True)])

    def mine():
        snap = monitor.snapshot()["metrics"]
        return {s["labels"]["outcome"]: s["value"] for s in snap.get(
            "paddle_tpu_spec_draft_tokens_total", {}).get("samples", [])
            if s["labels"]["engine"] == eng._monitor_engine}

    by = mine()
    st = eng.spec_stats()
    assert by == {"proposed": st["proposed"], "accepted": st["accepted"]}
    assert 0 < by["accepted"] <= by["proposed"]
    eng.close()
    assert mine() == {}


@pytest.mark.parametrize("mode", ["host", "device"])
def test_spec_stats_identity_and_reset(mode):
    eng = ContinuousBatchingEngine(model(), max_batch=2, max_len=128,
                                   draft_k=4, spec_mode=mode)
    run(eng, [REP, RND], [greedy(12, speculative=True)] * 2)
    st = eng.spec_stats()
    assert st["emitted"] == st["slot_steps"] + st["accepted"]
    assert 0.0 < st["acceptance_rate"] <= 1.0
    assert st["tokens_per_forward"] > 1.0
    eng.add_request(REP[:8], greedy(12, speculative=True))
    assert eng._spec
    eng.reset_state()
    assert eng._spec == {} and not eng.hist_len.any()
    assert eng.spec_stats() == st
    assert len(run(eng, [REP], [greedy(6, speculative=True)])[0]) == 6
    st2 = eng.spec_stats()
    assert st2["emitted"] == st2["slot_steps"] + st2["accepted"]
    assert (st2["host_syncs"] == 0) is (mode == "device")


# -- pressure, restart and the prefix cache -------------------------------------


@pytest.mark.parametrize("mode", ["host", "device"])
def test_spec_slot_preempted_mid_draft_replays_bitwise(mode):
    """Two speculating requests in an optimistic pool of 10 pages (they
    need 11 at the end): growth by the window's width preempts the younger
    one mid-draft, its replay re-admits prompt + tokens (the proposer and
    the history ring rebuilt from them), and both streams are the plain
    ones."""
    want = plain_streams([REP, REP[:20]], 24)
    eng = paged(num_pages=10, max_pages=16, admission_mode="optimistic",
                draft_k=6, spec_mode=mode)
    srv = Server(eng, segment_steps=4, max_preemptions=10, speculative=True,
                 idle_wait_s=0.005)
    try:
        hs = [srv.submit(p, greedy(24)) for p in (REP, REP[:20])]
        assert [h.result(timeout=WAIT).tolist() for h in hs] == want
        assert eng.alloc.preemptions >= 1
        assert eng.spec_stats()["accepted"] > 0
        assert srv.drain(timeout=WAIT)
    finally:
        srv.shutdown(drain=False)
    assert eng.alloc.free_pages == eng.num_pages


def test_spec_growth_accounts_window_width():
    """``grow_for_segment`` covers ``n_steps * (spec_k + 1)`` positions
    for a speculating row (its window's worst-case advance)."""
    eng = paged(max_batch=1, num_pages=16, max_pages=16,
                admission_mode="optimistic", draft_k=3)
    eng.add_request(REP[:8], greedy(40, speculative=True))
    before = eng.alloc.covered_tokens(0)          # prompt + 1 page = 16
    assert eng.grow_for_segment(4) == []
    assert eng.alloc.covered_tokens(0) >= 8 + 4 * 4 > before
    plain = paged(max_batch=1, num_pages=16, max_pages=16,
                  admission_mode="optimistic")
    plain.add_request(REP[:8], greedy(40))
    assert plain.grow_for_segment(4) == []
    assert plain.alloc.covered_tokens(0) == before


@pytest.mark.parametrize("mode", ["host", "device"])
def test_spec_slot_through_restart_replays_bitwise(mode):
    """An engine fault at the second decode segment: the restart replays
    the speculating request from prompt + tokens, and its stream is the
    plain one."""
    want = plain_streams([REP], 20)[0]
    raw = paged(draft_k=6, spec_mode=mode)
    plan = FaultPlan().raise_at("decode", nth=2, exc=EngineFault("injected"))
    srv = Server(FaultyEngine(raw, plan), segment_steps=3,
                 restart_backoff_s=0.01, speculative=True)
    try:
        assert srv.submit(REP, greedy(20)).result(
            timeout=WAIT).tolist() == want
        assert srv.restarts == 1
        assert srv.drain(timeout=WAIT)
    finally:
        srv.shutdown(drain=False)
    assert raw.free_slots() == raw.max_batch
    assert raw.alloc.free_pages == raw.num_pages


@pytest.mark.parametrize("mode", ["host", "device"])
def test_spec_warm_admission_cow_on_divergence_bitwise(mode):
    """Speculating requests admitted off cached prefixes: A's exact prompt
    again (wholly resident) and B, which shares A's first 20 tokens and
    diverges mid-page: the partial shared page is copied before the first
    window write, and every stream is the cold plain one."""
    pa = REP
    pb = np.concatenate([REP[:20], np.array([9, 9], np.int32)])
    want_a, want_b = plain_streams([pa, pb], 16)
    eng = paged(num_pages=32, prefix_cache=True, draft_k=6, spec_mode=mode)
    spec = greedy(16, speculative=True)
    assert run(eng, [pa], [spec])[0] == want_a
    assert run(eng, [pa], [spec])[0] == want_a
    assert run(eng, [pb], [spec])[0] == want_b
    assert eng.alloc.prefix_hits >= 2 and eng.alloc.cow_copies >= 1
    assert eng.spec_stats()["accepted"] > 0
    eng.alloc.check()
