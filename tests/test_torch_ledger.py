"""The program ledger and the profile surface of paddle_tpu_torch, on the CPU,
held against ``paddle_tpu.monitor.ledger`` and ``tests/test_ledger.py``:

- (a) ``_derived``, ``profile``'s shape and ``merge_profiles`` of the two
  modules give equal outputs on identical wire records and peaks;
- (b) the reference's ``TestProgramId``, ``TestLedgerRecord``,
  ``TestOwnership``, ``TestProfileMerge`` and ``TestPeaksAndProvenance``,
  port against port (a program id computed in another process equals this
  one's);
- (c) the reference's mixed-feature run (chunked prefill, a prefix hit,
  speculative decoding, int8 pools, LoRA) through the JAX ``Server`` and the
  port's on the same weights: the same program names with the same
  dispatches, every program costed, compiled once, its dispatch counter
  equal to its record, ``load()["profile"]``, and nothing left after
  ``close()`` (the ``tests/test_monitor.py`` retirement contract);
- (d) the FLOPs of the tiny model's ``cb_prefill`` at one bucket against
  the analytic count; (e) each kernel wrapper's reported cost against an
  independent formula, the plain version's ops adding nothing;
- (f) ``GET /profile`` and ``tools/monitor_report.py``'s ``render_profile``.

Torch runs on one intra-op thread; every ``Server`` is shut down in
``finally`` and every wait has a timeout.
"""
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import (GenerationConfig, LlamaForCausalLM,
                              PagedContinuousBatchingEngine, llama_config,
                              monitor, ops)
from paddle_tpu_torch.device import peaks as peaks_mod
from paddle_tpu_torch.inference._graphs import GraphCache
from paddle_tpu_torch.monitor import _programs, ledger
from paddle_tpu_torch.serving import Server, serve_http
from torch_jax_state import jax_reference_state  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
WAIT = 120


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def led():
    """The port's monitor and ledger armed for one test, swept after."""
    monitor.enable()
    monitor.reset()
    ledger.reset()
    ledger.enable()
    yield ledger
    ledger.disable()
    ledger.reset()
    monitor.reset()
    monitor.disable()


def _series(name):
    """{program label: value} of one of the port's ledger series."""
    out = {}
    m = monitor.snapshot()["metrics"].get(name)
    for s in (m or {}).get("samples", []):
        out[s["labels"].get("program", "?")] = s.get("value")
    return out


def _mm_program(cache, key=("mm", 8)):
    """A GraphCache program on the CPU: one matmul at ``key``'s width."""
    n = key[1]
    x = torch.full((n, n), 0.5)
    out = torch.empty(n, n)
    return lambda: cache.run(key, lambda: torch.mm(x, x, out=out))


def _cache(owner=None, name="lg_mm"):
    return GraphCache("cpu", names={"mm": name}, owner=owner)


# ---------------------------------------------------------------- (a)


def _wire(name, flops, byts, obs, compiles=1, dispatches=None):
    """One wire record built through the port's own record type."""
    rec = ledger._ProgramRecord(ledger.program_id(name, (1,)), name, "sig")
    rec.flops, rec.bytes_accessed = flops, byts
    rec.compiles, rec.compile_seconds = compiles, 0.25
    for v in obs:
        rec.digest.observe(v)
    rec.dispatches = len(obs) + compiles if dispatches is None \
        else dispatches
    rec.owners_seen = {"e0"}
    return rec.to_dict()


PEAKS = {"device_kind": "NVIDIA H100 80GB HBM3", "platform": "gpu",
         "peak_flops": 989.4e12, "peak_bytes_per_s": 3.35e12,
         "machine_balance": 989.4e12 / 3.35e12, "source": "table"}


def test_derived_profile_and_merge_equal_the_reference():
    from paddle_tpu.monitor import ledger as ref

    recs = [_wire("cb_segment", 3.2e12, 1.1e11, [0.07, 0.071, 0.069]),
            _wire("cb_prefill", 4.0e11, 2.0e9, [0.03]),
            _wire("cb_admit_state", 0.0, 1084.0, [2e-5, 3e-5]),
            _wire("lm_decode", None, None, [0.001])]
    for d in recs:
        assert ledger._derived(d, PEAKS) == ref._derived(d, PEAKS)
        assert ledger._derived(d, None) == ref._derived(d, None)
    shard = {"programs": {d["program"]: ledger._derived(d, PEAKS)
                          for d in recs}, "peaks": PEAKS}
    other = {"programs": {recs[0]["program"]: _wire(
        "cb_segment", 3.2e12, 1.1e11, [0.2, 0.0701])}, "peaks": PEAKS}
    shards = [shard, None, other]
    assert ledger.merge_profiles(shards) == ref.merge_profiles(shards)
    assert ledger.merge_profiles(shards, top_k=2) == \
        ref.merge_profiles(shards, top_k=2)
    # profile(): the same records in both ledgers, the same peaks
    saved = (ref._records.copy(), ref._owners.copy(), ref._peaks,
             ledger._peaks)
    try:
        ref._records.clear()
        ref._owners.clear()
        ledger.reset()
        ref._peaks = ledger._peaks = PEAKS
        for d in recs:
            for mod in (ref, ledger):
                mod._records[d["program"]] = \
                    mod._ProgramRecord.from_dict(d)
                mod._owners[d["program"]] = {"e0"}
        for kw in ({}, {"top_k": 2}, {"owners": ["e0"]},
                   {"owners": ["e1"]}, {"derived": False}):
            assert ledger.profile(**kw) == ref.profile(**kw), kw
    finally:
        ref._records.clear()
        ref._records.update(saved[0])
        ref._owners.clear()
        ref._owners.update(saved[1])
        ref._peaks, ledger._peaks = saved[2], saved[3]
        ledger.reset()


# ---------------------------------------------------------------- (b)


class TestProgramId:
    def test_stable_and_distinct(self):
        pid = ledger.program_id("f", ("segment", 8), "sig")
        assert pid == ledger.program_id("f", ("segment", 8), "sig")
        assert pid.startswith("f:") and len(pid) == len("f:") + 8
        assert ledger.program_id("f", ("segment", 4), "sig") != pid
        assert ledger.program_id("g", ("segment", 8), "sig") != pid
        assert ledger.program_id("f", ("segment", 8), "sig2") != pid
        assert ledger.program_id("f", ("segment", 8, "sampled"),
                                 "sig") != pid

    def test_same_id_in_another_process(self):
        """blake2b, never Python's salted hash(): a replica process computes
        the id this process does."""
        code = ("import sys; sys.path.insert(0, %r); from paddle_tpu_torch"
                ".monitor import ledger; print(ledger.program_id("
                "'cb_segment', ('segment', 8), 'sig'))" % str(ROOT))
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONHASHSEED="12345"))
        assert out.stdout.strip() == ledger.program_id(
            "cb_segment", ("segment", 8), "sig")

    def test_engine_programs_get_their_ids(self, led):
        cache = _cache(owner="lg_e0")
        for n in (8, 4):
            _mm_program(cache, ("mm", n))()
        pids = {ledger.program_id("lg_mm", ("mm", n)) for n in (8, 4)}
        assert pids == set(ledger.profile()["programs"])


class TestLedgerRecord:
    def test_compile_then_dispatch(self, led):
        run = _mm_program(_cache(owner="lg_e0"), ("mm", 16))
        for _ in range(4):
            run()                       # the first run is the compile
        prof = ledger.profile()
        (pid,) = list(prof["programs"])
        rec = prof["programs"][pid]
        assert rec["name"] == "lg_mm"
        assert rec["compiles"] == 1 and rec["dispatches"] == 4
        assert rec["compile_seconds"] > 0
        assert rec["flops"] == 2 * 16 ** 3
        # mm reads x twice and writes out: 3 x 16 x 16 fp32 elements
        assert rec["bytes_accessed"] == 3 * 16 * 16 * 4
        assert rec["summary"]["count"] == 3     # the compile is not in it
        assert rec["intensity"] > 0 and rec["achieved_flops_per_s"] > 0
        assert 0 <= rec["mfu"] <= 1.0
        assert rec["bound"] in ("memory-bound", "compute-bound")

    def test_series_match_dispatches(self, led):
        run = _mm_program(_cache(owner="lg_e0"))
        for _ in range(5):
            run()
        (pid,) = list(ledger.profile()["programs"])
        assert _series(ledger.DISPATCH_COUNTER)[pid] == 5
        assert _series(ledger.SECONDS_COUNTER)[pid] >= 0
        assert pid in _series(ledger.MFU_GAUGE)
        miss = {s["labels"]["program"]: s["value"] for s in monitor.snapshot(
            )["metrics"]["paddle_tpu_jit_cache_miss_total"]["samples"]}
        assert miss.get(pid) == 1

    def test_eager_program_counts_its_first_dispatch(self, led):
        x = torch.ones(8, 8)
        for _ in range(3):
            monitor.monitored_eager("lg_eager", torch.mm, x, x,
                                    owner="lg_e0", key=(8,))
        (rec,) = ledger.profile()["programs"].values()
        assert (rec["compiles"], rec["dispatches"]) == (1, 3)
        assert rec["flops"] == 2 * 8 ** 3
        assert rec["arg_bytes"] == 2 * 8 * 8 * 4
        assert rec["output_bytes"] == 8 * 8 * 4
        assert rec["donated_bytes"] is None

    def test_disabled_is_invisible(self):
        ledger.disable()
        ledger.reset()
        _mm_program(_cache())()
        monitor.monitored_eager("lg_eager", torch.mm, torch.ones(2, 2),
                                torch.ones(2, 2))
        assert ledger.profile()["programs"] == {}

    def test_captured_before_the_ledger_keeps_no_cost(self, led):
        """A program first seen after its key was built is never given a
        guessed cost."""
        ledger.disable()
        run = _mm_program(_cache())
        run()
        ledger.enable()
        run()
        (rec,) = ledger.profile()["programs"].values()
        assert rec["flops"] is None and rec["compiles"] == 0
        assert rec["dispatches"] == 1


class TestOwnership:
    def test_release_scoped(self, led):
        for owner, name in (("lg_a", "lg_fa"), ("lg_b", "lg_fb"),
                            (None, "lg_fn")):
            _mm_program(_cache(owner, name))()
        assert len(ledger.profile()["programs"]) == 3
        assert len(ledger.owned_programs("lg_a")) == 1
        assert ledger.release("lg_a") == 1
        progs = ledger.profile()["programs"]
        assert {r["name"] for r in progs.values()} == {"lg_fb", "lg_fn"}
        assert ledger.owned_programs("lg_a") == []
        assert set(_series(ledger.DISPATCH_COUNTER)) == set(progs)

    def test_coowned_survives_single_release(self, led):
        _mm_program(_cache("lg_a", "lg_sh"))()
        (pid,) = list(ledger.profile()["programs"])
        ledger.record(pid, "lg_sh", "lg_b", 1e-4, False)
        assert ledger.release("lg_a") == 0
        assert pid in ledger.profile()["programs"]
        assert ledger.release("lg_b") == 1
        assert ledger.profile()["programs"] == {}


class TestProfileMerge:
    def test_owner_filter_and_top_k(self, led):
        _mm_program(_cache("lg_a", "lg_fa"))()
        _mm_program(_cache("lg_b", "lg_fb"))()
        only_a = ledger.profile(owners=["lg_a"])
        assert {r["name"] for r in only_a["programs"].values()} == {"lg_fa"}
        prof = ledger.profile(top_k=1)
        assert len(prof["top"]) == 1 and len(prof["programs"]) == 2
        assert prof["peaks"]["peak_flops"] > 0

    def test_merge_is_exact(self, led):
        run = _mm_program(_cache(name="lg_m"))
        for _ in range(3):
            run()
        shard = ledger.profile()
        merged = ledger.merge_profiles([shard, shard, None, {}])
        (pid,) = list(merged["programs"])
        rec, one = merged["programs"][pid], shard["programs"][pid]
        assert rec["dispatches"] == 2 * one["dispatches"]
        assert rec["compiles"] == 2 * one["compiles"]
        assert rec["summary"]["count"] == 2 * one["summary"]["count"]
        assert rec["summary"]["max"] == one["summary"]["max"]
        assert rec["flops"] == one["flops"]
        assert merged["peaks"] == shard["peaks"]


class TestPeaksAndProvenance:
    def test_cpu_calibration_record(self):
        pk = peaks_mod.peaks()
        assert pk["platform"] == "cpu" and pk["source"] == "calibrated"
        assert pk["peak_flops"] > 0 and pk["peak_bytes_per_s"] > 0
        assert pk["machine_balance"] == pytest.approx(
            pk["peak_flops"] / pk["peak_bytes_per_s"])

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "123e12")
        pk = peaks_mod.peaks(refresh=True)
        assert pk["peak_flops"] == pytest.approx(123e12)
        assert pk["source"] == "env"
        monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS")
        assert peaks_mod.peaks(refresh=True)["peak_flops"] != \
            pytest.approx(123e12)

    def test_table_row_by_device_name(self, monkeypatch):
        """A card in the table takes its datasheet row; none creates a
        CUDA context to read it (an uninitialized card gives a provisional
        record, not cached)."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        pk = peaks_mod.peaks(refresh=True)
        assert pk["source"] == "fallback" and peaks_mod._cache is not pk
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a: "NVIDIA H100 80GB HBM3")
        pk = peaks_mod.peaks(refresh=True)
        assert (pk["platform"], pk["source"]) == ("gpu", "table")
        assert (pk["peak_flops"], pk["peak_bytes_per_s"]) == (989.4e12,
                                                              3.35e12)
        monkeypatch.undo()
        assert peaks_mod.peaks(refresh=True)["platform"] == "cpu"


# ---------------------------------------------------------------- (c)


def _make_adapter(model, seed, targets=("q", "v"), rank=2, scale=0.6):
    _, shapes = model.lora_shapes(targets)
    rng = np.random.default_rng(seed)
    return {t: (rng.standard_normal((rank, d_in)).astype(np.float32)
                * scale,
                rng.standard_normal((d_out, rank)).astype(np.float32)
                * scale)
            for t, (d_in, d_out) in shapes.items()}


def _mixed_run(server, model, shared, gen_cfg):
    """The reference's acceptance traffic: two long prompts (chunked, the
    second a prefix hit), a speculating one, one under the adapter, then
    the same mix again, warmed. Returns the streams."""
    def gen(**kw):
        return gen_cfg(max_new_tokens=6, eos_token_id=None, **kw)

    waves = [[(np.concatenate([shared, shared[:4]]), gen()),
              (np.concatenate([shared, shared[2:6]]), gen()),
              (shared[:6], gen(speculative=True, draft_k=4)),
              (shared[:8], gen(adapter="la"))],
             [(np.concatenate([shared, shared[:4]]), gen()),
              (shared[:6], gen(speculative=True, draft_k=4)),
              (shared[:8], gen(adapter="la"))]]
    out = []
    for wave in waves:
        hs = [server.submit(p, c) for p, c in wave]
        out += [[int(t) for t in h.result(timeout=WAIT)] for h in hs]
    return out


ENGINE_KW = dict(max_batch=4, num_pages=64, page_size=4, max_pages=16,
                 prefill_chunk=8, prefix_cache=True, kv_dtype="int8",
                 draft_k=4, lora_capacity=2, lora_rank=2,
                 lora_targets=("q", "v"))
# where the port's program boundaries differ from the reference's (none on
# this traffic: the paged install is a program in neither; the dense
# engine's one-shot admission has no cb_admit, and CausalLMEngine's
# lm_decode is a step, not a call; neither runs here)
BOUNDARIES = {}


def test_acceptance_mixed_feature_run(led):
    import paddle_tpu.monitor as jmon
    from paddle_tpu.inference.generation import GenerationConfig as JCfg
    from paddle_tpu.inference.generation import \
        PagedContinuousBatchingEngine as JEngine
    from paddle_tpu.monitor import ledger as jled
    from paddle_tpu.serving import Server as JServer
    from test_torch_llama import make_pair

    jm, tm, cfg = make_pair(1, None, seed=0)
    shared = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (12,)).astype(np.int32)
    adapter = _make_adapter(tm, 7)

    jmon.enable()
    jmon.reset()
    jled.reset()
    jled.enable()
    je = JEngine(jm, debug_pages=True, **ENGINE_KW)
    je.load_adapter("la", adapter)
    js = JServer(je, segment_steps=2)
    try:
        want = _mixed_run(js, jm, shared, JCfg)
        jprof = js.profile()
    finally:
        js.shutdown()
        je.close()
        jled.disable()
        jled.reset()
        jmon.reset()
        jmon.disable()

    eng = PagedContinuousBatchingEngine(tm, debug_pages=True, **ENGINE_KW)
    eng.load_adapter("la", adapter)
    srv = Server(eng, segment_steps=2)
    try:
        got = _mixed_run(srv, tm, shared, GenerationConfig)
        prof = srv.profile()
        load = srv.load()
        counter = _series(ledger.DISPATCH_COUNTER)
    finally:
        srv.shutdown()
        eng.close()
    assert got == want

    def per_name(p):
        out = {}
        for rec in p["programs"].values():
            out[rec["name"]] = out.get(rec["name"], 0) + rec["dispatches"]
        return out

    names, jnames = per_name(prof), per_name(jprof)
    assert set(names) == set(jnames)
    assert {n: d for n, d in names.items() if n not in BOUNDARIES} == \
        {n: d for n, d in jnames.items() if n not in BOUNDARIES}
    # the copies, fills and masked fills that move data with no arithmetic
    # (the reference's XLA count gives them its index arithmetic)
    data_movement = {"cb_admit_state", "cb_reset_scales", "lora_install"}
    for pid, rec in prof["programs"].items():
        assert rec["compiles"] >= 1, rec["name"]
        assert rec["bytes_accessed"] > 0, rec["name"]
        if rec["name"] in data_movement:
            assert rec["flops"] == 0.0, rec["name"]
        else:
            assert rec["flops"] > 0, rec["name"]
        assert counter[pid] == rec["dispatches"], rec["name"]
    assert load["profile"]["programs"] == len(prof["programs"])
    assert load["profile"]["top"]
    # the engine's close retired its programs and their series
    assert ledger.profile()["programs"] == {}
    assert _series(ledger.DISPATCH_COUNTER) == {}
    assert _series(ledger.SECONDS_COUNTER) == {}


def test_dense_and_offline_engines_name_their_programs(led):
    """The dense engine and ``CausalLMEngine`` register the reference's
    names. Where the boundaries differ: the dense one-shot admission
    prefills into its slot's rows (no ``cb_admit``; a chunked admission's
    install is one), and ``lm_decode`` is ``generate``'s step graph, one
    dispatch a token, where the reference's is one scan a call;
    ``CausalLMEngine``'s programs are ownerless, as the reference's."""
    from paddle_tpu_torch import CausalLMEngine, ContinuousBatchingEngine

    torch.manual_seed(0)
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=1),
                             device="cpu")
    eng = ContinuousBatchingEngine(model, max_batch=2, max_len=64,
                                   prefill_chunk=16)
    try:
        eng.serve([np.arange(1, 8, dtype=np.int32),
                   np.arange(1, 30, dtype=np.int32)],
                  GenerationConfig(max_new_tokens=4), segment_steps=2)
        adm = eng.begin_admit(np.arange(1, 30, dtype=np.int32),
                              GenerationConfig(max_new_tokens=2))
        while not eng.admit_chunk(adm):
            pass
        names = {}
        for r in ledger.profile(owners=[eng._monitor_engine])[
                "programs"].values():
            names[r["name"]] = names.get(r["name"], 0) + r["dispatches"]
    finally:
        eng.close()
    assert names["cb_admit"] == 1          # the chunked admission only
    assert set(names) == {"cb_prefill", "cb_prefill_chunk", "cb_admit",
                          "cb_admit_state", "cb_segment"}
    gen = CausalLMEngine(model, max_batch=1, max_len=64, prefill_chunk=16)
    gen.generate(np.arange(1, 9, dtype=np.int32)[None],
                 GenerationConfig(max_new_tokens=5))
    gen.generate(np.arange(1, 30, dtype=np.int32)[None],
                 GenerationConfig(max_new_tokens=3))
    gen.generate_speculative(np.arange(1, 9, dtype=np.int32)[None],
                             GenerationConfig(max_new_tokens=6), draft_k=2)
    lm = {}
    for r in ledger.profile()["programs"].values():
        if r["name"].startswith("lm_"):
            assert r["owners"] == []
            lm[r["name"]] = lm.get(r["name"], 0) + r["dispatches"]
    assert lm["lm_decode"] == 4 + 2          # one dispatch a token
    assert lm["lm_prefill_chunk"] == 2 and lm["lm_prefill"] == 2
    assert lm["lm_spec_verify"] >= 1


# ---------------------------------------------------------------- (d), (e)


def _causal_pairs(sq, sk):
    return sum(max(0, min(sk, i + 1 + sk - sq)) for i in range(sq))


def test_prefill_flops_equal_the_analytic_count(led):
    """``cb_prefill`` at one bucket: 2 T x (every linear's parameters, the
    LM head's included) for the T rows it projects, plus K1's, K2's and
    K3's analytic counts."""
    torch.manual_seed(0)
    cfg = llama_config("tiny", num_hidden_layers=2, num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device="cpu")
    eng = PagedContinuousBatchingEngine(model, max_batch=2, num_pages=16,
                                        page_size=8, max_pages=8)
    try:
        eng.add_request(np.arange(1, 12, dtype=np.int32),
                        GenerationConfig(max_new_tokens=2))
        (rec,) = [r for r in ledger.profile()["programs"].values()
                  if r["name"] == "cb_prefill"]
    finally:
        eng.close()
    T = 16                                  # the bucket of 11 tokens
    H, L, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    linears = L * (H * hq * d + 2 * H * hkv * d + hq * d * H
                   + 3 * H * cfg.intermediate_size) + H * V
    k1 = (2 * L + 1) * 4 * T * H
    k2 = L * 3 * T * (hq + hkv) * d
    k3 = L * 4 * d * _causal_pairs(T, T) * hq
    assert rec["flops"] == 2 * T * linears + k1 + k2 + k3


def _reported(fn, *args, **kwargs):
    """(FLOPs, bytes) a call adds to a program's count."""
    _, cost = _programs.count_cost(lambda: fn(*args, **kwargs))
    return cost["flops"], cost["bytes_accessed"]


@pytest.mark.parametrize("shape", [(1, 16, 64), (2, 5, 128), (3, 1, 96)])
def test_norm_and_rope_costs(shape):
    b, s, h = shape
    x = torch.randn(b, s, h, dtype=torch.bfloat16)
    w = torch.ones(h, dtype=torch.float32)
    n = x.numel()
    assert _reported(ops.rms_norm, x, w) == (4 * n, 2 * n * 2 + h * 4)
    xr = x.reshape(b, s, h // 16, 16)
    c, sn = torch.randn(s, 8), torch.randn(s, 8)
    assert _reported(ops.fused_rope, xr, c, sn) == (
        3 * n, 2 * n * 2 + 2 * s * 8 * 4)
    g = torch.randn(h)
    assert _reported(ops.fused_layer_norm, x, x, None, g, g) == (
        8 * n, 2 * n * 2 + n * 2 + 2 * h * 4)


@pytest.mark.parametrize("sq,sk,hkv,causal", [(16, 16, 4, True),
                                              (5, 33, 2, True),
                                              (12, 7, 4, False)])
def test_flash_costs(sq, sk, hkv, causal):
    b, hq, d = 2, 4, 16
    q = torch.randn(b, sq, hq, d)
    k, v = torch.randn(b, sk, hkv, d), torch.randn(b, sk, hkv, d)
    pairs = _causal_pairs(sq, sk) if causal else sq * sk
    f, by = _reported(ops.flash_attention_bshd, q, k, v, causal)
    assert f == 4 * d * pairs * hq * b
    assert by == (2 * q.numel() + k.numel() + v.numel()) * 4 \
        + b * hq * sq * 4
    out, lse = ops.flash_attention_bshd(q, k, v, causal)
    do = torch.randn_like(out)
    f, by = _reported(ops.flash_attention_bwd, q, k, v, out, lse, do,
                      causal)
    io = (q.numel() + k.numel() + v.numel() + do.numel()) * 4 \
        + 2 * lse.numel() * 4
    # K5's and K6's costs, once: the plain backward's ops add nothing
    assert f == 14 * d * pairs * hq * b
    assert by == 2 * io + (q.numel() + k.numel() + v.numel()) * 4


@pytest.mark.parametrize("pos", [0, 8, 20])
def test_prefix_chunk_cost_reads_the_offset(pos):
    q = torch.randn(1, 8, 4, 16)
    kc, vc = torch.randn(1, 32, 2, 16), torch.randn(1, 32, 2, 16)
    keys = min(pos + 8, 32)
    f, by = _reported(ops.prefix_chunk_attention, q, kc, vc,
                         torch.tensor(pos, dtype=torch.int32))
    assert f == 4 * 16 * _causal_pairs(8, keys) * 4
    assert by == (2 * q.numel() + 2 * keys * 2 * 16) * 4


@pytest.mark.parametrize("lens", [[5, 0, 17], [1, 1, 1], [32, 9, 2]])
def test_decode_costs_read_the_lengths(lens):
    b, hq, hkv, d, ps = 3, 4, 2, 16, 8
    q = torch.randn(b, hq, d)
    sl = torch.tensor(lens, dtype=torch.int32)
    tok = sum(lens)
    kc, vc = torch.randn(b, 32, hkv, d), torch.randn(b, 32, hkv, d)
    f, by = _reported(ops.decode_mha, q, kc, vc, sl)
    assert (f, by) == (4 * d * tok * hq,
                       tok * hkv * d * 4 * 2 + 2 * q.numel() * 4 + b * 4)
    pool = torch.randn(16, ps, hkv, d)
    table = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    f, by = _reported(ops.paged_decode_mha, q, pool, pool, table, sl)
    assert (f, by) == (4 * d * tok * hq, tok * hkv * d * 4 * 2
                       + 2 * q.numel() * 4 + table.numel() * 4 + b * 4)
    qp = torch.randint(-127, 127, (16, ps, hkv, d), dtype=torch.int8)
    sc = torch.rand(16, hkv)
    f, by = _reported(ops.paged_decode_mha, q, qp, qp, table, sl, sc, sc)
    assert by == (tok * hkv * d * 2 + 2 * q.numel() * 4 + table.numel() * 4
                  + b * 4 + 2 * 16 * hkv * 4)


@pytest.mark.parametrize("t,k,n", [(8, 16, 32), (3, 64, 8)])
def test_gemm_costs(t, k, n):
    x, dy = torch.randn(t, k), torch.randn(t, n)
    dw = torch.zeros(k, n)
    f, by = _reported(ops.fused_linear_param_grad_add, x, dy, dw)
    assert (f, by) == (2 * t * k * n, (t * k + t * n) * 4 + 2 * k * n * 4)
    sizes = torch.tensor([t, 0, 2 * t], dtype=torch.int32)
    lhs, rhs = torch.randn(3 * t, k), torch.randn(3, k, n)
    f, by = _reported(ops.grouped_matmul, lhs, rhs, sizes)
    m = 3 * t
    assert (f, by) == (2 * m * k * n,
                       m * k * 4 + 2 * k * n * 4 + m * n * 4 + 3 * 4)


def test_plain_versions_add_nothing_and_views_count_none():
    """On the CPU a wrapper's plain version runs inside the kernel's
    scope: its many PyTorch ops add nothing beyond the kernel's report.
    Outside any kernel, a view moves nothing and an op counts its inputs
    and outputs once."""
    x = torch.randn(4, 64)
    w = torch.randn(64)
    f, by = _reported(ops.rms_norm_ref, x, w)
    assert f == 0 and by > 2 * x.numel() * 4      # unfused: many passes
    assert _reported(ops.rms_norm, x, w) == (4 * x.numel(),
                                             2 * x.numel() * 4 + 64 * 4)
    assert _reported(lambda: x.view(64, 4).t()) == (0, 0)
    x3, w3 = torch.randn(2, 3, 64), torch.randn(64, 8)   # mm + an alias
    assert _reported(lambda: x3 @ w3) == (2 * 6 * 64 * 8,
                                          (6 * 64 + 64 * 8 + 6 * 8) * 4)
    assert _reported(lambda: x + 1) == (0, 2 * x.numel() * 4)
    idx = torch.tensor([1, 3])
    assert _reported(lambda: x.index_select(0, idx)) == (
        0, 2 * 2 * 64 * 4 + idx.numel() * 8)


# ---------------------------------------------------------------- (f)


def test_http_get_profile_and_render(led):
    torch.manual_seed(0)
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=1),
                             device="cpu")
    eng = PagedContinuousBatchingEngine(model, max_batch=2, num_pages=16,
                                        page_size=8, max_pages=8)
    srv = Server(eng, segment_steps=2)
    httpd = serve_http(srv, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/profile"
    try:
        h = srv.submit(np.arange(1, 7, dtype=np.int32),
                       GenerationConfig(max_new_tokens=4))
        h.result(timeout=WAIT)
        with urllib.request.urlopen(url, timeout=30) as r:
            assert r.status == 200
            doc = json.loads(r.read())
        assert doc["programs"] and doc["server"] == srv.monitor_server
        assert doc["peaks"]["peak_flops"] > 0
        sys.path.insert(0, str(ROOT / "tools"))
        try:
            from monitor_report import render_profile
        finally:
            sys.path.remove(str(ROOT / "tools"))
        text = render_profile(doc)
        rows = [ln for ln in text.splitlines()
                if ln.split(" ", 1)[0] in doc["programs"]]
        assert len(rows) == len(doc["programs"])
        ledger.disable()
        with urllib.request.urlopen(url, timeout=30) as r:
            assert r.status == 200
        ledger.reset()
        with urllib.request.urlopen(url, timeout=30) as r:
            assert json.loads(r.read())["programs"] == {}
    finally:
        httpd.shutdown()
        srv.shutdown()
        eng.close()
