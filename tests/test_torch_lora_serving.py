"""Multi-tenant LoRA serving in paddle_tpu_torch, port against port, on the
CPU: the contracts of ``tests/test_lora_serving.py`` held by the port.

- The registry's lifecycle: load / acquire / release / unload, UNLOAD
  DEFERRAL while a live slot references the index, recycling with a fresh
  prefix salt, validation, ``release_all``.
- Parity: a mixed-adapter batch gives each request the tokens it gets
  served alone (paged MHA and GQA, dense), through one decode program;
  base rows on a LoRA engine are bit for bit a LoRA-free engine's; one
  adapter's prefill logits match a model whose weights were merged with
  ``W + (B A)^T * alpha / r`` within ``MERGED_TOL`` (the low-rank product
  and the merged matmul sum in other orders); an adapter of rank 2 in a
  bank of rank 4 decodes as in a bank of rank 2.
- One program: after ``warmup()`` hot loads and a mixed batch capture
  nothing, and the bank keeps its addresses.
- Hot load and unload through the ``Server``'s gap, deferral included;
  the admin ops on an engine without ``lora_capacity``.
- Prefix namespaces: no warm hit across adapters nor across a reload of a
  name; base and same-adapter traffic still hits, warm streams equal cold.
- Composition: preemption replay, a supervised restart, speculative
  decoding (host and device mode) and int8 pools with adapters.
- Tenant quotas (the tenant defaults to the adapter) and the HTTP surface.

Every ``Server`` is shut down in ``finally``, every wait has a timeout.
"""
import http.client
import json
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import (ContinuousBatchingEngine, GenerationConfig,
                              LlamaForCausalLM, PagedContinuousBatchingEngine,
                              llama_config)
from paddle_tpu_torch.inference.generation import EngineFault
from paddle_tpu_torch.serving import (AdapterRegistry, RequestHandle,
                                      RequestQueue, Server, serve_http)

WAIT = 120                  # seconds any one wait may take
MERGED_TOL = dict(atol=2e-4, rtol=1e-4)     # the reference's oracle bar
PROMPT = list(range(1, 9))

_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_model(kv_heads=4):
    """One 1-layer tiny llama per kv-head layout (4: MHA, 2: GQA), shared
    by the module."""
    if kv_heads not in _MODELS:
        torch.manual_seed(0)
        cfg = llama_config("tiny", num_hidden_layers=1,
                           num_key_value_heads=kv_heads)
        _MODELS[kv_heads] = LlamaForCausalLM(cfg, device="cpu")
    return _MODELS[kv_heads]


def make_adapter(model, seed, targets=("q", "v"), rank=2, scale=0.6):
    """Seeded numpy (A, B) factors per target, large enough that adapter
    outputs part from the base model's on the untrained tiny model."""
    _, shapes = model.lora_shapes(targets)
    rng = np.random.default_rng(seed)
    return {t: (rng.standard_normal((rank, d_in)).astype(np.float32)
                * scale,
                rng.standard_normal((d_out, rank)).astype(np.float32)
                * scale)
            for t, (d_in, d_out) in shapes.items()}


def paged_engine(model, max_batch=4, num_pages=64, page_size=4,
                 max_pages=8, **kw):
    kw.setdefault("debug_pages", True)
    kw.setdefault("lora_capacity", 3)
    kw.setdefault("lora_rank", 4)
    kw.setdefault("lora_targets", ("q", "v"))
    return PagedContinuousBatchingEngine(
        model, max_batch=max_batch, num_pages=num_pages,
        page_size=page_size, max_pages=max_pages, **kw)


def _greedy(n, adapter=None, eos=None):
    return GenerationConfig(max_new_tokens=n, adapter=adapter,
                            eos_token_id=eos)


def _run_one(eng, ids, n=6, adapter=None, seg=4):
    rid = eng.add_request(np.asarray(ids, np.int32), _greedy(n, adapter))
    while eng.decode_segment(seg):
        pass
    return [int(t) for t in eng.collect_finished()[rid]]


def _assert_no_leaks(eng):
    assert eng.free_slots() == eng.max_batch
    assert eng.alloc.used_pages == 0
    assert (eng.alloc.free_pages + eng.alloc.cached_pages
            == eng.num_pages)
    eng.alloc.check()
    reg = eng.adapters
    if reg is not None:
        assert not any(reg._refs.values()) and not reg._draining


def _bank_ptrs(eng):
    return [t.data_ptr() for ab in eng.adapters.bank.values() for t in ab]


# -- the registry's lifecycle ------------------------------------------------------


class TestAdapterRegistry:
    def _reg(self, capacity=2, rank=4):
        return AdapterRegistry(capacity, rank, ("q",), 1, {"q": (8, 8)},
                               torch.float32, "eng-test", device="cpu")

    def _ab(self, r=2, seed=0):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((r, 8)).astype(np.float32),
                rng.standard_normal((8, r)).astype(np.float32))

    def test_load_acquire_release_unload(self):
        reg = self._reg()
        idx = reg.load("a", {"q": self._ab()})
        assert idx == 1 and "a" in reg
        assert reg.acquire("a") == idx
        reg.release(idx)
        assert reg.unload("a") is True      # freed at once
        assert "a" not in reg
        assert reg.resident()["free"] == 2

    def test_unload_defers_while_referenced(self):
        reg = self._reg()
        idx = reg.load("a", {"q": self._ab()})
        reg.acquire("a")
        assert reg.unload("a") is False     # deferred
        with pytest.raises(ValueError, match="unknown adapter"):
            reg.acquire("a")                # new requests refused
        assert reg.resident()["draining"] == ["a"]
        reg.release(idx)                    # the last reference frees it
        assert reg.resident() == {"capacity": 2, "resident": 0,
                                  "free": 2, "adapters": [],
                                  "draining": []}

    def test_index_recycled_and_salt_fresh(self):
        reg = self._reg()
        i1 = reg.load("a", {"q": self._ab()})
        s1 = reg.salt(i1)
        reg.unload("a")
        i2 = reg.load("a", {"q": self._ab(seed=1)})
        assert i2 == i1                     # recycled
        assert reg.salt(i2) != s1           # in a FRESH namespace
        assert reg.salt(0) == b""           # base keeps the bare root

    def test_validation(self):
        reg = self._reg()
        reg.load("a", {"q": self._ab()})
        with pytest.raises(ValueError, match="already loaded"):
            reg.load("a", {"q": self._ab()})
        with pytest.raises(ValueError, match="not in the"):
            reg.load("b", {"nope": self._ab()})
        with pytest.raises(ValueError, match="rank"):
            reg.load("b", {"q": self._ab(r=5)})   # over the bank rank
        with pytest.raises(ValueError, match="B must be"):
            a, b = self._ab()
            reg.load("b", {"q": (a, b[:, :1])})   # rank mismatch
        reg.load("b", {"q": self._ab()})
        with pytest.raises(ValueError, match="registry full"):
            reg.load("c", {"q": self._ab()})

    def test_alpha_folds_into_bank(self):
        reg = self._reg()
        a, b = self._ab()
        reg.load("x", {"q": (a, b)}, alpha=4)   # r = 2: scale 2.0
        A, B = reg.bank["q"]
        np.testing.assert_allclose(B[0, 1, :, :2].numpy(), b * 2.0,
                                   rtol=1e-6)
        np.testing.assert_allclose(A[0, 1, :2].numpy(), a, rtol=1e-6)
        assert not A[0, 1, 2:].any()        # padded rank rows are zero

    def test_name_bound_matches_generation_config(self):
        reg = self._reg()
        with pytest.raises(ValueError, match="256"):
            reg.load("x" * 300, {"q": self._ab()})
        with pytest.raises(ValueError, match="adapter"):
            GenerationConfig(max_new_tokens=1, adapter="x" * 300)

    def test_release_all_completes_deferred(self):
        reg = self._reg()
        reg.load("a", {"q": self._ab()})
        reg.acquire("a")
        reg.unload("a")
        reg.release_all()                   # the engine's reset_state
        assert reg.resident()["free"] == 2


# -- parity -------------------------------------------------------------------------


class TestLoraParity:
    @pytest.mark.parametrize("kv_heads", [4, 2])
    def test_mixed_batch_matches_solo_paged(self, kv_heads):
        model = tiny_model(kv_heads)
        eng = paged_engine(model)
        eng.load_adapter("a1", make_adapter(model, 11))
        eng.load_adapter("a2", make_adapter(model, 22, scale=0.9))
        solo = {name: _run_one(eng, PROMPT, adapter=name)
                for name in (None, "a1", "a2")}
        assert solo["a1"] != solo[None] or solo["a2"] != solo[None]
        rids = {name: eng.add_request(np.asarray(PROMPT, np.int32),
                                      _greedy(6, name))
                for name in (None, "a1", "a2")}
        while eng.decode_segment(4):
            pass
        fin = eng.collect_finished()
        for name, rid in rids.items():
            assert [int(t) for t in fin[rid]] == solo[name], name
        _assert_no_leaks(eng)
        eng.close()

    def test_mixed_batch_matches_solo_dense(self):
        model = tiny_model(4)
        eng = ContinuousBatchingEngine(model, max_batch=3, max_len=32,
                                       lora_capacity=2, lora_rank=4,
                                       lora_targets=("q", "v"))
        eng.load_adapter("a1", make_adapter(model, 11))
        solo = {name: _run_one(eng, PROMPT, adapter=name)
                for name in (None, "a1")}
        rids = {name: eng.add_request(np.asarray(PROMPT, np.int32),
                                      _greedy(6, name))
                for name in (None, "a1")}
        while eng.decode_segment(4):
            pass
        fin = eng.collect_finished()
        for name, rid in rids.items():
            assert [int(t) for t in fin[rid]] == solo[name], name
        assert eng.free_slots() == 3
        eng.close()

    def test_base_rows_bitwise_vs_lora_free_engine(self):
        """Base rows on a LoRA engine (next to an adapter row) against a
        LoRA-free engine: the same tokens, and the same prefill logits
        bit for bit."""
        model = tiny_model(4)
        plain = paged_engine(model, lora_capacity=0)
        ref = _run_one(plain, PROMPT)
        eng = paged_engine(model)
        eng.load_adapter("a1", make_adapter(model, 11))
        assert _run_one(eng, PROMPT) == ref   # row 0's delta is exactly 0
        r_base = eng.add_request(np.asarray(PROMPT, np.int32), _greedy(6))
        eng.add_request(np.asarray(PROMPT, np.int32), _greedy(6, "a1"))
        while eng.decode_segment(4):
            pass
        assert [int(t) for t in eng.collect_finished()[r_base]] == ref
        ids = np.asarray([PROMPT], np.int32)
        want, _ = plain._run_prefill(ids, len(PROMPT),
                                     model.init_cache(1, 16))
        got, _ = eng._run_prefill(
            ids, len(PROMPT), model.init_cache(1, 16),
            lora=(eng.adapters.bank, torch.zeros(1, dtype=torch.int32)))
        assert torch.equal(got, want)
        plain.close()
        eng.close()

    def test_merged_weights_oracle(self):
        """One adapter through the per-row gather against the same deltas
        merged into the projection weights, within MERGED_TOL."""
        model = tiny_model(4)
        params = make_adapter(model, 33, targets=("q", "v", "gate"),
                              rank=2, scale=0.3)
        eng = paged_engine(model, lora_capacity=1,
                           lora_targets=("q", "v", "gate"))
        eng.load_adapter("m", params, alpha=4)   # scale 2.0
        ids = np.asarray([PROMPT], np.int32)
        got, _ = eng._run_prefill(
            ids, len(PROMPT), model.init_cache(1, 16),
            lora=(eng.adapters.bank, torch.ones(1, dtype=torch.int32)))
        merged = LlamaForCausalLM(model.config, device="cpu")
        merged.load_state_dict(model.state_dict())
        layer = merged.model.layers[0]
        projs = {"q": layer.self_attn.q_proj, "v": layer.self_attn.v_proj,
                 "gate": layer.mlp.gate_proj}
        with torch.no_grad():
            for t, (a, b) in params.items():
                projs[t].weight += torch.from_numpy((b @ a).T * 2.0)
        eng2 = paged_engine(merged, lora_capacity=0)
        want, _ = eng2._run_prefill(ids, len(PROMPT),
                                    merged.init_cache(1, 16))
        np.testing.assert_allclose(got.numpy(), want.numpy(), **MERGED_TOL)
        assert not torch.equal(got, eng._run_prefill(
            ids, len(PROMPT), model.init_cache(1, 16))[0])
        eng.close()
        eng2.close()

    def test_rank_padding_exact(self):
        """An r = 2 adapter in an r = 4 bank decodes bit for bit as the
        same adapter in an r = 2 bank: padded rows add an exact 0."""
        model = tiny_model(4)
        params = make_adapter(model, 44, rank=2)
        wide = paged_engine(model, lora_rank=4)
        narrow = paged_engine(model, lora_rank=2)
        wide.load_adapter("p", params)
        narrow.load_adapter("p", params)
        assert (_run_one(wide, PROMPT, adapter="p")
                == _run_one(narrow, PROMPT, adapter="p"))
        wide.close()
        narrow.close()


# -- one program --------------------------------------------------------------------


class TestOneProgram:
    @pytest.mark.parametrize("kind", ["paged", "dense"])
    def test_no_capture_after_warmup(self, kind):
        """After ``warmup()`` (which times ``lora_install``), hot loads, an
        unload and a mixed-adapter batch capture nothing, and the bank
        keeps its addresses through them."""
        model = tiny_model(4)
        if kind == "paged":
            eng = paged_engine(model, prefill_chunk=8)
        else:
            eng = ContinuousBatchingEngine(model, max_batch=3, max_len=32,
                                           prefill_chunk=8, lora_capacity=3,
                                           lora_rank=4,
                                           lora_targets=("q", "v"))
        warm = eng.warmup(segment_steps=4)
        assert "lora_install" in warm
        before = dict(eng.programs.captures)
        ptrs = _bank_ptrs(eng)
        eng.load_adapter("a1", make_adapter(model, 11))
        eng.load_adapter("a2", make_adapter(model, 22))
        long = list(range(1, 20))           # chunked: 3 chunks of 8
        for name, p in ((None, PROMPT), ("a1", PROMPT), ("a2", long)):
            eng.add_request(np.asarray(p, np.int32), _greedy(6, name))
        while eng.decode_segment(4):
            pass
        eng.collect_finished()
        eng.unload_adapter("a1")
        eng.load_adapter("a3", make_adapter(model, 33))
        assert eng.programs.captures == before
        assert _bank_ptrs(eng) == ptrs
        eng.close()


# -- hot load / unload through the serving gap --------------------------------------


class TestHotLoadUnload:
    def test_server_load_unload_deferred(self):
        model = tiny_model(4)
        # room for a request long enough to be live when the unload lands
        eng = paged_engine(model, max_pages=64, num_pages=128)
        srv = Server(eng, segment_steps=2)
        try:
            assert srv.load_adapter("hot", make_adapter(model, 55)) == 1
            ref = list(srv.submit(np.asarray(PROMPT, np.int32),
                                  _greedy(8, "hot")).result(WAIT))
            h = srv.submit(np.asarray(PROMPT, np.int32),
                           _greedy(240, "hot"))
            it = h.stream(timeout=WAIT)
            next(it)                      # the request is live in a slot
            assert srv.unload_adapter("hot") is False   # defers
            with pytest.raises(Exception, match="unknown adapter"):
                # new submissions naming it fail at admission
                srv.submit(np.asarray(PROMPT, np.int32),
                           _greedy(4, "hot")).result(WAIT)
            assert list(h.result(WAIT))[:8] == ref[:8]  # live one unharmed
            deadline = time.monotonic() + 10
            while (srv.engine.adapters.resident()["free"] == 2
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert srv.engine.adapters.resident()["free"] == 3
            # the freed index recycles for a hot load mid-serving
            assert srv.load_adapter("hot2", make_adapter(model, 66)) == 1
            assert "hot2" in srv.engine.adapters
            with pytest.raises(ValueError, match="already loaded"):
                srv.load_adapter("hot2", make_adapter(model, 66))
        finally:
            srv.shutdown(timeout=WAIT)
            _assert_no_leaks(eng)
            eng.close()

    def test_server_stages_on_the_callers_thread(self):
        """``Server.load_adapter`` validates, pads, scales and converts the
        factors on the caller's thread: malformed factors fail there with
        nothing queued for the gap, and the gap only copies the staged
        rows, which land as ``engine.load_adapter`` would write them."""
        model = tiny_model(4)
        eng = paged_engine(model)
        ref = paged_engine(model)
        srv = Server(eng, segment_steps=2)
        try:
            bad = make_adapter(model, 5)
            bad["v"] = (bad["v"][0][:, :3], bad["v"][1])
            stopped = Server(paged_engine(model), start=False)
            with pytest.raises(ValueError, match="A must be"):
                stopped.load_adapter("bad", bad, timeout=WAIT)
            assert not stopped._admin_ops
            stopped.shutdown(drain=False)
            stopped.engine.close()
            params = make_adapter(model, 5)
            assert srv.load_adapter("s", params, alpha=3) == \
                ref.load_adapter("s", params, alpha=3)
            for t in eng.adapters.targets:
                for got, want in zip(eng.adapters.bank[t],
                                     ref.adapters.bank[t]):
                    assert torch.equal(got, want)
        finally:
            srv.shutdown(timeout=WAIT)
            eng.close()
            ref.close()

    def test_admin_needs_lora_engine(self):
        model = tiny_model(4)
        eng = paged_engine(model, lora_capacity=0)
        srv = Server(eng, start=False)
        try:
            with pytest.raises(RuntimeError, match="lora_capacity"):
                srv.load_adapter("x", {})
            with pytest.raises(RuntimeError, match="lora_capacity"):
                srv.unload_adapter("x")
        finally:
            srv.shutdown(drain=False)
            eng.close()

    def test_pending_admin_op_fails_at_shutdown(self):
        """An admin op the scheduler never applied fails cleanly when the
        server stops; after that, admin ops are refused."""
        import threading

        model = tiny_model(4)
        eng = paged_engine(model)
        srv = Server(eng, start=False)
        errors = []

        def load():
            try:
                srv.load_adapter("late", make_adapter(model, 1),
                                 timeout=WAIT)
            except Exception as e:          # collected below
                errors.append(e)

        th = threading.Thread(target=load, daemon=True)
        th.start()
        deadline = time.monotonic() + 10
        while not srv._admin_ops and time.monotonic() < deadline:
            time.sleep(0.01)
        srv.shutdown(drain=False)
        srv._finalize(None)                 # the stopped loop's cleanup
        th.join(WAIT)
        assert not th.is_alive()
        assert len(errors) == 1 and "before the admin op" in str(errors[0])
        with pytest.raises(Exception, match="shut down"):
            srv.load_adapter("later", make_adapter(model, 2))
        eng.close()


# -- per-adapter prefix-cache namespaces --------------------------------------------


class TestPrefixSalting:
    def test_cross_adapter_hit_zero_same_adapter_hits(self):
        model = tiny_model(4)
        eng = paged_engine(model, num_pages=64, prefix_cache=True)
        eng.load_adapter("s1", make_adapter(model, 71))
        eng.load_adapter("s2", make_adapter(model, 72))
        prompt = list(range(1, 13))        # 3 full pages
        cold = _run_one(eng, prompt, adapter="s1")
        assert eng.alloc.prefix_hits == 0
        # the SAME prompt under another adapter: no warm hit
        _run_one(eng, prompt, adapter="s2")
        assert eng.alloc.prefix_hits == 0
        _run_one(eng, prompt)              # the base namespace: cold too
        assert eng.alloc.prefix_hits == 0
        # the same adapter again: a warm hit, the cold stream
        warm = _run_one(eng, prompt, adapter="s1")
        assert eng.alloc.prefix_hits == 1
        assert warm == cold
        _assert_no_leaks(eng)
        eng.close()

    def test_reload_same_name_never_hits_old_pages(self):
        """An unload and reload of the SAME name gets a fresh generation
        salt: pages cached under the old weights never serve the new."""
        model = tiny_model(4)
        eng = paged_engine(model, num_pages=64, prefix_cache=True)
        eng.load_adapter("r", make_adapter(model, 81))
        prompt = list(range(1, 13))
        _run_one(eng, prompt, adapter="r")
        eng.unload_adapter("r")
        eng.load_adapter("r", make_adapter(model, 82))   # new weights
        _run_one(eng, prompt, adapter="r")
        assert eng.alloc.prefix_hits == 0
        _assert_no_leaks(eng)
        eng.close()

    def test_base_namespace_still_warm(self):
        model = tiny_model(4)
        eng = paged_engine(model, num_pages=64, prefix_cache=True)
        eng.load_adapter("b1", make_adapter(model, 91))
        prompt = list(range(1, 13))
        cold = _run_one(eng, prompt)
        warm = _run_one(eng, prompt)
        assert eng.alloc.prefix_hits == 1 and warm == cold
        _assert_no_leaks(eng)
        eng.close()

    def test_chunked_admission_is_salted(self):
        """A chunked admission looks up and registers in its adapter's
        namespace too: a warm chunked re-admission under the same adapter
        gives the cold stream, under another adapter no hit."""
        model = tiny_model(4)
        eng = paged_engine(model, num_pages=64, prefix_cache=True,
                           prefill_chunk=8)
        eng.load_adapter("c1", make_adapter(model, 95))
        prompt = list(range(1, 19))

        def chunked(adapter):
            adm = eng.begin_admit(np.asarray(prompt, np.int32),
                                  _greedy(6, adapter))
            while not eng.admit_chunk(adm):
                pass
            while eng.decode_segment(4):
                pass
            return [int(t) for t in eng.collect_finished()[adm.rid]]

        cold = chunked("c1")
        chunked(None)
        assert eng.alloc.prefix_hits == 0
        assert chunked("c1") == cold
        assert eng.alloc.prefix_hits == 1
        _assert_no_leaks(eng)
        eng.close()


# -- composition with the serving stack ---------------------------------------------


class TestCompose:
    def test_preempt_replay_keeps_adapter(self):
        """Forced optimistic pressure: preempted adapter requests replay
        under their adapter, each stream its unpressured one."""
        model = tiny_model(4)
        roomy = paged_engine(model, num_pages=64)
        roomy.load_adapter("p1", make_adapter(model, 101))
        refs = [_run_one(roomy, PROMPT, n=10, adapter=a)
                for a in ("p1", "p1", None)]
        roomy.close()
        tight = paged_engine(model, num_pages=12,
                             admission_mode="optimistic")
        tight.load_adapter("p1", make_adapter(model, 101))
        srv = Server(tight, segment_steps=4, admission_mode="optimistic",
                     max_preemptions=10)
        try:
            hs = [srv.submit(np.asarray(PROMPT, np.int32), _greedy(10, a))
                  for a in ("p1", "p1", None)]
            outs = [[int(t) for t in h.result(WAIT)] for h in hs]
            assert outs == refs
            assert tight.alloc.preemptions >= 1   # the pressure really hit
        finally:
            srv.shutdown(timeout=WAIT)
            _assert_no_leaks(tight)
            tight.close()

    def test_engine_restart_replays_adapter(self):
        """A decode-seam EngineFault mid-run: the supervised restart
        replays the adapter request to its fault-free stream (the bank
        and the names survive ``reset_state``)."""
        from paddle_tpu_torch.testing import FaultPlan, FaultyEngine

        model = tiny_model(4)
        clean = paged_engine(model)
        clean.load_adapter("f1", make_adapter(model, 111))
        ref = _run_one(clean, PROMPT, n=10, adapter="f1")
        clean.close()
        eng = paged_engine(model)
        eng.load_adapter("f1", make_adapter(model, 111))
        plan = FaultPlan().raise_at("decode", nth=2,
                                    exc=EngineFault("injected"))
        srv = Server(FaultyEngine(eng, plan), segment_steps=4,
                     max_restarts=3, restart_backoff_s=0.01)
        try:
            h = srv.submit(np.asarray(PROMPT, np.int32), _greedy(10, "f1"))
            assert [int(t) for t in h.result(WAIT)] == ref
            assert srv.restarts == 1
            assert "f1" in eng.adapters
        finally:
            srv.shutdown(timeout=WAIT)
            _assert_no_leaks(eng)
            eng.close()

    @pytest.mark.parametrize("mode", ["host", "device"])
    def test_spec_decode_with_adapter(self, mode):
        """A speculating adapter request through the verify programs is
        its plain-decode self, and drafts are accepted."""
        model = tiny_model(4)
        rep = (PROMPT * 3)[:20]             # repetitive: drafts accepted
        eng = paged_engine(model, max_pages=16, num_pages=96, draft_k=4,
                           spec_mode=mode)
        eng.load_adapter("sp", make_adapter(model, 121))
        plain = _run_one(eng, rep, n=12, adapter="sp")
        rid = eng.add_request(
            np.asarray(rep, np.int32),
            GenerationConfig(max_new_tokens=12, adapter="sp",
                             speculative=True))
        while eng.decode_segment(4):
            pass
        spec = [int(t) for t in eng.collect_finished()[rid]]
        assert spec == plain
        assert eng.spec_stats()["forwards"] >= 1
        _assert_no_leaks(eng)
        eng.close()

    def test_int8_kv_with_adapters(self):
        """int8 pools: a mixed-adapter batch gives each request its solo
        stream, leak-free under the scale-aware checks."""
        model = tiny_model(4)
        eng = paged_engine(model, kv_dtype="int8")
        eng.load_adapter("q1", make_adapter(model, 131))
        solo = {a: _run_one(eng, PROMPT, adapter=a) for a in (None, "q1")}
        rids = {a: eng.add_request(np.asarray(PROMPT, np.int32),
                                   _greedy(6, a))
                for a in (None, "q1")}
        while eng.decode_segment(4):
            pass
        fin = eng.collect_finished()
        for a, rid in rids.items():
            assert [int(t) for t in fin[rid]] == solo[a], a
        _assert_no_leaks(eng)
        eng.close()

    def test_cancel_and_abort_release_adapter_references(self):
        """Every way a slot ends gives its adapter reference back: a
        cancel, a preemption, an aborted chunked admission and a failed
        admission."""
        model = tiny_model(4)
        eng = paged_engine(model, prefill_chunk=8)
        eng.load_adapter("x", make_adapter(model, 141))
        refs = eng.adapters._refs
        rid = eng.add_request(np.asarray(PROMPT, np.int32), _greedy(8, "x"))
        assert refs[1] == 1
        eng.cancel_request(rid)
        rid = eng.add_request(np.asarray(PROMPT, np.int32), _greedy(8, "x"))
        eng.preempt_request(rid)
        adm = eng.begin_admit(np.asarray(list(range(1, 20)), np.int32),
                              _greedy(4, "x"))
        assert refs[1] == 1
        eng.abort_admit(adm)
        assert refs[1] == 0
        with pytest.raises(ValueError, match="unknown adapter"):
            eng.add_request(np.asarray(PROMPT, np.int32), _greedy(4, "y"))
        _assert_no_leaks(eng)
        assert eng.adapter_idx.tolist() == [0] * 4
        eng.close()


# -- per-tenant quotas --------------------------------------------------------------


class TestTenantQuotas:
    def test_over_quota_defers_without_starving_others(self):
        """Tenant A's second request defers at its quota while tenant B,
        queued BEHIND it, admits and finishes; A's second admits once A's
        first retires (the tenant defaults to the adapter)."""
        model = tiny_model(4)
        # room for an A1 long enough to hold A's quota past B1's run
        eng = paged_engine(model, max_batch=4, max_pages=64, num_pages=256)
        eng.load_adapter("A", make_adapter(model, 141))
        eng.load_adapter("B", make_adapter(model, 142))
        srv = Server(eng, segment_steps=2, tenant_quotas=1)
        try:
            a1 = srv.submit(np.asarray(PROMPT, np.int32), _greedy(240, "A"))
            assert a1.tenant == "A"
            it = a1.stream(timeout=WAIT)
            next(it)                       # A1 holds A's one slot
            a2 = srv.submit(np.asarray(PROMPT, np.int32), _greedy(4, "A"))
            b1 = srv.submit(np.asarray(PROMPT, np.int32), _greedy(4, "B"))
            b1.result(WAIT)                # B passes the deferred A2
            assert a2.status == "queued"   # A over its quota: waiting
            a1.result(WAIT)
            a2.result(WAIT)                # admits once A1 retired
        finally:
            srv.shutdown(timeout=WAIT)
            _assert_no_leaks(eng)
            eng.close()

    def test_quota_dict_and_untracked_tenants(self):
        model = tiny_model(4)
        eng = paged_engine(model, max_batch=4)
        srv = Server(eng, segment_steps=2, tenant_quotas={"X": 1},
                     start=False)
        try:
            # a dict caps only the named tenants; base / None is untracked
            assert srv._tenant_ok(type("H", (), {"tenant": None}))
            assert srv._tenant_ok(type("H2", (), {"tenant": "Y"}))
        finally:
            srv.shutdown(drain=False)
            eng.close()

    def test_quota_validation(self):
        model = tiny_model(4)
        eng = paged_engine(model, lora_capacity=0)
        with pytest.raises(ValueError, match="tenant_quotas"):
            Server(eng, tenant_quotas="lots", start=False)
        with pytest.raises(ValueError, match="quota caps"):
            Server(eng, tenant_quotas={"a": 0}, start=False)
        eng.close()

    def test_queue_pop_admittable_skips_only_quota(self):
        q = RequestQueue(8)
        hs = [RequestHandle(i, [1], 1, _greedy(2), tenant=t)
              for i, t in enumerate(("A", "A", "B"))]
        for h in hs:
            q.put(h)
        # a capacity-blocked head stops the scan (no bypass)
        assert q.pop_admittable(lambda h: False, lambda h: True) is None
        assert q.depth == 3
        # quota-blocked entries are skipped, FIFO otherwise
        got = q.pop_admittable(lambda h: True, lambda h: h.tenant != "A")
        assert got is hs[2] and q.depth == 2


# -- the HTTP surface ---------------------------------------------------------------


def _post(port, path, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        c.request("POST", path, json.dumps(body),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        c.close()


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        c.close()


class TestHTTPAdapters:
    @pytest.fixture()
    def served(self):
        model = tiny_model(4)
        eng = paged_engine(model, max_pages=64, num_pages=128)
        srv = Server(eng, segment_steps=4)
        httpd = None
        try:
            srv.load_adapter("web", make_adapter(model, 151))
            httpd = serve_http(srv)
            yield srv, eng, httpd.server_address[1]
        finally:
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
            srv.shutdown(timeout=WAIT)
            eng.close()

    def test_unknown_field_400_names_field(self, served):
        _, _, port = served
        st, body = _post(port, "/generate",
                         {"prompt": PROMPT, "adaptor": "web"})
        assert st == 400
        assert "adaptor" in body["error"]          # names the typo
        assert "adapter" in body["error"]          # lists the fix

    def test_adapter_round_trip(self, served):
        srv, _, port = served
        ref = list(srv.submit(np.asarray(PROMPT, np.int32),
                              _greedy(5, "web")).result(WAIT))
        st, body = _post(port, "/generate",
                         {"prompt": PROMPT, "max_new_tokens": 5,
                          "adapter": "web"})
        assert st == 200 and body["tokens"] == [int(t) for t in ref]
        # an unknown adapter: the request fails with the cause, a 500
        st, body = _post(port, "/generate",
                         {"prompt": PROMPT, "max_new_tokens": 4,
                          "adapter": "nope"})
        assert st == 500 and "nope" in body["error"]

    def test_admin_load_unload_and_healthz(self, served, tmp_path):
        _, eng, port = served
        model = tiny_model(4)
        p = make_adapter(model, 161)
        weights = {t: {"a": a.tolist(), "b": b.tolist()}
                   for t, (a, b) in p.items()}
        st, body = _post(port, "/adapters/load",
                         {"name": "adm", "weights": weights})
        assert st == 200 and body["index"] >= 1
        assert "adm" in body["adapters"]["adapters"]
        st, hz = _get(port, "/healthz")
        assert st == 200 and "adm" in hz["lora"]["adapters"]
        st, body = _post(port, "/adapters/unload", {"name": "adm"})
        assert st == 200 and body["unloaded"] is True
        assert body["deferred"] is False
        # the npz form loads the same rows as the inline one
        path = tmp_path / "adapter.npz"
        np.savez(path, **{f"{t}.{k}": v for t, (a, b) in p.items()
                          for k, v in (("a", a), ("b", b))})
        st, body = _post(port, "/adapters/load",
                         {"name": "npz", "path": str(path), "alpha": 4})
        assert st == 200
        B = eng.adapters.bank["v"][1]              # alpha 4 / r 2: x 2.0
        np.testing.assert_allclose(B[0, body["index"], :, :2].numpy(),
                                   p["v"][1] * 2.0, rtol=1e-6)
        # validation errors are 400s
        st, body = _post(port, "/adapters/load", {"name": "bad"})
        assert st == 400 and "weights" in body["error"]
        st, body = _post(port, "/adapters/unload", {"name": "ghost"})
        assert st == 400 and "ghost" in body["error"]
        st, body = _post(port, "/adapters/load",
                         {"name": "t", "path": str(tmp_path / "no.npz")})
        assert st == 400
        # admin bodies are strict too: a typo'd "aplha" must not silently
        # install scale-1.0 deltas
        st, body = _post(port, "/adapters/load",
                         {"name": "t", "weights": weights, "aplha": 32})
        assert st == 400 and "aplha" in body["error"]
        st, body = _post(port, "/adapters/swap", {"name": "t"})
        assert st == 404

    def test_unload_in_use_answers_deferred(self, served):
        srv, eng, port = served
        h = srv.submit(np.asarray(PROMPT, np.int32), _greedy(240, "web"))
        next(h.stream(timeout=WAIT))             # live in a slot
        st, body = _post(port, "/adapters/unload", {"name": "web"})
        assert st == 200 and body["deferred"] is True
        # the name leaves at once (the index may free before the reply)
        assert "web" not in body["adapters"]["adapters"]
        h.result(WAIT)
        deadline = time.monotonic() + 10
        while eng.adapters.resident()["draining"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        st, hz = _get(port, "/healthz")
        assert hz["lora"]["draining"] == [] and hz["lora"]["free"] == 3

    def test_admin_on_non_lora_engine_is_400(self):
        model = tiny_model(4)
        eng = paged_engine(model, lora_capacity=0)
        srv = Server(eng, segment_steps=4)
        httpd = serve_http(srv)
        try:
            st, body = _post(httpd.server_address[1], "/adapters/load",
                             {"name": "x"})
            # permanently unsupported: 400, never a retryable 503
            assert st == 400 and "lora_capacity" in body["error"]
        finally:
            httpd.shutdown()
            httpd.server_close()
            srv.shutdown(timeout=WAIT)
            eng.close()
