"""paddle_tpu_torch's speculative decoding against paddle_tpu's, on the CPU.

The n-gram proposers (``inference/ngram.py``) are held EQUAL to the
reference's: the host index and proposer call for call, and the batched
device proposer on a fuzz of contexts against both the JAX device proposer
and the host index. ``generate_speculative`` and the dense and paged
engines' spec modes (host, device, and device with ``spec_draft="self"``;
MHA and GQA; bf16 and int8 pools) give the JAX spec engines' greedy
streams on pinned prompts token for token, and the port's own plain
streams token for token, with the same ``spec_stats``.

Not the same logits: the verify forward runs its projections at M = B * W
rows where the one-token step runs M = B, and the CPU's matmul (MKL) does
not give a row the same bits at every M
(``test_cpu_matmul_rows_differ_across_m`` shows it). So the verify
logits differ from the one-token step's in the last bits, and a stream is
held equal to the plain one under the guard the other engine tests use:
every greedy choice along it beats the runner-up by at least ``MARGIN``.
For the same reason the int8 commit is held byte-equal to the reference's
at the primitive (both commit the same rows), and the engines' pools only
token-wise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ngram as jax_ngram
from paddle_tpu.inference.generation import CausalLMEngine as JaxCausal
from paddle_tpu.inference.generation import \
    ContinuousBatchingEngine as JaxDense
from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxPaged
from paddle_tpu_torch import (CausalLMEngine, ContinuousBatchingEngine,
                              GenerationConfig,
                              PagedContinuousBatchingEngine)
from paddle_tpu_torch.inference import ngram

from test_torch_llama import make_pair

MARGIN = 1e-4
REP = np.tile(np.array([5, 6, 7, 8], np.int32), 6)       # drafts accepted
RND = np.random.RandomState(0).randint(0, 64, (9,)).astype(np.int32)
PAGED = dict(max_batch=2, num_pages=24, page_size=8, max_pages=16)
MODES = [("host", "ngram"), ("device", "ngram"), ("device", "self")]

_PAIRS = {}


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


def pair(kv_heads=None):
    """The 2-layer tiny JAX model and its port twin (one per head layout,
    built once per module)."""
    if kv_heads not in _PAIRS:
        _PAIRS[kv_heads] = make_pair(2, kv_heads, seed=0)[:2]
    return _PAIRS[kv_heads]


def cfgs(n, spec=False, **kw):
    """(port config, JAX config) of ``n`` greedy tokens, no eos."""
    kw = dict(max_new_tokens=n, eos_token_id=None, speculative=spec, **kw)
    return GenerationConfig(**kw), JaxGenCfg(**kw)


def run(eng, prompts, configs, steps=4):
    rids = [eng.add_request(p, c) for p, c in zip(prompts, configs)]
    while eng.decode_segment(steps):
        pass
    done = eng.collect_finished()
    return [np.asarray(done[r]).tolist() for r in rids]


def assert_margins(tm, prompts, streams):
    """Every greedy choice along ``streams`` beats the runner-up logit by
    at least MARGIN under the port's uncached forward."""
    for p, s in zip(prompts, streams):
        seq = np.concatenate([p, s[:-1]]).astype(np.int64)
        with torch.no_grad():
            logits = tm(torch.from_numpy(seq)[None])[0, len(p) - 1:]
        assert logits.argmax(-1).tolist() == list(s)
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() >= MARGIN, \
            "pinned prompt has a near-tie: pick another"


# -- the proposers --------------------------------------------------------------


def test_ngram_index_and_proposer_match_reference():
    """The host index and the incremental proposer, call for call, on
    contexts over a small vocabulary (real n-gram collisions); the
    validation errors are the reference's."""
    rng = np.random.RandomState(3)
    for trial in range(30):
        ctx = rng.randint(0, 5, (int(rng.randint(1, 40)),)).tolist()
        n_max, k = 1 + trial % 4, 1 + trial % 7
        assert (ngram.NgramIndex(n_max).propose(ctx, k)
                == jax_ngram.NgramIndex(n_max).propose(ctx, k))
        port = ngram.NgramProposer(ctx[:3], k, n_max)
        ref = jax_ngram.NgramProposer(ctx[:3], k, n_max)
        for t in ctx[3:]:
            assert port.propose() == ref.propose()
            port.extend([t])
            ref.extend([t])
        assert (port.ctx, port.proposed) == (ref.ctx, ref.proposed)
    assert ngram.NgramIndex(3).propose([1, 2, 3, 9, 1, 2, 3], 2) == [9, 1]
    assert ngram.NgramIndex(2).propose([4, 5, 6], 3) == [6, 6, 6]
    for make in (lambda m: m.NgramProposer([1], draft_k=0),
                 lambda m: m.NgramIndex(0)):
        with pytest.raises(ValueError) as want:
            make(jax_ngram)
        with pytest.raises(ValueError) as got:
            make(ngram)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [3, 6])
def test_propose_device_fuzz_matches_reference_and_host(k):
    """The batched device proposer against the JAX one on every row, and
    against the host index wherever the whole context fits the ring;
    lengths sweep the ring's edges (0, 1, H) and rows whose context
    outgrew it."""
    H, n_max, cases = 64, 3, 64
    rng = np.random.RandomState(7 + k)
    rows = rng.randint(0, 6, (cases, H)).astype(np.int32)
    lens = rng.randint(0, H + 1, (cases,)).astype(np.int32)
    lens[:3] = [0, 1, H]
    got = ngram.propose_device(torch.from_numpy(rows),
                               torch.from_numpy(lens), k, n_max)
    assert got.dtype == torch.int32 and got.shape == (cases, k)
    want = np.asarray(jax_ngram.propose_device(rows, lens, k, n_max))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(cases):
        if lens[i] >= 1:
            ctx = rows[i, :lens[i]].tolist()
            assert (got[i].tolist()
                    == ngram.NgramIndex(n_max).propose(ctx, k)), (i, ctx)


# -- configs and knobs ----------------------------------------------------------


def _same_error(make):
    with pytest.raises(ValueError) as want:
        make(True)
    with pytest.raises(ValueError) as got:
        make(False)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [0, 300, 2.5, True])
def test_config_draft_k_validation_matches_reference(bad):
    _same_error(lambda jax: (JaxGenCfg if jax else GenerationConfig)(
        draft_k=bad))
    good = GenerationConfig(speculative=True, draft_k=4)
    assert good.speculative and good.draft_k == 4
    assert vars(GenerationConfig(speculative=1, draft_k=np.int64(2))) == \
        vars(JaxGenCfg(speculative=1, draft_k=np.int64(2)))


@pytest.mark.parametrize("kw", [
    dict(draft_k=-1), dict(draft_k=257), dict(draft_k=True),
    dict(draft_k=4, spec_mode="gpu"), dict(draft_k=4, spec_draft="eagle"),
    dict(draft_k=4, spec_history=7), dict(draft_k=4, spec_history=True),
    dict(draft_k=4, spec_history=2.5), dict(draft_k=4, spec_history="128")])
def test_engine_knob_validation_matches_reference(kw):
    jm, tm = pair()
    for dense in (True, False):
        def make(jax):
            m = jm if jax else tm
            if dense:
                cls = JaxDense if jax else ContinuousBatchingEngine
                return cls(m, max_batch=1, max_len=64, **kw)
            cls = JaxPaged if jax else PagedContinuousBatchingEngine
            return cls(m, max_batch=1, num_pages=8, page_size=8,
                       max_pages=4, **kw)
        _same_error(make)


def test_engine_knobs_defaults_eligibility_and_idle_only():
    jm, tm = pair()
    eng = PagedContinuousBatchingEngine(tm, max_batch=1, num_pages=8,
                                        page_size=8, max_pages=4, draft_k=3,
                                        spec_mode="device", spec_draft="self",
                                        spec_history=64)
    assert (eng.draft_k, eng.spec_mode, eng.spec_draft,
            eng.spec_history, eng.ngram_max) == (3, "device", "self", 64, 3)
    d = ContinuousBatchingEngine(tm, max_batch=1, max_len=64, draft_k=6)
    jd = JaxDense(jm, max_batch=1, max_len=64, draft_k=6)
    assert (d.spec_mode, d.spec_draft, d.spec_history) == ("host", "ngram",
                                                          128)
    for kw in (dict(), dict(draft_k=3), dict(draft_k=200), dict(spec=False),
               dict(do_sample=True)):
        spec = kw.pop("spec", True)
        c, jc = cfgs(4, spec, **kw)
        assert d._spec_k_for(c) == jd._spec_k_for(jc)
    assert ContinuousBatchingEngine(tm, max_batch=1, max_len=64
                                    )._spec_k_for(cfgs(4, True)[0]) == 0
    # the knobs change on an idle engine only
    d.add_request(REP[:8], cfgs(20, True)[0])
    for name, value in (("draft_k", 2), ("spec_mode", "device"),
                        ("spec_draft", "self")):
        with pytest.raises(RuntimeError, match=name):
            setattr(d, name, value)
    with pytest.raises(ValueError, match="spec_mode"):
        d.spec_mode = "gpu"
    assert (d.draft_k, d.spec_mode, d.spec_draft) == (6, "host", "ngram")


# -- the model's verify forwards ----------------------------------------------


def test_cpu_matmul_rows_differ_across_m():
    """Why the spec streams are held token for token and not logit for
    logit: the CPU's matmul gives a row other bits at M = 12 than at M = 3
    (the verify window's M against the one-token step's), so the verify
    forward's position 0 is the one-token step's only to rounding, while
    its argmax is the same."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 176, generator=g) * 0.02
    x = torch.randn(3, 4, 64, generator=g)
    assert not torch.equal((x @ w)[:, :1], x[:, :1] @ w)
    _, tm = pair()
    lens = torch.tensor([5, 30, 0], dtype=torch.int32)
    live = torch.tensor([True, True, False])
    ids = torch.from_numpy(REP[:12].reshape(3, 4).astype(np.int32))
    with torch.no_grad():
        spec, _ = tm.forward_decode_spec(ids, tm.init_cache(3, 32), lens,
                                         live)
        one, _ = tm.forward_decode_ragged(ids[:, :1], tm.init_cache(3, 32),
                                          lens, live)
    diff = (spec[:, 0] - one[:, 0]).abs().max().item()
    assert 0 < diff < 1e-5
    assert torch.equal(spec[:, 0].argmax(-1), one[:, 0].argmax(-1))


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_verify_forwards_match_reference(kv_heads):
    """Both verify forwards against the JAX model's on the same caches:
    logits within the fp32 tolerance, the dense cache's rows and the page
    pool's pages likewise, dead rows and positions past the cache dropped
    (the port's sink page takes them)."""
    from paddle_tpu.core.autograd import no_grad

    jm, tm = pair(kv_heads)
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 256, (3, 3)).astype(np.int32)
    lens = np.array([5, 30, 0], np.int32)
    live = np.array([True, True, False])
    t = [torch.from_numpy(a) for a in (ids, lens, live)]
    j = [jnp.asarray(a) for a in (ids, lens, live)]
    with no_grad():
        jl, jc = jm.forward_decode_spec(j[0], jm.init_cache(3, 32), *j[1:])
    with torch.no_grad():
        tl, tc = tm.forward_decode_spec(t[0], tm.init_cache(3, 32), *t[1:])
    np.testing.assert_allclose(tl.numpy(), np.asarray(getattr(jl, "value",
                                                              jl)),
                               atol=1e-5, rtol=1e-5)
    for (a, b), (c, d) in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(d), atol=1e-5)
        assert not a[2].any() and not b[2].any()     # the dead row
    table = np.full((3, 4), -1, np.int32)
    table[0, :2] = [5, 1]
    table[1, :4] = [0, 2, 3, 7]
    with no_grad():
        jl, jp, aux = jm.forward_decode_spec_paged(
            j[0], jm.init_paged_cache(8, 8), jnp.asarray(table), *j[1:])
    with torch.no_grad():
        tl, tp, taux = tm.forward_decode_spec_paged(
            t[0], tm.init_paged_cache(8, 8), torch.from_numpy(table), *t[1:])
    assert taux == [None] * 2
    np.testing.assert_allclose(tl.numpy(), np.asarray(getattr(jl, "value",
                                                              jl)),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(tp, jp):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x[:8].numpy(), np.asarray(y),
                                       atol=1e-5)


def test_int8_commit_is_the_references_byte_for_byte():
    """The int8 verify window and its post-acceptance commit: the port's
    window rows and snapshot, committed by both engines' commit on the
    same pools (accepting 0 to W rows per row), leave the same pool bytes
    and scales; the snapshot is what the pools held before the window."""
    jm, tm = pair(2)
    rng = np.random.RandomState(9)
    table = np.full((3, 4), -1, np.int32)
    table[0, :2] = [5, 1]
    table[1, :4] = [0, 2, 3, 7]
    pools = tm.init_paged_cache(8, 8, kv_dtype="int8")
    with torch.no_grad():               # some history in the pages first
        for _ in range(3):
            ids = torch.from_numpy(rng.randint(0, 256, (3, 4)).astype(
                np.int32))
            tm.forward_decode_spec_paged(
                ids, pools, torch.from_numpy(table),
                torch.tensor([2, 20, 0], dtype=torch.int32),
                torch.tensor([True, True, False]))
    before = [tuple(t.clone() for t in e) for e in pools]
    lens = torch.tensor([6, 25, 0], dtype=torch.int32)
    live = torch.tensor([True, True, False])
    ids = torch.from_numpy(rng.randint(0, 256, (3, 4)).astype(np.int32))
    with torch.no_grad():
        _, pools, aux = tm.forward_decode_spec_paged(
            ids, pools, torch.from_numpy(table), lens, live)
    n_acc = torch.tensor([2, 4, 0], dtype=torch.int32)
    eng = PagedContinuousBatchingEngine(tm, max_batch=3, num_pages=8,
                                        page_size=8, max_pages=4,
                                        kv_dtype="int8")
    eng.caches = pools
    P = 8
    for (sk, sv, sks, svs, *_), (k, v, ks, vs), page in zip(
            aux, before, [a[6] for a in aux]):
        flat = page.reshape(-1)
        assert torch.equal(sk, k[flat]) and torch.equal(sv, v[flat])
        assert torch.equal(sks, ks) and torch.equal(svs, vs)
    j_pools = [tuple(jnp.asarray(t[:P].numpy()) for t in e) for e in pools]
    # the reference's scale tables have no sink row
    j_aux = [tuple(jnp.asarray((t[:P] if i in (2, 3) else t).numpy())
                   for i, t in enumerate(a)) for a in aux]
    j_pools, _ = JaxDense._commit_spec_rows(
        None, (j_pools, jnp.asarray(table)), j_aux, jnp.asarray(n_acc))
    eng._commit_spec_rows(aux, n_acc)
    for got, want in zip(pools, j_pools):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[:P].numpy(), np.asarray(b))


# -- generate_speculative -------------------------------------------------------


@pytest.mark.parametrize("n,max_len,eos", [(24, 256, None), (8, 32, None),
                                           (24, 256, "mid")])
def test_generate_speculative_matches_reference(n, max_len, eos):
    """The offline path: the JAX engine's tokens and statistics, and the
    port's own ``generate`` (one-token tail steps near ``max_len``; an eos
    inside an accepted window stops the stream and pads it with eos)."""
    jm, tm = pair()
    eng = CausalLMEngine(tm, max_batch=1, max_len=max_len)
    jeng = JaxCausal(jm, max_batch=1, max_len=max_len)
    c, jc = cfgs(n)
    free = eng.generate(REP[None], c)[0, len(REP):]
    assert_margins(tm, [REP], [free])
    if eos == "mid":
        c, jc = (GenerationConfig(max_new_tokens=n, eos_token_id=int(free[7])),
                 JaxGenCfg(max_new_tokens=n, eos_token_id=int(free[7])))
    want = np.asarray(jeng.generate_speculative(REP[None], jc, draft_k=6))
    got = eng.generate_speculative(REP[None], c, draft_k=6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, eng.generate(REP[None], c))
    assert eng.last_spec_stats == jeng.last_spec_stats
    assert eng.last_spec_stats["accepted_draft_tokens"] > 0
    with pytest.raises(ValueError, match="greedy-only"):
        eng.generate_speculative(REP[None], GenerationConfig(do_sample=True))


# -- the continuous engines -----------------------------------------------------


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_dense_spec_streams_match_reference_and_plain(kv_heads):
    jm, tm = pair(kv_heads)
    c, jc = cfgs(24)
    sc, sjc = cfgs(24, True)
    plain = run(ContinuousBatchingEngine(tm, max_batch=2, max_len=128),
                [REP, RND], [c, c])
    assert_margins(tm, [REP, RND], plain)
    stats = {}
    for mode, draft in MODES:
        eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=128,
                                       draft_k=6, spec_mode=mode,
                                       spec_draft=draft)
        got = run(eng, [REP, RND], [sc, sc])
        assert got == plain, (mode, draft)
        st = stats[mode, draft] = eng.spec_stats()
        assert st["accepted"] > 0 and st["tokens_per_forward"] > 1.0
        assert st["emitted"] == st["slot_steps"] + st["accepted"]
        assert (st["host_syncs"] > 0) is (mode == "host")
        # the JAX engine in every mode for MHA; for GQA in host mode (its
        # modes give one stream, tests/test_spec_device.py)
        if kv_heads is None or mode == "host":
            jeng = JaxDense(jm, max_batch=2, max_len=128, draft_k=6,
                            spec_mode=mode, spec_draft=draft)
            assert got == run(jeng, [REP, RND], [sjc, sjc]), (mode, draft)
            assert st == jeng.spec_stats()
    # the same drafts in both modes: the same accounting, bar the reads
    host, dev = stats["host", "ngram"], stats["device", "ngram"]
    assert {k: v for k, v in host.items() if "host_syncs" not in k} == {
        k: v for k, v in dev.items() if "host_syncs" not in k}


@pytest.mark.parametrize("kv_dtype,kv_heads", [("bf16", None), ("bf16", 2),
                                               ("int8", None), ("int8", 2)])
def test_paged_spec_streams_match_reference_and_plain(kv_dtype, kv_heads):
    """The paged engine (debug_pages on) in every spec mode: the plain
    streams and the JAX spec engine's (host mode; its modes give one
    stream; int8 with GQA against the port's plain streams only: its JAX
    compile is the dearest, and ``test_torch_kv_quant.py`` holds the
    port's int8 GQA engine to the JAX one), every page back afterwards."""
    jm, tm = pair(kv_heads)
    kw = dict(PAGED, kv_dtype=kv_dtype, debug_pages=True)
    c, _ = cfgs(24)
    sc, sjc = cfgs(24, True)
    plain = run(PagedContinuousBatchingEngine(tm, **kw), [REP, RND], [c, c])
    assert_margins(tm, [REP, RND], plain)
    if (kv_dtype, kv_heads) != ("int8", 2):     # its compile is the dearest
        want = run(JaxPaged(jm, draft_k=6, **kw), [REP, RND], [sjc, sjc])
        assert plain == want
    for mode, draft in MODES:
        eng = PagedContinuousBatchingEngine(tm, draft_k=6, spec_mode=mode,
                                            spec_draft=draft, **kw)
        assert run(eng, [REP, RND], [sc, sc]) == plain, (mode, draft)
        assert eng.spec_stats()["accepted"] > 0
        assert eng.alloc.free_pages == PAGED["num_pages"]
        eng.alloc.check()


_EDGES = {}


def edge_cases():
    """(eos, [(max_len, config kwargs, the JAX spec engine's stream)]): an
    eos id from inside the free stream, a budget below the window, a stop
    at max_len. The JAX streams come from host-mode engines built once per
    module (its modes give one stream)."""
    if not _EDGES:
        jm, tm = pair()
        free = run(ContinuousBatchingEngine(tm, max_batch=1, max_len=128),
                   [REP], [cfgs(24)[0]])[0]
        eos = int(free[7])
        jax_engines = {n: JaxDense(jm, max_batch=1, max_len=n, draft_k=6)
                       for n in (128, 32)}
        cases = []
        for max_len, kw in ((128, dict(max_new_tokens=24, eos_token_id=eos)),
                            (128, dict(max_new_tokens=3, eos_token_id=None)),
                            (32, dict(max_new_tokens=8, eos_token_id=None))):
            want = run(jax_engines[max_len], [REP],
                       [JaxGenCfg(speculative=True, **kw)])
            cases.append((max_len, kw, want))
        _EDGES["v"] = free, eos, cases
    return _EDGES["v"]


@pytest.mark.parametrize("mode,draft", MODES)
def test_eos_budget_and_max_len_edges(mode, draft):
    """An eos landing inside an accepted window (cut there, the slot
    retired and reusable), a budget below the window, a stop at
    ``max_len`` (acceptance capped there, no clamped write): each the
    plain stream and the JAX spec engine's."""
    _, tm = pair()
    free, eos, cases = edge_cases()
    for max_len, kw, want in cases:
        plain = run(ContinuousBatchingEngine(tm, max_batch=1,
                                             max_len=max_len),
                    [REP], [GenerationConfig(**kw)])
        eng = ContinuousBatchingEngine(tm, max_batch=1, max_len=max_len,
                                       draft_k=6, spec_mode=mode,
                                       spec_draft=draft)
        got = run(eng, [REP], [GenerationConfig(speculative=True, **kw)])
        assert got == plain == want, (max_len, kw)
        assert len(got[0]) == (kw["max_new_tokens"] if kw["eos_token_id"]
                               is None else free.index(eos) + 1)
        assert eng.free_slots() == 1
        assert len(run(eng, [RND], [cfgs(6, True)[0]])[0]) == 6
    assert eng.spec_stats()["accepted"] > 0


@pytest.mark.parametrize("mode", ["host", "device"])
def test_mixed_batch_rides_one_spec_program(mode):
    """A speculating, a plain greedy and a sampled request in one batch:
    the batch runs the spec program (its sampled twin while the sampled
    request lives); the greedy rows keep the plain streams, and the
    sampled row draws the tokens the plain sampled program draws (its
    seed's stream at its positions)."""
    _, tm = pair()
    samp = GenerationConfig(max_new_tokens=10, do_sample=True,
                            temperature=0.8, top_k=20, seed=7)
    c, sc = cfgs(20)[0], cfgs(20, True)[0]
    plain_eng = ContinuousBatchingEngine(tm, max_batch=3, max_len=128)
    plain = run(plain_eng, [REP, RND, REP], [c, c, samp])
    eng = ContinuousBatchingEngine(tm, max_batch=3, max_len=128, draft_k=6,
                                   spec_mode=mode)
    got = run(eng, [REP, RND, REP], [sc, c, samp])
    assert got == plain
    assert len(got[2]) == 10
    # the spec row finishes first; the plain segment runs the rest
    spec = (("spec_step", 6) if mode == "host"
            else ("spec_device", 4, 6, "ngram"))
    keys = set(eng.programs.captures)
    assert spec + ("sampled",) in keys and keys <= {
        spec, spec + ("sampled",), ("segment", 4),
        ("segment", 4, "sampled")}, keys
    assert all(n == 1 for n in eng.programs.captures.values())


@pytest.mark.parametrize("mode,draft", MODES)
def test_warmup_captures_the_spec_programs_and_nothing_after(mode, draft):
    """``warmup()`` captures the programs the knobs select, under their
    keys; a speculating serve then captures nothing. Changing a knob on
    the idle engine drops the spec programs (the next warmup captures the
    new ones) and keeps the plain segment's."""
    _, tm = pair()
    eng = PagedContinuousBatchingEngine(tm, draft_k=4, spec_mode=mode,
                                        spec_draft=draft,
                                        **dict(PAGED, max_batch=3))
    eng.warmup(4)
    spec = (("spec_step", 4) if mode == "host"
            else ("spec_device", 4, 4, draft))
    assert set(eng.programs.captures) == {
        ("segment", 4), ("segment", 4, "sampled"), spec,
        spec + ("sampled",)}
    warm = dict(eng.programs.captures)
    c, sc = cfgs(12)[0], cfgs(12, True)[0]
    samp = GenerationConfig(max_new_tokens=6, do_sample=True, seed=3)
    out = run(eng, [REP, RND, REP[:8]], [sc, c, samp])
    assert eng.programs.captures == warm
    assert eng.spec_stats()["forwards"] > 0
    assert out[:2] == run(PagedContinuousBatchingEngine(tm, **PAGED),
                          [REP, RND], [c, c])
    eng.draft_k = 2
    assert set(eng.programs._graphs) == {("segment", 4),
                                         ("segment", 4, "sampled")}
    eng.warmup(4)
    spec2 = (("spec_step", 2) if mode == "host"
             else ("spec_device", 4, 2, draft))
    assert eng.programs.captures[spec2] == 1
