"""paddle_tpu_torch's multi-tenant LoRA against paddle_tpu's, on the CPU.

- ``AdapterRegistry``: the same sequence of load, acquire, unload
  (deferred), release, recycle and reload on both sides gives the same
  indices, salts, ``resident()`` snapshots and banks (alpha folding, rank
  padding, untouched targets zeroed on a recycled index), and the same
  validation errors; the port's bank tensors keep their addresses through
  every step (captured decode programs hold them).
- The model's serving forwards with ``lora`` (a one-shot prefill, a chunk
  at an offset, the one-token step, the ragged and paged decode steps over
  pools in the model's dtype and in int8, both verify forwards) against
  the JAX model's on the same weights, bank and per-row indices, at MHA
  and GQA, within the fp32 tolerance ``TOL``.
- The dense and paged engines with adapters against the JAX engines on
  the same weights and adapters: the greedy streams of a mixed batch
  (base and two adapters) equal, token for token, on pinned prompts whose
  every greedy pick clears ``MARGIN`` under the adapter's own forward; with
  the prefix cache, the same hits in the same adapter namespaces.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.autograd import no_grad
from paddle_tpu.inference.generation import \
    ContinuousBatchingEngine as JaxDense
from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxPaged
from paddle_tpu.serving.adapters import AdapterRegistry as JaxRegistry
from paddle_tpu_torch import (ContinuousBatchingEngine, GenerationConfig,
                              PagedContinuousBatchingEngine)
from paddle_tpu_torch.serving import AdapterRegistry

from test_torch_llama import make_pair

TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-4
TARGETS = ("q", "k", "v", "o", "gate", "up", "down")

_PAIRS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs (the tiny model's ops
    are small; a thread pool waits for its threads at every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(kv_heads=None):
    """The 2-layer tiny JAX model and its port twin, one per head layout."""
    if kv_heads not in _PAIRS:
        _PAIRS[kv_heads] = make_pair(2, kv_heads, seed=0)[:2]
    return _PAIRS[kv_heads]


def factors(tm, seed, targets=TARGETS, rank=2, scale=0.3, per_layer=False):
    """Seeded numpy (A, B) factors per target, from the model's
    ``lora_shapes``: shared by every layer, or ``[L, r, d]`` per layer."""
    L, shapes = tm.lora_shapes(targets)
    rng = np.random.default_rng(seed)
    lead = (L,) if per_layer else ()
    return {t: (rng.standard_normal(lead + (rank, d_in)).astype(np.float32)
                * scale,
                rng.standard_normal(lead + (d_out, rank)).astype(np.float32)
                * scale)
            for t, (d_in, d_out) in shapes.items()}


def _j(x):
    return np.asarray(getattr(x, "value", x), np.float32)


# -- the registry ---------------------------------------------------------------


def registries(tm, capacity=3, rank=4, targets=("q", "v", "gate")):
    L, shapes = tm.lora_shapes(targets)
    return (AdapterRegistry(capacity, rank, targets, L, shapes,
                            torch.float32, "eng-port", device="cpu"),
            JaxRegistry(capacity, rank, targets, L, shapes, np.float32,
                        "eng-jax"))


def assert_same_state(port, ref, ptrs):
    assert port.resident() == ref.resident()
    for i in range(port.capacity + 1):
        assert port.salt(i) == ref.salt(i)
    for t in port.targets:
        for a, b in zip(port.bank[t], ref.bank[t]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [x.data_ptr() for ab in port.bank.values() for x in ab] == ptrs


def test_registry_sequence_matches_reference():
    """Load (alpha folded, rank padded, shared and per-layer factors, a
    subset of the targets), acquire, a deferred unload, release, recycle of
    the freed index with other targets (the untouched ones zeroed), a
    reload of the first name (a fresh salt) and ``release_all``: after
    every step the two registries agree, and the port's bank never moves."""
    _, tm = pair()
    port, ref = registries(tm)
    ptrs = [x.data_ptr() for ab in port.bank.values() for x in ab]
    assert_same_state(port, ref, ptrs)
    steps = [
        ("load", "a", factors(tm, 1, ("q", "v", "gate"), rank=2), 4),
        ("load", "b", factors(tm, 2, ("q", "gate"), rank=4,
                              per_layer=True), None),
        ("acquire", "a"), ("acquire", "a"), ("acquire", "b"),
        ("unload", "a"),
        ("release", 1), ("release", 1),
        ("load", "c", factors(tm, 3, ("v",), rank=3), 1.5),
        ("unload", "b"),
        ("release", 2),
        ("load", "a", factors(tm, 4, ("q",), rank=1), None),
        ("acquire", "c"), ("unload", "c"), ("release_all",),
        ("load", "d", factors(tm, 5, ("gate", "q"), rank=4), 8),
    ]
    for op, *args in steps:
        if op == "load":
            name, params, alpha = args
            got = port.load(name, params, alpha=alpha)
            want = ref.load(name, params, alpha=alpha)
        else:
            got = getattr(port, op)(*args)
            want = getattr(ref, op)(*args)
        assert got == want, (op, args)
        assert_same_state(port, ref, ptrs)
    # a deferred name is refused while it drains, on both sides
    port.acquire("a")
    ref.acquire("a")
    assert port.unload("a") is ref.unload("a") is False
    for reg in (port, ref):
        with pytest.raises(ValueError, match="unknown adapter"):
            reg.acquire("a")
    port.warmup()
    ref.warmup()
    assert_same_state(port, ref, ptrs)


def _ab(r=2, d_in=64, d_out=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((r, d_in)).astype(np.float32),
            rng.standard_normal((d_out, r)).astype(np.float32))


BAD_LOADS = {
    "name_empty": lambda: ("", {"q": _ab()}),
    "name_long": lambda: ("x" * 257, {"q": _ab()}),
    "name_type": lambda: (7, {"q": _ab()}),
    "duplicate": lambda: ("a", {"q": _ab()}),
    "params_empty": lambda: ("b", {}),
    "params_type": lambda: ("b", [("q", _ab())]),
    "unknown_target": lambda: ("b", {"nope": _ab()}),
    "not_a_pair": lambda: ("b", {"q": _ab()[0]}),
    "a_width": lambda: ("b", {"q": _ab(d_in=32)}),
    "a_layers": lambda: ("b", {"q": (np.zeros((3, 2, 64), np.float32),
                                     np.zeros((64, 2), np.float32))}),
    "rank_over": lambda: ("b", {"q": _ab(r=5)}),
    "b_rank": lambda: ("b", {"q": (_ab()[0], _ab()[1][:, :1])}),
    "b_width": lambda: ("b", {"q": (_ab()[0], _ab(d_out=32)[1])}),
}


@pytest.mark.parametrize("case", sorted(BAD_LOADS))
def test_registry_load_errors_match_reference(case):
    """Every refused load gives the reference's message, and the bank,
    names and free list are untouched by it."""
    _, tm = pair()
    port, ref = registries(tm, capacity=2, targets=("q", "v"))
    ptrs = [x.data_ptr() for ab in port.bank.values() for x in ab]
    for reg in (port, ref):
        reg.load("a", {"q": _ab(seed=9)})
    name, params = BAD_LOADS[case]()
    with pytest.raises(ValueError) as want:
        ref.load(name, params)
    with pytest.raises(ValueError) as got:
        port.load(name, params)
    assert str(got.value) == str(want.value)
    assert_same_state(port, ref, ptrs)


@pytest.mark.parametrize("kw", [
    dict(capacity=0), dict(capacity=True), dict(rank=0), dict(rank=2.0),
    dict(targets=()), dict(targets=("q", "zz")), "full", "unload_unknown"])
def test_registry_construction_and_lifecycle_errors_match_reference(kw):
    _, tm = pair()
    L, shapes = tm.lora_shapes(("q", "v"))
    if kw in ("full", "unload_unknown"):
        port, ref = registries(tm, capacity=1, targets=("q", "v"))
        for reg in (port, ref):
            reg.load("a", {"q": _ab()})
        call = ((lambda reg: reg.load("b", {"q": _ab()})) if kw == "full"
                else (lambda reg: reg.unload("ghost")))
        with pytest.raises(ValueError) as want:
            call(ref)
        with pytest.raises(ValueError) as got:
            call(port)
    else:
        args = dict(capacity=2, rank=4, targets=("q", "v"))
        args.update(kw)
        with pytest.raises(ValueError) as want:
            JaxRegistry(args["capacity"], args["rank"], args["targets"], L,
                        shapes, np.float32, "eng-jax")
        with pytest.raises(ValueError) as got:
            AdapterRegistry(args["capacity"], args["rank"], args["targets"],
                            L, shapes, torch.float32, "eng-port",
                            device="cpu")
    assert str(got.value) == str(want.value)


def test_engine_lora_knobs_match_reference():
    """``lora_capacity`` validation, ``lora_shapes``' refusal of an unknown
    target, and the engines' admission verdicts for an adapter request on
    an engine without adapters or naming an unknown adapter."""
    jm, tm = pair()
    for bad in (-1, True, 1.5):
        with pytest.raises(ValueError) as want:
            JaxDense(jm, max_batch=1, max_len=16, lora_capacity=bad)
        with pytest.raises(ValueError) as got:
            ContinuousBatchingEngine(tm, max_batch=1, max_len=16,
                                     lora_capacity=bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jm.lora_shapes(("q", "qq"))
    with pytest.raises(ValueError) as got:
        tm.lora_shapes(("q", "qq"))
    assert str(got.value) == str(want.value)
    assert tm.lora_shapes(TARGETS) == jm.lora_shapes(TARGETS)
    for cap in (0, 1):
        j = JaxDense(jm, max_batch=1, max_len=16, lora_capacity=cap)
        t = ContinuousBatchingEngine(tm, max_batch=1, max_len=16,
                                     lora_capacity=cap)
        with pytest.raises(ValueError) as want:
            j.add_request(np.arange(3, dtype=np.int32),
                          JaxGenCfg(max_new_tokens=2, adapter="x"))
        with pytest.raises(ValueError) as got:
            t.add_request(np.arange(3, dtype=np.int32),
                          GenerationConfig(max_new_tokens=2, adapter="x"))
        assert str(got.value) == str(want.value)
        assert t.free_slots() == 1
        if cap:
            assert t.load()["lora"] == j.load()["lora"]
        else:
            with pytest.raises(RuntimeError) as want:
                j.load_adapter("x", {})
            with pytest.raises(RuntimeError) as got:
                t.load_adapter("x", {})
            assert str(got.value) == str(want.value)
        t.close()
        j.close()


# -- the serving forwards with lora ----------------------------------------------


def banks(jm, tm, capacity=2, rank=4):
    """The same bank on both sides: index 0 zeros, then ``capacity``
    adapters of seeded per-layer factors on every target."""
    port, ref = registries(tm, capacity=capacity, rank=rank,
                           targets=TARGETS)
    for i in range(capacity):
        p = factors(tm, 40 + i, rank=rank, scale=0.2, per_layer=True)
        port.load(f"a{i}", p, alpha=2 * rank)
        ref.load(f"a{i}", p, alpha=2 * rank)
    return port.bank, ref.bank


def _rand_caches(cfg, b, max_len, seed):
    rng = np.random.RandomState(seed)
    shape = (b, max_len, cfg.kv_heads, cfg.head_dim)
    arrs = [(rng.randn(*shape).astype(np.float32),
             rng.randn(*shape).astype(np.float32))
            for _ in range(cfg.num_hidden_layers)]
    return ([(jnp.asarray(k), jnp.asarray(v)) for k, v in arrs],
            [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
             for k, v in arrs])


FORWARDS = ("prefill_chunk_step", "ragged", "paged_bf16", "paged_int8",
            "spec", "spec_paged")


@pytest.mark.parametrize("kind", FORWARDS)
@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_serving_forwards_with_lora_match_reference(kind, kv_heads):
    """Rows under the base model and two adapters in one batch: logits
    within TOL of the JAX forward's at every call, the caches likewise."""
    jm, tm = pair(kv_heads)
    cfg = tm.config
    tb, jb = banks(jm, tm)
    idx = np.array([1, 0, 2], np.int32)
    tl_ = (tb, torch.from_numpy(idx))
    jl_ = (jb, jnp.asarray(idx))
    rng = np.random.RandomState(7)

    def same(t_out, j_out):
        np.testing.assert_allclose(t_out.numpy(), _j(j_out), **TOL)

    if kind == "prefill_chunk_step":
        jc, tc = _rand_caches(cfg, 3, 32, 8)
        ids = rng.randint(0, cfg.vocab_size, (3, 8)).astype(np.int32)
        with no_grad():
            jl, jc = jm.forward_with_cache(jnp.asarray(ids), jc, 0,
                                           lora=jl_)
        with torch.no_grad():
            tl, tc = tm.forward_with_cache(torch.from_numpy(ids), tc, 0,
                                           lora=tl_)
        same(tl, jl)
        chunk = rng.randint(0, cfg.vocab_size, (3, 8)).astype(np.int32)
        with no_grad():
            jl, jc = jm.forward_with_cache(jnp.asarray(chunk), jc, 8,
                                           lora=jl_)
        with torch.no_grad():
            tl, tc = tm.forward_with_cache(torch.from_numpy(chunk), tc,
                                           torch.tensor(8, dtype=torch.int32),
                                           lora=tl_)
        same(tl, jl)
        tok = _j(jl)[:, -1].argmax(-1).astype(np.int32)
        for pos in (16, 17):
            with no_grad():
                jl, jc = jm.forward_with_cache(jnp.asarray(tok[:, None]), jc,
                                               pos, lora=jl_)
            with torch.no_grad():
                tl, tc = tm.forward_with_cache(torch.from_numpy(tok[:, None]),
                                               tc, pos, lora=tl_)
            same(tl, jl)
            tok = _j(jl)[:, 0].argmax(-1).astype(np.int32)
        for (a, b), (c, d) in zip(tc, jc):
            same(a, c)
            same(b, d)
        return
    tok = rng.randint(0, cfg.vocab_size, (3,)).astype(np.int32)
    lens = np.array([5, 11, 0], np.int32)
    live = np.array([True, True, False])
    t_in = [torch.from_numpy(a) for a in (lens, live)]
    j_in = [jnp.asarray(a) for a in (lens, live)]
    if kind in ("ragged", "spec"):
        jc, tc = _rand_caches(cfg, 3, 32, 9)
        if kind == "ragged":
            with no_grad():
                jl, jc = jm.forward_decode_ragged(
                    jnp.asarray(tok[:, None]), jc, *j_in, lora=jl_)
            with torch.no_grad():
                tl, tc = tm.forward_decode_ragged(
                    torch.from_numpy(tok[:, None]), tc, *t_in, lora=tl_)
        else:
            win = rng.randint(0, cfg.vocab_size, (3, 4)).astype(np.int32)
            with no_grad():
                jl, jc = jm.forward_decode_spec(jnp.asarray(win), jc, *j_in,
                                                lora=jl_)
            with torch.no_grad():
                tl, tc = tm.forward_decode_spec(torch.from_numpy(win), tc,
                                                *t_in, lora=tl_)
        same(tl, jl)
        for (a, b), (c, d) in zip(tc, jc):
            same(a, c)
            same(b, d)
        return
    table = np.full((3, 4), -1, np.int32)
    table[0, :2] = [5, 1]
    table[1, :2] = [0, 2]
    quant = "int8" if kind == "paged_int8" else "bf16"
    jp = jm.init_paged_cache(8, 8, kv_dtype=quant)
    tp = tm.init_paged_cache(8, 8, kv_dtype=quant)
    if kind == "spec_paged":
        win = rng.randint(0, cfg.vocab_size, (3, 4)).astype(np.int32)
        with no_grad():
            jl, jp, _ = jm.forward_decode_spec_paged(
                jnp.asarray(win), jp, jnp.asarray(table), *j_in, lora=jl_)
        with torch.no_grad():
            tl, tp, _ = tm.forward_decode_spec_paged(
                torch.from_numpy(win), tp, torch.from_numpy(table), *t_in,
                lora=tl_)
        same(tl, jl)
    else:
        for _ in range(3):
            with no_grad():
                jl, jp = jm.forward_decode_paged(
                    jnp.asarray(tok[:, None]), jp, jnp.asarray(table),
                    *j_in, lora=jl_)
            with torch.no_grad():
                tl, tp = tm.forward_decode_paged(
                    torch.from_numpy(tok[:, None]), tp,
                    torch.from_numpy(table), *t_in, lora=tl_)
            same(tl, jl)
            tok = np.where(live, _j(jl)[:, 0].argmax(-1), tok).astype(
                np.int32)
            lens = lens + live
            t_in = [torch.from_numpy(a) for a in (lens, live)]
            j_in = [jnp.asarray(a) for a in (lens, live)]
    for a, b in zip(tp, jp):
        if quant == "int8":
            # scales within fp32 ulps; int8 codes within one step where a
            # value sits on a rounding boundary
            for x, y in zip(a[2:], b[2:]):
                np.testing.assert_allclose(x[:8].numpy(), _j(y), rtol=1e-5)
            for x, y in zip(a[:2], b[:2]):
                d = np.abs(x[:8].numpy().astype(int)
                           - np.asarray(y).astype(int))
                assert d.max() <= 1
        else:
            for x, y in zip(a, b):
                np.testing.assert_allclose(x[:8].numpy(), _j(y), **TOL)


def test_lora_none_and_base_index_are_the_lora_free_forward():
    """``lora=None`` is the LoRA-free forward itself, and a row at index 0
    of a loaded bank gives that forward's logits bit for bit."""
    _, tm = pair()
    tb, _ = banks(*pair())
    ids = torch.from_numpy(
        np.random.RandomState(3).randint(0, 256, (2, 8)).astype(np.int32))
    with torch.no_grad():
        plain, _ = tm.forward_with_cache(ids, tm.init_cache(2, 16), 0)
        none, _ = tm.forward_with_cache(ids, tm.init_cache(2, 16), 0,
                                        lora=None)
        base, _ = tm.forward_with_cache(
            ids, tm.init_cache(2, 16), 0,
            lora=(tb, torch.zeros(2, dtype=torch.int32)))
        mixed, _ = tm.forward_with_cache(
            ids, tm.init_cache(2, 16), 0,
            lora=(tb, torch.tensor([0, 1], dtype=torch.int32)))
    assert torch.equal(none, plain) and torch.equal(base, plain)
    assert torch.equal(mixed[0], plain[0])
    assert not torch.equal(mixed[1], plain[1])


# -- the engines ---------------------------------------------------------------


PROMPTS = [np.array([3, 17, 9, 40, 2, 2, 71, 5, 9], np.int32),
           np.array([101, 7, 7, 250, 31, 18, 4], np.int32),
           np.array([3, 17, 9, 40, 2, 2, 71, 5, 9, 11, 12, 13], np.int32)]
ENGINE_ADAPTERS = (None, "a0", "a1")


def run(eng, prompts, configs, steps=4):
    rids = [eng.add_request(p, c) for p, c in zip(prompts, configs)]
    while eng.decode_segment(steps):
        pass
    done = eng.collect_finished()
    return [np.asarray(done[r]).tolist() for r in rids]


def load_both(eng, jeng, tm, n=2):
    for i in range(n):
        p = factors(tm, 60 + i, targets=("q", "v", "o", "down"), rank=3,
                    scale=0.5)
        assert eng.load_adapter(f"a{i}", p, alpha=3) == \
            jeng.load_adapter(f"a{i}", p, alpha=3)


def assert_lora_margins(tm, bank, prompts, streams, aidx):
    """Every greedy pick along each stream beats the runner-up logit by at
    least MARGIN under the port's prefill forward with the row's
    adapter."""
    for p, s, a in zip(prompts, streams, aidx):
        seq = np.concatenate([p, s[:-1]]).astype(np.int32)
        with torch.no_grad():
            logits, _ = tm.forward_with_cache(
                torch.from_numpy(seq)[None], tm.init_cache(1, len(seq)), 0,
                lora=(bank, torch.tensor([a], dtype=torch.int32)))
        logits = logits[0, len(p) - 1:]
        assert logits.argmax(-1).tolist() == list(s)
        top2 = logits.topk(2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() >= MARGIN, \
            "pinned prompt has a near-tie: pick another"


ENGINES = {
    "dense": (ContinuousBatchingEngine, JaxDense,
              dict(max_batch=3, max_len=64)),
    "paged": (PagedContinuousBatchingEngine, JaxPaged,
              dict(max_batch=3, num_pages=24, page_size=8, max_pages=8,
                   debug_pages=True)),
    "paged_prefix": (PagedContinuousBatchingEngine, JaxPaged,
                     dict(max_batch=3, num_pages=24, page_size=4,
                          max_pages=16, prefix_cache=True,
                          debug_pages=True)),
}


@pytest.mark.parametrize("kind,kv_heads", [("dense", None), ("paged", None),
                                           ("paged", 2),
                                           ("paged_prefix", None)])
def test_engine_streams_with_adapters_match_reference(kind, kv_heads):
    """One batch of a base request and two adapter requests, greedy, on
    the port's engine and the JAX one holding the same adapters: the same
    streams token for token (each pick clears MARGIN). With the prefix
    cache the prompts share a prefix across adapters, a second round warm
    hits only in its own namespace, and both engines count the same hits
    and tokens saved."""
    jm, tm = pair(kv_heads)
    make, jmake, kw = ENGINES[kind]
    lora = dict(lora_capacity=2, lora_rank=4,
                lora_targets=("q", "v", "o", "down"))
    eng, jeng = make(tm, **kw, **lora), jmake(jm, **kw, **lora)
    load_both(eng, jeng, tm)
    c = [GenerationConfig(max_new_tokens=10, adapter=a)
         for a in ENGINE_ADAPTERS]
    jc = [JaxGenCfg(max_new_tokens=10, adapter=a) for a in ENGINE_ADAPTERS]
    rounds = 2 if kind == "paged_prefix" else 1
    for _ in range(rounds):
        got = run(eng, PROMPTS, c)
        assert got == run(jeng, PROMPTS, jc)
        assert_lora_margins(tm, eng.adapters.bank, PROMPTS, got, [0, 1, 2])
    if kind == "paged_prefix":
        assert eng.alloc.prefix_hits == jeng.alloc.prefix_hits >= 3
        assert (eng.alloc.prefix_tokens_saved
                == jeng.alloc.prefix_tokens_saved)
    assert eng.load()["lora"] == jeng.load()["lora"]
    assert eng.adapters.resident()["resident"] == 2
    eng.close()
    jeng.close()
