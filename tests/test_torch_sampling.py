"""Sampling in paddle_tpu_torch against paddle_tpu: ``GenerationConfig``'s
sampling fields (the reference's validation, value for value), the
per-row filter and draw of ``inference/sampling.py`` against the JAX
``_sample_rows``, and sampling in the three engines (per-slot device
vectors, the sampled program beside the greedy one, no capture after
``warmup()``).

JAX's threefry keys are not torch's, so draws are compared as
distributions: the port's filtered support equals the support of the
reference's filter (run in JAX on the same logits), every token the JAX
sampler draws lies in it, and the frequencies of 4000 draws at fixed
seeds, on either side, pass a chi-square test against softmax(filtered
logits) at p >= 1e-3 (bins with an expected count under 5 merged).
Greedy rows are compared bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import _sample_rows as jax_sample_rows
from paddle_tpu_torch import (CausalLMEngine, ContinuousBatchingEngine,
                              GenerationConfig, PagedContinuousBatchingEngine)
from paddle_tpu_torch.inference.sampling import (SlotSampling, _uniform,
                                                 filtered_logits,
                                                 gumbel_noise, sample_rows)

from test_torch_engine import _prompts
from test_torch_llama import make_pair

N_DRAWS = 4000
P_MIN = 1e-3
V = 48
# (temperature, top_k, top_p) per row: plain, temperature only, top-k,
# top-p, both (top-p over the top-k-filtered logits), a cold row
PARAMS = [(1.0, 0, 1.0), (0.6, 0, 1.0), (1.0, 7, 1.0), (1.3, 0, 0.8),
          (0.9, 12, 0.7), (0.05, 0, 1.0)]
PAGED = dict(max_batch=3, num_pages=24, page_size=8, max_pages=8)
DENSE = dict(max_batch=3, max_len=64)
ENGINES = {
    "paged": lambda m: PagedContinuousBatchingEngine(m, **PAGED),
    "paged_int8": lambda m: PagedContinuousBatchingEngine(
        m, kv_dtype="int8", **PAGED),
    "dense": lambda m: ContinuousBatchingEngine(m, **DENSE),
}
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95)


# -- GenerationConfig ---------------------------------------------------------


BAD_CONFIGS = [
    dict(max_new_tokens=0), dict(max_new_tokens=2 ** 31),
    dict(max_new_tokens=True), dict(max_new_tokens=1.0),
    dict(temperature=0), dict(temperature=-0.5),
    dict(temperature=float("nan")), dict(temperature="1"),
    dict(top_k=-1), dict(top_k=2 ** 31), dict(top_k=True), dict(top_k=1.5),
    dict(top_p=0.0), dict(top_p=1.01), dict(top_p=float("nan")),
    dict(top_p="0.5"), dict(eos_token_id=-1), dict(eos_token_id=2 ** 31),
    dict(eos_token_id=True), dict(seed=1.5), dict(seed=True),
    dict(seed="0")]


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=str)
def test_generation_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        JaxGenCfg(**bad)
    with pytest.raises(ValueError):
        GenerationConfig(**bad)


def test_generation_config_values_and_unported_fields():
    good = dict(max_new_tokens=5, temperature=np.float32(0.7), top_k=3,
                top_p=1, do_sample=1, eos_token_id=np.int64(2), seed=-4)
    want, got = JaxGenCfg(**good), GenerationConfig(**good)
    for name in good:
        assert getattr(got, name) == getattr(want, name)
        assert type(getattr(got, name)) is type(getattr(want, name))
    assert vars(GenerationConfig()) == vars(JaxGenCfg())
    assert (vars(GenerationConfig(adapter="a"))
            == vars(JaxGenCfg(adapter="a")))
    for bad in ("", "x" * 257, 3):
        with pytest.raises(ValueError) as want:
            JaxGenCfg(adapter=bad)
        with pytest.raises(ValueError) as got:
            GenerationConfig(adapter=bad)
        assert str(got.value) == str(want.value)


# -- the filter and the draw --------------------------------------------------


def _logits(rows=len(PARAMS), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, V) * 2.0).astype(np.float32)


def _vectors(params, device="cpu", sample=True, seed=0):
    samp = SlotSampling(len(params), device)
    for i, (t, k, p) in enumerate(params):
        samp.set(i, GenerationConfig(temperature=t, top_k=k, top_p=p,
                                     do_sample=sample), seed + i)
    return samp


def _jax_filter(logits, temp, top_k, top_p):
    """The reference's ``_sample_rows`` filter (its ``drawn`` branch up to
    the draw), in JAX on the same logits."""
    scaled = logits / jnp.maximum(temp, 1e-6)[:, None]
    desc = jnp.sort(scaled, axis=-1)[:, ::-1]
    k_eff = jnp.clip(top_k, 1, logits.shape[-1])
    kth = jnp.take_along_axis(desc, (k_eff - 1)[:, None], axis=-1)
    scaled = jnp.where((top_k > 0)[:, None] & (scaled < kth), -jnp.inf,
                       scaled)
    desc2 = jnp.sort(scaled, axis=-1)[:, ::-1]
    probs = jax.nn.softmax(desc2, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = cum - probs < top_p[:, None]
    cutoff = jnp.min(jnp.where(keep, desc2, jnp.inf), axis=-1, keepdims=True)
    return jnp.where((top_p < 1.0)[:, None] & (scaled < cutoff), -jnp.inf,
                     scaled)


def _jax_samp(params, seeds):
    t, k, p = (np.asarray(c) for c in zip(*params))
    n = len(params)
    return {"temp": jnp.asarray(t, jnp.float32),
            "top_k": jnp.asarray(k, jnp.int32),
            "top_p": jnp.asarray(p, jnp.float32),
            "sample": jnp.ones((n,), bool),
            "eos": jnp.full((n,), -1, jnp.int32),
            "seed": jnp.asarray(seeds, jnp.int32),
            "spec_k": jnp.zeros((n,), jnp.int32),
            "adapter": jnp.zeros((n,), jnp.int32)}


def _chi2_p(counts, probs):
    """p-value of draw counts against probabilities (bins with an
    expected count under 5 merged into one)."""
    exp = probs * counts.sum()
    big = exp >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(exp[big], exp[~big].sum())
    keep = exp > 0
    stat = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    return chi2.sf(stat, keep.sum() - 1) if keep.sum() > 1 else 1.0


def test_filtered_support_equals_the_reference_filter():
    logits = _logits()
    samp = _vectors(PARAMS)
    got = filtered_logits(torch.from_numpy(logits), samp.temp, samp.top_k,
                          samp.top_p)
    t, k, p = (np.asarray(c) for c in zip(*PARAMS))
    want = np.asarray(_jax_filter(jnp.asarray(logits), jnp.asarray(
        t, jnp.float32), jnp.asarray(k, jnp.int32), jnp.asarray(
        p, jnp.float32)))
    assert np.array_equal(np.isfinite(got.numpy()), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6)
    sizes = np.isfinite(want).sum(-1)
    assert sizes[2] == 7 and sizes[4] <= 12 and sizes[3] < V   # filters bit


@pytest.mark.parametrize("row", range(len(PARAMS)))
def test_draws_follow_the_filtered_distribution_as_the_reference(row):
    """4000 draws of one row's config (seeds 0..3999) on each side: every
    JAX draw lies in the port's support, and both sides' frequencies pass
    the chi-square test against softmax(filtered logits)."""
    params = [PARAMS[row]] * N_DRAWS
    logits = np.repeat(_logits()[row:row + 1], N_DRAWS, axis=0)
    samp = _vectors(params)
    filt = filtered_logits(torch.from_numpy(logits[:1]), samp.temp[:1],
                           samp.top_k[:1], samp.top_p[:1])[0].double()
    probs = torch.softmax(filt, -1).numpy()
    support = np.isfinite(filt.numpy())
    port = sample_rows(torch.from_numpy(logits), samp,
                       torch.full((N_DRAWS,), 7)).numpy()
    ref = np.asarray(jax_sample_rows(jnp.asarray(logits),
                                     jax.random.PRNGKey(3),
                                     _jax_samp(params, np.arange(N_DRAWS))))
    for draws in (port, ref):
        assert support[draws].all(), "a draw outside the filtered support"
        counts = np.bincount(draws, minlength=V)
        assert _chi2_p(counts, probs) >= P_MIN
    # every token of the support with an expected count of 20 or more is
    # drawn on both sides (a miss has probability e^-20)
    common = probs * N_DRAWS >= 20
    assert np.isin(np.nonzero(common)[0], port).all()
    assert np.isin(np.nonzero(common)[0], ref).all()


def test_top_k_one_and_greedy_rows_are_the_argmax():
    logits = torch.from_numpy(_logits(64, seed=5))
    greedy = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.arange(64)
    assert torch.equal(sample_rows(logits), greedy)
    top1 = _vectors([(0.7, 1, 1.0)] * 64, seed=11)
    assert torch.equal(sample_rows(logits, top1, pos), greedy)
    off = _vectors([(0.7, 0, 0.5)] * 64, sample=False)
    assert torch.equal(sample_rows(logits, off, pos), greedy)
    t, k, p = (np.full(64, 1.0), np.ones(64), np.full(64, 1.0))
    ref = jax_sample_rows(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
                          _jax_samp(list(zip(t, k, p)), np.arange(64)))
    assert np.array_equal(np.asarray(ref), greedy.numpy())


def test_noise_is_a_function_of_seed_position_and_index_only():
    seed = torch.tensor([5, 5, 6, 5])
    pos = torch.tensor([9, 9, 9, 10])
    g = gumbel_noise(seed, pos, 1000)
    assert torch.isfinite(g).all()
    assert torch.equal(g[0], g[1])
    assert not torch.equal(g[0], g[2]) and not torch.equal(g[0], g[3])
    assert torch.equal(gumbel_noise(seed[1:2], pos[1:2], 1000)[0], g[0])
    # Gumbel(0, 1): mean 0.5772, variance pi^2 / 6
    many = gumbel_noise(torch.arange(64), torch.zeros(64), 4096)
    assert abs(many.mean().item() - 0.5772) < 0.01
    assert abs(many.var().item() - np.pi ** 2 / 6) < 0.03


def test_uniform_stays_inside_the_open_interval():
    """The hash's extreme values, the largest (0xFFFFFFFF) included, map
    to u strictly inside (0, 1), so the noise is finite."""
    bits = torch.tensor([0, 1, 0x1FF, 0x200, 0xFFFFFDFF, 0xFFFFFE00,
                         0xFFFFFF00, 0xFFFFFFFF], dtype=torch.int64)
    u = _uniform(bits)
    assert (u > 0).all() and (u < 1).all()
    assert u[-1].item() == 1 - 2.0 ** -24 and u[0].item() == 2.0 ** -24
    assert torch.isfinite(-torch.log(-torch.log(u))).all()


# (seed, position, vocabulary index) whose hash is 0xFFFFFF in its top 24
# bits, found by search over seeds 0..255 at positions 0..2, V = 32000
TOP_HASH = [(23, 2, 20359), (148, 2, 5706)]


def test_top_k_one_is_greedy_over_many_seeds_and_positions():
    """top_k = 1 draws the greedy token for 256 (seed, position) pairs at
    Llama's vocabulary of 32000, the pairs whose hash reaches the top of
    its range among them, with the noise finite everywhere (a u of 1
    would give +inf noise, and -inf + inf a NaN that argmax picks)."""
    vocab, n = 32000, 256
    g = torch.Generator().manual_seed(9)
    logits = torch.randn(n, vocab, generator=g) * 3.0
    seeds = torch.arange(n) * 7 + 1
    pos = torch.arange(n) % 5
    for i, (s, p, _) in enumerate(TOP_HASH):
        seeds[i], pos[i] = s, p
    for s, p, v in TOP_HASH:
        noise = gumbel_noise(torch.tensor([s]), torch.tensor([p]), vocab)
        assert torch.isfinite(noise).all() and noise[0, v] > 16
    assert torch.isfinite(gumbel_noise(seeds, pos, vocab)).all()
    samp = SlotSampling(n, "cpu")
    samp.set(slice(None), GenerationConfig(do_sample=True, top_k=1,
                                           temperature=0.7), seeds)
    assert torch.equal(sample_rows(logits, samp, pos),
                       torch.argmax(logits, -1).to(torch.int32))


# -- the engines --------------------------------------------------------------


@pytest.mark.parametrize("kind", list(ENGINES))
def test_mixed_batch_greedy_rows_bitwise_and_seeded_rows_alone(kind):
    """Four requests, greedy and sampled alternating, through three slots:
    the greedy ones' streams are bitwise those of an all-greedy serve; a
    sampled request's stream is the same alone as inside the mixed batch
    (its seed and positions key its draws); seeds change the streams."""
    _, tm, _ = make_pair(2, None, seed=0)
    prompts = _prompts(10, [5, 17, 9, 30])
    greedy = GenerationConfig(max_new_tokens=10)
    cfgs = [greedy if i % 2 == 0 else GenerationConfig(
        max_new_tokens=10, seed=100 + i, **SAMPLED) for i in range(4)]
    mixed = [o.tolist() for o in ENGINES[kind](tm).serve(
        prompts, cfgs, segment_steps=4)]
    plain = [o.tolist() for o in ENGINES[kind](tm).serve(
        prompts, greedy, segment_steps=4)]
    assert mixed[0] == plain[0] and mixed[2] == plain[2]
    assert mixed[1] != plain[1] or mixed[3] != plain[3]
    for i in (1, 3):
        alone = ENGINES[kind](tm).serve([prompts[i]], [cfgs[i]],
                                        segment_steps=4)
        assert alone[0].tolist() == mixed[i]
    other = GenerationConfig(max_new_tokens=10, seed=7, **SAMPLED)
    assert ENGINES[kind](tm).serve([prompts[1]], other, segment_steps=4
                                   )[0].tolist() != mixed[1]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_no_capture_after_warmup_with_sampled_requests(kind):
    _, tm, _ = make_pair(2, None, seed=0)
    eng = ENGINES[kind](tm)
    eng.warmup(segment_steps=4)
    before = dict(eng.programs.captures)
    assert before == {("segment", 4): 1, ("segment", 4, "sampled"): 1}
    prompts = _prompts(10, [5, 17, 9, 30])
    eng.serve(prompts, GenerationConfig(max_new_tokens=6, **SAMPLED),
              segment_steps=4)
    eng.serve(prompts, [GenerationConfig(max_new_tokens=5, seed=i,
                                         do_sample=i % 2 == 1)
                        for i in range(4)], segment_steps=4)
    assert eng.programs.captures == before
    assert eng.free_slots() == PAGED["max_batch"]


def test_generate_sampled():
    """``CausalLMEngine``: a sampled generate replays its own graph per
    batch size (captured by warmup, so nothing is captured after it), is
    a function of the seed, top_k = 1 gives the greedy tokens, and a
    greedy call afterwards is the greedy one."""
    _, tm, cfg = make_pair(2, None, seed=0)
    ids = np.random.RandomState(40).randint(0, cfg.vocab_size,
                                            (3, 9)).astype(np.int32)
    eng = CausalLMEngine(tm, max_batch=4, max_len=48)
    eng.warmup(batch=3)
    before = dict(eng.programs.captures)
    greedy = eng.generate(ids, GenerationConfig(max_new_tokens=10))
    a = eng.generate(ids, GenerationConfig(max_new_tokens=10, seed=1,
                                           **SAMPLED))
    b = eng.generate(ids, GenerationConfig(max_new_tokens=10, seed=1,
                                           **SAMPLED))
    c = eng.generate(ids, GenerationConfig(max_new_tokens=10, seed=2,
                                           **SAMPLED))
    assert a.tolist() == b.tolist() and a.tolist() != c.tolist()
    assert a[:, :9].tolist() == ids.tolist()
    assert a[0, 9:].tolist() != a[1, 9:].tolist() or \
        a[1, 9:].tolist() != a[2, 9:].tolist()
    top1 = eng.generate(ids, GenerationConfig(
        max_new_tokens=10, do_sample=True, top_k=1, seed=3))
    assert top1.tolist() == greedy.tolist()
    assert eng.generate(ids, GenerationConfig(max_new_tokens=10)
                        ).tolist() == greedy.tolist()
    assert eng.programs.captures == before
