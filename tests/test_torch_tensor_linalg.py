"""paddle_tpu_torch's linalg, creation and random ops against paddle_tpu's,
on the CPU.

- linalg and creation: every op of the gradient sweep among them by its
  forward and its gradient through each package's ``grad`` (the sweep's
  probe inputs); the others by their forward. ``eig``, ``eigvals`` and
  ``lstsq`` are held by reconstruction and invariants: eigenvectors and
  singular vectors have free signs and phases, so ``svd``, ``qr``, ``eigh``
  and ``eig`` are compared by ``A V = V diag(w)``, sorted eigenvalues,
  ``U diag(S) VH = A`` and orthogonality; ``lstsq`` on a rank-deficient
  system gives the JAX package's least-norm solution, rank and singular
  values.
- random: after ``seed(s)`` every random op is bitwise repeatable port
  against port, ``get_rng_state`` / ``set_rng_state`` replay a draw, and at
  2^16 samples the moments and a Kolmogorov-Smirnov test match the
  distribution the JAX op draws from (its numbers differ: JAX's threefry is
  not torch's generator). ``seed`` moves none of torch's global generators:
  a sampled ``CausalLMEngine.generate`` stream is the same with and without
  a ``seed(123)`` between two runs.

Tolerances: fp32 rtol 1e-5, atol 1e-6; factorizations and their gradients
rtol 1e-4, atol 1e-5; reconstructions atol 1e-4 (``tests/
torch_surface_cases.py``).
"""
import numpy as np
import pytest
import scipy.stats
import torch

import paddle_tpu
import paddle_tpu_torch as pt
import torch_surface_cases as cases
from paddle_tpu_torch.core import place
from paddle_tpu_torch.core import random as prandom
from torch_surface_cases import LINALG_TOL, n

GRADS, HELD, FORWARD = cases.cases_of("linalg", "creation")
RECON_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def cpu_place_one_thread():
    """The CPU as the current place and one intra-op thread; both, and the
    generator's state, restored."""
    threads, prev = torch.get_num_threads(), place._current[0]
    state = pt.get_rng_state()
    torch.set_num_threads(1)
    place.set_device("cpu")
    yield
    pt.set_rng_state(state)
    place._current[0] = prev
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", GRADS)
def test_grad(name):
    cases.check_grad(name)


@pytest.mark.parametrize("name,i", HELD)
def test_forward(name, i):
    cases.check_forward(cases.HELD[name][i], f"{name}[{i}]")


@pytest.mark.parametrize("name,i", FORWARD)
def test_forward_more_shapes(name, i):
    cases.check_forward(cases.FORWARD[name][i], f"{name}[{i}]")


# -- factorizations by reconstruction -------------------------------------

def _t(a):
    return pt.to_tensor(a)


def test_svd_qr_eigh_reconstruct():
    a = n(6, 4).astype(np.float64).astype(np.float32)
    u, s, vh = pt.svd(_t(a))
    np.testing.assert_allclose((u * s[None]) @ vh, a, atol=RECON_ATOL)
    ju, js, jvh = paddle_tpu.svd(paddle_tpu.to_tensor(a))
    np.testing.assert_allclose(s, np.asarray(js.value), **LINALG_TOL)
    np.testing.assert_allclose(u.T @ u, np.eye(4), atol=RECON_ATOL)
    q, r = pt.qr(_t(a))
    np.testing.assert_allclose(q @ r, a, atol=RECON_ATOL)
    np.testing.assert_allclose(q.T @ q, np.eye(4), atol=RECON_ATOL)
    assert torch.equal(torch.triu(r), r)
    np.testing.assert_allclose(np.abs(r), np.abs(np.asarray(
        paddle_tpu.qr(paddle_tpu.to_tensor(a))[1].value)), **LINALG_TOL)
    sym = cases.spd(5)
    w, v = pt.eigh(_t(sym))
    np.testing.assert_allclose(_t(sym) @ v, v * w[None], atol=RECON_ATOL)
    np.testing.assert_allclose(w, np.asarray(paddle_tpu.eigh(
        paddle_tpu.to_tensor(sym))[0].value), **LINALG_TOL)


@pytest.mark.parametrize("fn", ["eig", "eigvals"])
def test_eig_by_reconstruction(fn):
    a = n(5, 5)
    jw = np.asarray(getattr(paddle_tpu, fn)(paddle_tpu.to_tensor(a))[0].value
                    if fn == "eig" else paddle_tpu.eigvals(
                        paddle_tpu.to_tensor(a)).value)
    if fn == "eig":
        w, v = pt.eig(_t(a))
        np.testing.assert_allclose(_t(a).to(torch.complex64) @ v,
                                   v * w[None], atol=RECON_ATOL)
    else:
        w = pt.eigvals(_t(a))
    key = lambda z: np.lexsort((np.round(z.imag, 4), np.round(z.real, 4)))
    w = w.numpy()
    np.testing.assert_allclose(w[key(w)], jw[key(jw)], **LINALG_TOL)


@pytest.mark.parametrize("rank_deficient", [False, True])
def test_lstsq_least_norm(rank_deficient):
    a = n(6, 4)
    if rank_deficient:
        a[:, 3] = a[:, 0] + a[:, 1]          # rank 3
    b = n(6, 2)
    got = pt.lstsq(_t(a), _t(b))
    want = paddle_tpu.lstsq(paddle_tpu.to_tensor(a), paddle_tpu.to_tensor(b))
    cases.assert_same(list(got), list(want), LINALG_TOL, "lstsq")
    assert int(got[2]) == (3 if rank_deficient else 4)


# -- creation on the current place ----------------------------------------

def test_creation_lands_on_the_current_place():
    for t in (pt.zeros([2]), pt.arange(3), pt.eye(2), pt.full([1], 2.0),
              pt.linspace(0, 1, 3), pt.to_tensor([1.0]), pt.rand([2]),
              pt.randint(0, 4, [3]), pt.tril_indices(3, 3)):
        assert t.device == torch.device("cpu")
    assert pt.to_tensor([1.0], place="cpu").device.type == "cpu"


# -- random ---------------------------------------------------------------

_PCA_IN = n(8, 5)
RANDOM = {
    "rand": lambda: pt.rand([64]),
    "randn": lambda: pt.randn([64]),
    "standard_normal": lambda: pt.standard_normal([64]),
    "randint": lambda: pt.randint(0, 10, [64]),
    "randint_like": lambda: pt.randint_like(pt.zeros([64]), 0, 10),
    "randperm": lambda: pt.randperm(64),
    "uniform": lambda: pt.uniform([64], min=-2.0, max=3.0),
    "normal": lambda: pt.normal(1.0, 2.0, [64]),
    "normal_like": lambda: pt.normal_like(pt.zeros([64]), 1.0, 2.0),
    "rand_like": lambda: pt.rand_like(pt.zeros([64])),
    "randn_like": lambda: pt.randn_like(pt.zeros([64])),
    "poisson": lambda: pt.poisson(pt.full([64], 3.0)),
    "bernoulli": lambda: pt.bernoulli(pt.full([64], 0.3)),
    "multinomial": lambda: pt.multinomial(pt.to_tensor([0.1, 0.2, 0.7]), 16,
                                          replacement=True),
    "exponential_": lambda: pt.exponential_(pt.zeros([64]), 2.0),
    "uniform_": lambda: pt.uniform_(pt.zeros([64]), 0.0, 2.0),
    "pca_lowrank": lambda: pt.pca_lowrank(pt.to_tensor(_PCA_IN), q=3)[1],
}
assert set(RANDOM) == set(cases.RANDOM)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_repeats_after_seed(name):
    pt.seed(11)
    a = RANDOM[name]()
    b = RANDOM[name]()
    pt.seed(11)
    c = RANDOM[name]()
    assert torch.equal(a, c)
    if name != "pca_lowrank":          # the reference's fixed sketch seed
        assert not torch.equal(a, b)


def test_rng_state_replays_a_draw():
    pt.seed(5)
    pt.rand([3])
    state = pt.get_rng_state()
    a = pt.randn([16])
    pt.rand([7])
    pt.set_rng_state(state)
    assert torch.equal(pt.randn([16]), a)
    assert pt.get_cuda_rng_state is pt.get_rng_state


def test_seed_leaves_torch_generators_alone():
    before = torch.random.get_rng_state()
    pt.seed(123)
    pt.rand([8])
    assert torch.equal(torch.random.get_rng_state(), before)


N = 1 << 16
DISTRIBUTIONS = {
    # name: (port sample, JAX sample, scipy distribution or None)
    "rand": (lambda: pt.rand([N]),
             lambda: paddle_tpu.rand([N]), scipy.stats.uniform()),
    "randn": (lambda: pt.randn([N]),
              lambda: paddle_tpu.randn([N]), scipy.stats.norm()),
    "uniform": (lambda: pt.uniform([N], min=-2.0, max=3.0),
                lambda: paddle_tpu.uniform([N], min=-2.0, max=3.0),
                scipy.stats.uniform(-2.0, 5.0)),
    "normal": (lambda: pt.normal(1.0, 2.0, [N]),
               lambda: paddle_tpu.normal(1.0, 2.0, [N]),
               scipy.stats.norm(1.0, 2.0)),
    "exponential_": (lambda: pt.exponential_(pt.zeros([N]), 2.0),
                     lambda: paddle_tpu.exponential_(
                         paddle_tpu.zeros([N]), 2.0),
                     scipy.stats.expon(scale=0.5)),
    "randint": (lambda: pt.randint(0, 10, [N]),
                lambda: paddle_tpu.randint(0, 10, [N]), None),
    "poisson": (lambda: pt.poisson(pt.full([N], 3.0)),
                lambda: paddle_tpu.poisson(paddle_tpu.full([N], 3.0)), None),
    "bernoulli": (lambda: pt.bernoulli(pt.full([N], 0.3)),
                  lambda: paddle_tpu.bernoulli(paddle_tpu.full([N], 0.3)),
                  None),
    "multinomial": (lambda: pt.multinomial(
        pt.to_tensor([0.1, 0.2, 0.7]), N, replacement=True),
        lambda: paddle_tpu.multinomial(
            paddle_tpu.to_tensor(np.array([0.1, 0.2, 0.7], np.float32)), N,
            replacement=True), None),
}


@pytest.mark.parametrize("name", sorted(DISTRIBUTIONS))
def test_random_matches_the_reference_distribution(name):
    pt.seed(3)
    paddle_tpu.seed(3)
    port, ref, dist = DISTRIBUTIONS[name]
    got = port().double().numpy()
    want = np.asarray(ref().value, np.float64)
    se = max(want.std(), 1e-3) / np.sqrt(N)
    assert abs(got.mean() - want.mean()) < 6 * se * np.sqrt(2), (
        got.mean(), want.mean())
    assert abs(got.std() / want.std() - 1) < 0.02, (got.std(), want.std())
    if dist is not None:
        assert scipy.stats.kstest(got, dist.cdf).pvalue > 1e-4
        assert scipy.stats.kstest(want, dist.cdf).pvalue > 1e-4
    else:                               # discrete: the same frequencies
        vals = np.union1d(got, want)
        f_got = np.array([(got == v).mean() for v in vals])
        f_want = np.array([(want == v).mean() for v in vals])
        assert np.abs(f_got - f_want).max() < 0.01, (vals, f_got, f_want)


def test_randperm_and_without_replacement_are_permutations():
    pt.seed(0)
    assert sorted(pt.randperm(50).tolist()) == list(range(50))
    draw = pt.multinomial(pt.full([20], 1.0), 20)
    assert sorted(draw.tolist()) == list(range(20))


def test_seed_keeps_the_engines_sampled_stream():
    """The engines sample from their own per-request generators: a sampled
    generate is the same with a seed() between two runs and without."""
    from paddle_tpu_torch import (CausalLMEngine, GenerationConfig,
                                  LlamaForCausalLM, llama_config)

    model = LlamaForCausalLM(llama_config("tiny"), device="cpu")
    ids = torch.tensor([[1, 5, 9, 2]])
    cfg = GenerationConfig(max_new_tokens=6, do_sample=True, temperature=0.9,
                           top_k=20, seed=7)

    def run():
        return CausalLMEngine(model, max_batch=1, max_len=32).generate(
            ids, cfg)

    plain = [run(), run()]
    first = run()
    pt.seed(123)
    pt.rand([4])
    second = run()
    np.testing.assert_array_equal(np.asarray(first), np.asarray(plain[0]))
    np.testing.assert_array_equal(np.asarray(second), np.asarray(plain[1]))
