"""paddle_tpu_torch's ``nn.initializer`` against paddle_tpu's, on the CPU.

- ``Constant``, ``Assign``, ``Dirac``, ``Bilinear`` and ``calculate_gain``
  equal the JAX package's exactly.
- The random initializers draw from torch's generators where the reference
  draws from threefry, so they are held by distribution at the shapes
  ``tests/test_initializers_stats.py`` uses: the two packages' draws
  (fp32, 4 seeds each) pass a two-sample Kolmogorov-Smirnov test at
  p > 1e-3, their standard deviations agree within 5% and their means
  within five standard errors of the difference, the bounded ones stay in
  their bounds, and ``Orthogonal`` is orthogonal to 1e-5.
- ``seed(s)`` gives the same weights twice, another seed other weights,
  and no draw moves torch's global generator.
"""
import numpy as np
import pytest
import scipy.stats
import torch

import paddle_tpu
import paddle_tpu_torch as pt
import torch_nn_cases as C

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)
J, T = paddle_tpu.nn.initializer, pt.nn.initializer


def _port(init, shape, seed):
    pt.seed(seed)
    return pt.create_parameter(shape, "float32",
                               default_initializer=init).detach().numpy()


def _jax(init, shape, seed):
    paddle_tpu.seed(seed)
    return C._np(paddle_tpu.create_parameter(shape, "float32",
                                             default_initializer=init))


def test_module_names_are_the_references():
    assert sorted(T.__all__) == sorted(J.__all__)


@pytest.mark.parametrize("nonlinearity,param", [
    ("sigmoid", None), ("linear", None), ("conv2d", None), ("tanh", None),
    ("relu", None), ("leaky_relu", None), ("leaky_relu", 0.2), ("selu", None),
    ("conv3d_transpose", None)])
def test_calculate_gain_is_exact(nonlinearity, param):
    assert T.calculate_gain(nonlinearity, param) == \
        J.calculate_gain(nonlinearity, param)


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.25,), [3, 4]),
    ("Assign", (np.arange(12, dtype=np.float32).reshape(3, 4),), [3, 4]),
    ("Assign", (np.arange(12, dtype=np.float32),), [3, 4]),
    ("Dirac", (), [4, 4, 3, 3]),
    ("Dirac", (2,), [6, 3, 3, 3]),
    ("Bilinear", (), [2, 1, 4, 4]),
    ("Bilinear", (), [1, 2, 3, 5])])
def test_deterministic_initializers_are_exact(name, args, shape):
    np.testing.assert_array_equal(_port(getattr(T, name)(*args), shape, 0),
                                  _jax(getattr(J, name)(*args), shape, 0))


RANDOM = [
    ("Normal", (0.5, 2.0), [80, 120], None),
    ("TruncatedNormal", (0.0, 1.0), [50, 50], (-2.0, 2.0)),
    ("TruncatedNormal", (1.0, 0.5, -1.0, 3.0), [50, 50], (0.5, 2.5)),
    ("Uniform", (-0.3, 0.7), [80, 120], (-0.3, 0.7)),
    ("XavierNormal", (), [80, 120], None),
    ("XavierUniform", (), [80, 120], "xavier"),
    ("KaimingNormal", (), [90, 60], None),
    ("KaimingNormal", (), [8, 4, 3, 3], None),
    ("KaimingUniform", (), [90, 60], "kaiming"),
    ("Orthogonal", (), [16, 64], None),
    ("Orthogonal", (1.5,), [64, 16], None),
]


@pytest.mark.parametrize("name,args,shape,bounds", RANDOM,
                         ids=[f"{r[0]}-{'x'.join(map(str, r[2]))}-{i}"
                              for i, r in enumerate(RANDOM)])
def test_random_initializers_match_in_distribution(name, args, shape,
                                                   bounds):
    t = np.concatenate([_port(getattr(T, name)(*args), shape, s).ravel()
                        for s in range(4)])
    j = np.concatenate([_jax(getattr(J, name)(*args), shape, s).ravel()
                        for s in range(4)])
    assert scipy.stats.ks_2samp(t, j).pvalue > 1e-3
    np.testing.assert_allclose(t.std(), j.std(), rtol=0.05)
    assert abs(t.mean() - j.mean()) < 5 * j.std() * np.sqrt(2.0 / t.size)
    if bounds == "xavier":
        bounds = (-np.sqrt(6.0 / sum(shape)), np.sqrt(6.0 / sum(shape)))
    elif bounds == "kaiming":
        bounds = (-np.sqrt(6.0 / shape[0]), np.sqrt(6.0 / shape[0]))
    if bounds is not None:
        assert bounds[0] - 1e-6 <= t.min() and t.max() <= bounds[1] + 1e-6
    if name == "Orthogonal":
        w = _port(getattr(T, name)(*args), shape, 9)
        gain = args[0] if args else 1.0
        small = min(shape)
        gram = w @ w.T if shape[0] == small else w.T @ w
        np.testing.assert_allclose(gram, gain ** 2 * np.eye(small),
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seed_repeats_the_draws_and_leaves_torch_alone(dtype):
    torch_state = torch.get_rng_state()
    draws = []
    for s in (11, 11, 12):
        pt.seed(s)
        draws.append(pt.nn.Linear(8, 16).weight.detach().float())
        pt.seed(s)
        p = pt.create_parameter([4, 5], dtype,
                                default_initializer=T.Normal(0.0, 1.0))
        assert p.dtype == getattr(torch, dtype)
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert torch.equal(torch.get_rng_state(), torch_state)


def test_an_explicit_generator_and_the_default_dtype():
    g = torch.Generator().manual_seed(3)
    a = T.Normal()([5], generator=g)
    b = T.Normal()([5], generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    pt.set_default_dtype("bfloat16")
    assert T.Uniform()([2, 2]).dtype == torch.bfloat16
    assert pt.nn.Linear(2, 2).weight.dtype == torch.bfloat16
    assert torch.get_default_dtype() == torch.float32
