"""paddle_tpu_torch's math ops (``ops/math.py``) against paddle_tpu's, on
the CPU: every op of the gradient sweep (``tests/test_check_grad_sweep.py``)
by its forward and its gradient through each package's ``grad`` on the
sweep's probe inputs, more forward cases at other shapes (broadcasting,
negative axes, ties), and the ops without a gradient by their forward. fp32
throughout: rtol 1e-5, atol 1e-6; special functions (digamma, lgamma,
polygamma, erfinv, the Bessel functions) rtol 1e-4, atol 1e-5 (the two
libraries' approximations); gradients through factorizations rtol 1e-4,
atol 1e-5 (``tests/torch_surface_cases.py``).
"""
import pytest
import torch

import torch_surface_cases as cases
from paddle_tpu_torch.core import place

GRADS, HELD, FORWARD = cases.cases_of("math")


@pytest.fixture(autouse=True, scope="module")
def cpu_place_one_thread():
    """The CPU as the current place and one intra-op thread, both
    restored."""
    n, prev = torch.get_num_threads(), place._current[0]
    torch.set_num_threads(1)
    place.set_device("cpu")
    yield
    place._current[0] = prev
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", GRADS)
def test_grad(name):
    cases.check_grad(name)


@pytest.mark.parametrize("name,i", HELD)
def test_forward(name, i):
    cases.check_forward(cases.HELD[name][i], f"{name}[{i}]")


@pytest.mark.parametrize("name,i", FORWARD)
def test_forward_more_shapes(name, i):
    cases.check_forward(cases.FORWARD[name][i], f"{name}[{i}]")
