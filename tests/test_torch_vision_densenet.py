"""paddle_tpu_torch's DenseNets (``classic2.py``) against paddle_tpu's, on
the CPU: each of the five model functions in eval mode at 2 x 3 x 32 x 32
(10 classes), the port's random weights and BatchNorm statistics carried
into the reference's, the logits held by ``near()`` against the port's
fp64 twin. (``test_torch_vision_models2.py`` holds the other classic2
families and every model's structure; the DenseNets sit in a file of
their own because the reference's jitted forwards of these deep models
take most of a minute together.)"""
import pytest

import torch_nn_cases as C
from test_torch_vision_models2 import MODEL_FNS, DENSENETS, eval_matches
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)


def test_every_densenet_is_covered():
    assert DENSENETS == ["densenet121", "densenet161", "densenet169",
                         "densenet201", "densenet264"]


@pytest.mark.parametrize("name", DENSENETS)
def test_densenet_eval_matches_reference(name):
    eval_matches(name, 32, MODEL_FNS.index(name))
