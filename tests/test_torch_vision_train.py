"""paddle_tpu_torch's classic2 models in training mode against
paddle_tpu's, on the CPU: DenseNet-121, MobileNetV3-Small and ShuffleNetV2
x0.25 at 4 x 3 x 64 x 64 (10 classes), the cross-entropy loss and the
gradients of the input and every parameter, both sides in float64, within
1e-8 of each gradient's largest magnitude
(``test_torch_vision_models2.training_step_matches`` says why float64).
A file of its own: the reference's jitted forward and backward of
DenseNet-121 take about half a minute to compile."""
import pytest

import torch_nn_cases as C
from test_torch_vision_models2 import TRAIN, training_step_matches
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)


@pytest.mark.parametrize("name", TRAIN)
def test_model_training_step_matches_reference(name):
    training_step_matches(name)
