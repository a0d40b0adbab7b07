"""Fixtures for the port's tests that hold it against a JAX model.

The JAX package keeps process-wide state that its models read while they
trace: the global device mesh (``paddle_tpu.distributed.topology``), the
default dtype, the flags and jax's own config. A JAX test file that runs
earlier on the same pytest-xdist worker can leave that state changed, and
a port test comparing against a JAX model then fails only in the full
run: ``test_mp_layers.py``'s autouse ``_mesh`` fixture sets an 8-way
``mp`` mesh and leaves it set, under which the JAX Llama's
``constraint(q, P(None, None, "mp", None))`` cannot shard its 4 heads.

:func:`jax_reference_state` saves that state, resets it to what a fresh
process holds (the default mesh: every device on ``dp``), runs the test
module and puts the saved state back, through the JAX package's public
setters. It is module-scoped and autouse, so it is set up before the
module's other module-scoped fixtures (the models and engines some
modules build once).
:func:`one_thread` pins torch to one intra-op thread for a module. Import
both into a test module to apply them. :func:`adamw_step_matches` holds
one paddle-style AdamW step of a port model against the JAX model's.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import topology
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

# updated parameters after one AdamW step at lr 1e-3: 5% of lr, as
# test_torch_training.py holds them (lr m_hat / (sqrt(v_hat) + eps) turns
# a relative gradient difference of 1e-6 into up to ~1e-2 of lr where |g|
# is within a few eps of zero)
PARAM_TOL = dict(atol=5e-5, rtol=1e-5)
LR, WD = 1e-3, 0.01

_FLAGS = ("FLAGS_use_pallas_kernels", "FLAGS_flash_head_batched",
          "FLAGS_check_nan_inf")
_FRESH_FLAGS = {"FLAGS_use_pallas_kernels": True,
                "FLAGS_flash_head_batched": False,
                "FLAGS_check_nan_inf": False}
# what tests/conftest.py sets for the whole session
_JAX_CONFIG = {"jax_enable_x64": False,
               "jax_default_matmul_precision": "highest"}


@pytest.fixture(autouse=True, scope="module")
def jax_reference_state():
    mesh = topology.get_mesh()
    dtype = paddle.get_default_dtype()
    flags = paddle.get_flags(list(_FLAGS))
    config = {k: getattr(jax.config, k) for k in _JAX_CONFIG}
    topology.set_mesh(topology.build_mesh())
    paddle.set_default_dtype("float32")
    paddle.set_flags(_FRESH_FLAGS)
    for k, v in _JAX_CONFIG.items():
        jax.config.update(k, v)
    try:
        yield
    finally:
        for k, v in config.items():
            jax.config.update(k, v)
        paddle.set_flags(flags)
        paddle.set_default_dtype(dtype)
        topology.set_mesh(mesh)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while the module runs: its models and ops are
    tiny, and a thread pool on a machine whose cores other test workers
    hold waits for its threads at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def adamw_step_matches(model, jm, jgrads, hidden: int, port_loss) -> None:
    """One AdamW step (lr 1e-3, weight decay 0.01, global-norm clip 1.0)
    of the JAX model ``jm`` from ``jgrads`` and of the port's ``model``
    from ``port_loss().backward()``, from the same weights: every
    parameter after the step within PARAM_TOL, but for the key third
    ``[hidden, 2 hidden)`` of each ``qkv_proj.bias``. Its exact gradient
    is 0 (softmax is blind to a shift all of a query's scores share), so
    both sides hold rounding noise there (|g| < 1e-7, asserted) and AdamW
    moves each such element by about lr in the noise's sign: there each
    side's move is held to lr (1 + wd |p|)."""
    jparams = dict(jm.named_parameters())
    before = {k: np.asarray(p.value, np.float32) for k, p in jparams.items()}
    for k, p in jparams.items():
        p.grad = paddle.Tensor(jgrads[k])
    JAdamW(learning_rate=LR, parameters=list(jparams.values()),
           weight_decay=WD, grad_clip=JClip(1.0)).step()
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=WD, grad_clip=ClipGradByGlobalNorm(1.0))
    port_loss().backward()
    noise = {}
    for k, p in model.named_parameters():
        noise[k] = np.zeros(p.shape, bool)
        if k.endswith("qkv_proj.bias"):
            noise[k][hidden:2 * hidden] = True
            for g in (p.grad.numpy(), np.asarray(jgrads[k])):
                assert np.abs(g[hidden:2 * hidden]).max() < 1e-7, k
    opt.step()
    opt.clear_grad()
    for k, p in model.named_parameters():
        assert p.grad is None
        got = p.detach().numpy()
        want = np.asarray(jparams[k].value, np.float32)
        n = noise[k]
        np.testing.assert_allclose(got[~n], want[~n], **PARAM_TOL,
                                   err_msg=k)
        limit = LR * (1 + WD * np.abs(before[k][n])) * (1 + 1e-5)
        for side in (got, want):
            assert (np.abs(side[n] - before[k][n]) <= limit).all(), k
