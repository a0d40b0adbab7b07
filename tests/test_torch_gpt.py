"""paddle_tpu_torch's GPT family against paddle_tpu's, on the CPU.

The ``"tiny"`` preset (2 layers, hidden 64, 4 heads of 16, vocab 256,
fp32), its weights made by the JAX model from a seed and carried over by
``load_paddle_params``, a batch of 8 x 16 tokens from numpy (8 rows: the
JAX Layer API constrains traced batches to the 8-device ``dp`` mesh axis
of the test platform):

- logits and loss of ``model(ids)`` / ``model(ids, labels)`` against the
  JAX model through ``functional_call`` under one ``jax.jit``, without and
  with ``recompute="full"``;
- every gradient of ``model(ids, labels).backward()`` against
  ``jax.grad`` through ``functional_call``, without and with recompute;
- one paddle-style AdamW step (weight decay 0.01, global-norm clip 1.0)
  from those gradients against the JAX AdamW's (``adamw_step_matches``);
- the presets against the reference's; the attention runs the flash
  kernels' path (causal), once per layer forward and once more in the
  backward under recompute; dropout under recompute replays its masks (the
  port's generator replayed by ``recompute``): gradients bitwise those
  without recompute; the entry point raises without CUDA unless given
  ``device="cpu"``.

Tolerance: float32 on both sides (the JAX side at
``jax_default_matmul_precision="highest"``, set by conftest), the same
arithmetic summed in another order: atol = rtol = 1e-5 at magnitudes of
order 1, as in test_torch_training.py; the AdamW step's as
``adamw_step_matches`` states them.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn.functional_call import functional_call
from paddle_tpu_torch.core.random import seed as torch_seed
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_config,
                                     load_paddle_params)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import flash_attention_kernel as fk
from torch_jax_state import (adamw_step_matches, jax_reference_state,  # noqa: F401
                             one_thread)

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _jax_model(seed, **over):
    paddle.seed(seed)
    cfg = jgpt.gpt_config("tiny", **over)
    return jgpt.GPTForCausalLM(cfg), cfg


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    labels[0, :3] = -100                      # ignored positions
    return ids, labels


def _port(jm, recompute="none", **over):
    model = GPTForCausalLM(gpt_config("tiny", recompute=recompute, **over),
                           device="cpu")
    load_paddle_params(model, {k: np.asarray(p.value)
                               for k, p in jm.named_parameters()})
    return model


def _jax_value_and_grad(jm, ids, labels):
    params = {k: p.value for k, p in jm.named_parameters()}
    return jax.jit(jax.value_and_grad(
        lambda pv: functional_call(jm, pv, paddle.Tensor(ids),
                                   paddle.Tensor(labels))))(params)


def test_presets_match_the_reference():
    for name in jgpt._PRESETS:
        want, got = jgpt.gpt_config(name), gpt_config(name)
        assert (got.hidden_size, got.num_hidden_layers,
                got.num_attention_heads, got.vocab_size,
                got.max_position_embeddings, got.head_dim, got.ffn_size) == (
            want.hidden_size, want.num_hidden_layers,
            want.num_attention_heads, want.vocab_size,
            want.max_position_embeddings, want.head_dim, want.ffn_size)


@pytest.mark.parametrize("recompute", ["none", "full"])
def test_logits_and_loss_match_jax(recompute):
    jm, cfg = _jax_model(3, recompute=recompute)
    jm.train()
    params = {k: p.value for k, p in jm.named_parameters()}
    ids, labels = _batch(cfg, seed=4)
    jlogits, jloss = jax.jit(lambda pv: (
        functional_call(jm, pv, paddle.Tensor(ids)),
        functional_call(jm, pv, paddle.Tensor(ids),
                        paddle.Tensor(labels))))(params)
    model = _port(jm, recompute)
    model.train()
    with torch.no_grad():
        logits = model(torch.from_numpy(ids))
        loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)


@pytest.mark.parametrize("recompute", ["none", "full"])
def test_layer_api_grads_match_jax(recompute):
    """``model(ids, labels).backward()`` against ``jax.grad`` through
    ``functional_call``, every parameter by name."""
    jm, cfg = _jax_model(5, recompute=recompute)
    jm.train()
    ids, labels = _batch(cfg, seed=6)
    jloss, jgrads = _jax_value_and_grad(jm, ids, labels)
    model = _port(jm, recompute)
    model.train()
    loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert sorted(k for k, _ in model.named_parameters()) == sorted(jgrads)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jgrads[k]), **TOL,
                                   err_msg=k)


def test_adamw_step_matches_jax():
    """One AdamW step of each side from its own gradients of the same loss
    (``adamw_step_matches``: lr 1e-3, weight decay 0.01, global-norm clip
    1.0; the key bias, whose exact gradient is 0, held to its bound)."""
    jm, cfg = _jax_model(7)
    jm.train()
    ids, labels = _batch(cfg, seed=8)
    model = _port(jm)
    model.train()
    _, jgrads = _jax_value_and_grad(jm, ids, labels)
    adamw_step_matches(
        model, jm, jgrads, cfg.hidden_size,
        lambda: model(torch.from_numpy(ids), torch.from_numpy(labels)))


def test_attention_takes_the_flash_path(monkeypatch):
    """Causal flash attention once per layer forward; under recompute each
    layer's forward runs again in the backward, and the backward kernels'
    plain version runs once per layer."""
    calls = {"fwd": [], "bwd": 0}
    fwd, bwd = fk.flash_attention_bshd, fk.flash_attention_bwd

    def counted_fwd(*a):
        calls["fwd"].append(a[3])            # the causal flag
        return fwd(*a)

    def counted_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(fk, "flash_attention_bshd", counted_fwd)
    monkeypatch.setattr(fk, "flash_attention_bwd", counted_bwd)
    model = GPTForCausalLM(gpt_config("tiny", recompute="full"),
                           device="cpu")
    ids = torch.randint(0, 256, (1, 8))
    model(ids, ids).backward()
    assert calls["fwd"] == [True] * 4 and calls["bwd"] == 2


def test_dropout_under_recompute_replays_its_masks():
    """With dropout 0.1 (attention and residual) the gradients under
    ``recompute="full"`` are bitwise those without, from one seed: the
    recomputed forward draws the forward's masks again."""
    ids = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (2, 16)))
    got = {}
    for rc in ("none", "full"):
        model = GPTForCausalLM(gpt_config("tiny", dropout=0.1,
                                          recompute=rc), device="cpu")
        model.train()
        torch_seed(11)
        loss = model(ids, ids)
        loss.backward()
        got[rc] = (loss.item(), {k: p.grad for k, p in
                                 model.named_parameters()})
    assert got["none"][0] == got["full"][0]
    for k, g in got["none"][1].items():
        assert torch.equal(g, got["full"][1][k]), k
    # and the masks do act: the loss differs from the dropout-free one
    model = GPTForCausalLM(gpt_config("tiny"), device="cpu")
    assert model(ids, ids).item() != got["none"][0]


def test_entry_point_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(gpt_config("tiny"))
    model = GPTForCausalLM(gpt_config("tiny"), device="cpu")
    assert model.device.type == "cpu"
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    bf = tgpt.GPTForCausalLM(gpt_config("tiny", dtype="bfloat16"),
                             device="cpu")
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}
