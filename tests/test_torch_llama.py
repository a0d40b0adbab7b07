"""paddle_tpu_torch's Llama against paddle_tpu's, weights carried across by
``load_paddle_params``: the training forward with its loss, and the serving
forwards (a fresh prefill into a dense cache, then paged decode steps).

Tolerance: both models run in float32 (the JAX side at
``jax_default_matmul_precision="highest"``, set by conftest), so the two
differ only by the order of fp32 sums inside the matmuls and reductions.
Across 2-4 tiny layers that stays near 1e-6 on logits of magnitude ~1;
atol = rtol = 1e-5 holds with margin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.inference.paged_cache import write_tokens as jax_write
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.models import llama_config as jax_config
from paddle_tpu_torch import LlamaForCausalLM, llama_config, load_paddle_params
from paddle_tpu_torch.inference.paged_cache import write_tokens
from paddle_tpu_torch.models import llama as port_llama

TOL = dict(atol=1e-5, rtol=1e-5)


def _val(x):
    return np.asarray(getattr(x, "value", x))


def make_pair(layers=2, kv_heads=None, seed=0, **over):
    """A JAX model from ``seed`` and the port's twin holding its weights."""
    paddle.seed(seed)
    cfg = jax_config("tiny", num_hidden_layers=layers,
                     num_key_value_heads=kv_heads, **over)
    jm = JaxLlama(cfg)
    jm.eval()
    tm = LlamaForCausalLM(
        llama_config("tiny", num_hidden_layers=layers,
                     num_key_value_heads=kv_heads, **over), device="cpu")
    load_paddle_params(tm, {k: np.asarray(p.value)
                            for k, p in jm.named_parameters()})
    return jm, tm, cfg


@pytest.mark.parametrize("layers,kv_heads,tie", [(2, None, False),
                                                 (3, 2, False),
                                                 (2, None, True),
                                                 (4, 1, False)])
def test_forward_logits_and_loss_match(layers, kv_heads, tie):
    jm, tm, cfg = make_pair(layers, kv_heads, seed=layers,
                            tie_word_embeddings=tie)
    rng = np.random.RandomState(layers)
    ids = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels[0, :3] = -100                      # ignored positions
    want = _val(jm(paddle.Tensor(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
        loss = tm(torch.from_numpy(ids), torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, want, **TOL)
    want_loss = float(_val(jm(paddle.Tensor(ids), paddle.Tensor(labels))))
    np.testing.assert_allclose(loss, want_loss, **TOL)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_prefill_then_paged_decode_match(kv_heads):
    """Two live rows (prompts of 5 and 11 tokens, prefilled at bucket width
    16 and installed into fragmented pages) and one dead row with no pages,
    through four paged decode steps: logits at every step and the pool
    contents afterwards agree. The dead row's writes go to the port's sink
    page, so the real pages equal the JAX pools, which dropped them."""
    jm, tm, cfg = make_pair(2, kv_heads, seed=11)
    ps, maxp, num_pages, width = 4, 6, 16, 16
    plens = [5, 11]
    rng = np.random.RandomState(3)
    table = np.full((3, maxp), -1, np.int32)
    table[0, :3] = [9, 2, 14]
    table[1, :4] = [0, 7, 3, 12]
    j_pools = jm.init_paged_cache(num_pages, ps)
    t_pools = tm.init_paged_cache(num_pages, ps)
    assert t_pools[0][0].shape[0] == num_pages + 1     # + the sink page
    first = []
    for row, plen in enumerate(plens):
        ids = np.zeros((1, width), np.int32)
        ids[0, :plen] = rng.randint(0, cfg.vocab_size, plen)
        jl, jmini = jm.forward_with_cache(paddle.Tensor(ids),
                                          jm.init_cache(1, width), 0)
        with torch.no_grad():
            tl, tmini = tm.forward_with_cache(torch.from_numpy(ids),
                                              tm.init_cache(1, width), 0)
        np.testing.assert_allclose(tl.numpy(), _val(jl), **TOL)
        for (jk, jv), (tk, tv) in zip(jmini, tmini):
            np.testing.assert_allclose(tk.numpy(), _val(jk), **TOL)
            np.testing.assert_allclose(tv.numpy(), _val(jv), **TOL)
        first.append(int(np.argmax(_val(jl)[0, plen - 1])))
        slots = np.full((width,), row, np.int32)
        pos = np.arange(width, dtype=np.int32)
        j_pools = [jax_write(k, v, jnp.asarray(table), slots, pos,
                             _val(mk)[0], _val(mv)[0])
                   for (k, v), (mk, mv) in zip(j_pools, jmini)]
        for (k, v), (mk, mv) in zip(t_pools, tmini):
            write_tokens(k, v, torch.from_numpy(table),
                         torch.from_numpy(slots), torch.from_numpy(pos),
                         mk[0], mv[0])
    tok = np.array(first + [0], np.int32)
    lens = np.array(plens + [0], np.int32)
    live = np.array([True, True, False])
    for _ in range(4):
        with no_grad():     # as the engine runs it
            jl, j_pools = jm.forward_decode_paged(
                paddle.Tensor(tok[:, None]), j_pools, jnp.asarray(table),
                jnp.asarray(lens), jnp.asarray(live))
        with torch.no_grad():
            tl, t_pools = tm.forward_decode_paged(
                torch.from_numpy(tok[:, None]), t_pools,
                torch.from_numpy(table), torch.from_numpy(lens),
                torch.from_numpy(live))
        np.testing.assert_allclose(tl.numpy(), _val(jl), **TOL)
        tok = np.where(live, np.argmax(_val(jl)[:, 0], -1), tok).astype(
            np.int32)
        lens = lens + live
    for (jk, jv), (tk, tv) in zip(j_pools, t_pools):
        np.testing.assert_allclose(tk[:num_pages].numpy(), _val(jk), **TOL)
        np.testing.assert_allclose(tv[:num_pages].numpy(), _val(jv), **TOL)
    assert tk[num_pages].abs().sum() > 0      # the dead row wrote the sink


def test_presets_and_config_match_the_reference():
    assert port_llama._PRESETS == jax_llama._PRESETS
    c = llama_config("7b")
    assert (c.hidden_size, c.intermediate_size, c.num_hidden_layers,
            c.num_attention_heads, c.kv_heads, c.vocab_size, c.head_dim) == \
        (4096, 11008, 32, 32, 32, 32000, 128)
    with pytest.raises(TypeError):
        llama_config("tiny", not_a_field=1)


def test_load_paddle_params_raises_on_mismatch():
    jm, tm, _ = make_pair(2)
    named = {k: np.asarray(p.value) for k, p in jm.named_parameters()}
    missing = dict(named)
    missing.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_paddle_params(tm, missing)
    with pytest.raises(KeyError, match="extra"):
        load_paddle_params(tm, dict(named, extra=np.zeros(3, np.float32)))
    bad = dict(named)
    bad["model.norm.weight"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="model.norm.weight"):
        load_paddle_params(tm, bad)


def test_load_paddle_params_casts_to_the_model_dtype():
    jm, _, _ = make_pair(2)
    named = {k: np.asarray(p.value) for k, p in jm.named_parameters()}
    bf = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=2,
                                       dtype="bfloat16"), device="cpu")
    load_paddle_params(bf, named)
    w = bf.model.layers[1].mlp.up_proj.weight
    assert w.dtype == torch.bfloat16
    want = torch.tensor(named["model.layers.1.mlp.up_proj.weight"])
    assert torch.equal(w, want.bfloat16())
