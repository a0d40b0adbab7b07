"""paddle_tpu_torch's recurrent and transformer layers and decoders
against paddle_tpu's, on the CPU: every layer of the reference's
``nn/layer/rnn.py`` and ``transformer.py`` (a name without a case fails)
and ``nn/decode.py``'s ``BeamSearchDecoder`` with ``dynamic_decode``.

Each layer is built on both sides, the JAX layer's ``state_dict`` carried
across (the same keys and shapes in the same order: ``rnns.{i}.cell.*``,
``rnns.{i}.rnn_fw.cell.*`` / ``rnn_bw``, the attention's ``q_proj`` ...),
and one seeded call compared: the output, with the final states (RNNs)
or the caches (attention) flattened into it, and the gradients of
``sum(out * ct)`` for every floating input and every parameter.

- The RNN cells alone and inside ``RNN``; ``SimpleRNN`` (tanh and relu),
  ``LSTM`` and ``GRU``, one and two layers, forward and bidirectional
  (``"bidirect"`` and ``"bidirectional"``), ``time_major``, ragged
  ``sequence_length``, given initial states.
- ``MultiHeadAttention`` without a cache, with a bool and a float mask,
  ``kdim`` / ``vdim``, ``need_weights``; with ``Cache`` over two
  incremental calls and with ``StaticCache`` from ``gen_cache``.
- The encoder and decoder layers and stacks with ``normalize_before`` both
  ways, the decoder stack with its caches, ``Transformer`` with a causal
  target mask from ``generate_square_subsequent_mask`` and a source
  padding mask. Dropout is 0 (the two packages draw other numbers).
- ``BeamSearchDecoder`` over an ``LSTMCell`` with an embedding and an
  output projection, through ``dynamic_decode``: the ids and the lengths
  equal; ``gather_tree`` is held in ``tests/test_torch_nn_conv_pool.py``.

Tolerances (``tests/torch_nn_cases.py``): fp32 rtol 1e-5 / atol 1e-6,
the recurrent and attention stacks rtol 1e-5 / atol 1e-5 (gradients
through 6-8 steps or 2 layers sum hundreds of products of order 1 in
other orders); bf16 atol of the compared array's largest magnitude:
the RNNs 2^-5 (each step's state re-enters the next step's product
rounded to bf16 on both sides, in other places; 0.021 of the top
measured), the attention and transformer cases 2^-4 (each sublayer
rounds its projections, scores, probabilities and LayerNorm to bf16 in
other places on the two sides; 0.031 of the top measured on the 2-layer
decoder's input gradient). The bf16 2-layer decoder runs GELU: at
ReLU's kink a bf16 rounding moves a pre-activation across 0 and switches
a whole hidden unit's gradient on one side only (seen on the ReLU twin,
which fp32 holds). The key projection's bias has a gradient of 0
(a shift of every key moves a query's scores alike, which the softmax
cancels): both sides' bf16 values are rounding noise, held under 2^-4 of
the largest gradient of the key projection's weight.
"""
import importlib
import types

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
import torch_nn_cases as C
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

STACK_TOL = dict(rtol=1e-5, atol=1e-5)
RNN_BF16_TOP = 2.0 ** -5
ATTENTION_BF16_TOP = 2.0 ** -4


def _flat(pkg, *ts):
    """Every tensor of ``ts`` (nested tuples and lists, Nones skipped)
    flattened into one vector, so one comparison holds them all."""
    leaves = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, (tuple, list)):
            for x in t:
                walk(x)
        else:
            leaves.append(pkg.reshape(t, [-1]))
    walk(ts)
    return pkg.concat(leaves)


def _lens(*v):
    return np.asarray(v, np.int64)


def _rnn_call(layer, pkg, x, *rest):
    out, st = layer(x, *rest)
    return _flat(pkg, out, st)


def _rnn_states(layer, pkg, x, h, c):
    """[L * D, B, H] initial states (LSTM: a pair) and ragged lengths."""
    out, st = layer(x, (h, c) if layer.mode == "LSTM" else h,
                    np.asarray([6, 4, 5]))
    return _flat(pkg, out, st)


def _cell_call(layer, pkg, x, *st):
    out, new = layer(x, st if len(st) > 1 else st[0])
    return _flat(pkg, out, new)


def _rnn_wrapped(kind):
    def make(nn):
        cell = getattr(nn, kind)(5, 7)
        return nn.RNN(cell, is_reverse=True, time_major=True)
    return make


def _mha_cache(layer, pkg, q, kv):
    cache = layer.gen_cache(q)
    out1, cache = layer(q, q, q, None, cache)
    out2, cache = layer(kv, kv, kv, None, cache)
    return _flat(pkg, out1, out2, cache.k, cache.v)


def _mha_static(layer, pkg, q, mem, mask):
    static = layer.gen_cache(mem, mem, type=layer.StaticCache)
    out, cache = layer(q, mem, mem, mask, static)
    return _flat(pkg, out, cache.k, cache.v)


def _decoder_cache(layer, pkg, tgt, mem):
    cache = layer.gen_cache(mem)
    out1, cache = layer(tgt[:, :2], mem, None, None, cache)
    out2, cache = layer(tgt[:, 2:], mem, None, None, cache)
    return _flat(pkg, out1, out2)


def _transformer(layer, pkg, src, tgt, src_mask):
    causal = layer.generate_square_subsequent_mask(tgt.shape[1])
    return layer(src, tgt, src_mask, causal, src_mask[:, :, :1])


_SRC_MASK = np.ones((2, 1, 1, 7), bool)
_SRC_MASK[1, ..., 5:] = False
_FLOAT_MASK = np.where(np.random.RandomState(9).rand(2, 1, 4, 6) < 0.3,
                       -1e9, 0.0)
_BOOL_MASK = np.random.RandomState(8).rand(2, 2, 4, 6) < 0.7
_BOOL_MASK[..., 0] = True

E, H, FF = 16, 4, 32
# name -> (make(nn), call(layer, pkg, *tensors), input specs)
CASES = {
    "SimpleRNNCell": (lambda nn: nn.SimpleRNNCell(5, 7), _cell_call,
                      [(3, 5), (3, 7)]),
    "SimpleRNNCell_relu": (lambda nn: nn.SimpleRNNCell(
        5, 7, activation="relu"), _cell_call, [(3, 5), (3, 7)]),
    "LSTMCell": (lambda nn: nn.LSTMCell(5, 7), _cell_call,
                 [(3, 5), (3, 7), (3, 7)]),
    "GRUCell": (lambda nn: nn.GRUCell(5, 7), _cell_call, [(3, 5), (3, 7)]),
    "RNN_lstm_reverse_time_major": (_rnn_wrapped("LSTMCell"), _rnn_call,
                                    [(6, 3, 5)]),
    "RNN_gru_lengths": (lambda nn: nn.RNN(nn.GRUCell(5, 7)),
                        lambda l, p, x, s: _rnn_call(l, p, x, None, s),
                        [(3, 6, 5), _lens(6, 3, 5)]),
    "BiRNN": (lambda nn: nn.BiRNN(nn.SimpleRNNCell(5, 7),
                                  nn.SimpleRNNCell(5, 7)),
              lambda l, p, x, s: _rnn_call(l, p, x, None, s),
              [(3, 6, 5), _lens(2, 6, 4)]),
    "SimpleRNN": (lambda nn: nn.SimpleRNN(5, 7, 2), _rnn_call, [(3, 6, 5)]),
    "SimpleRNN_relu_bidirect": (
        lambda nn: nn.SimpleRNN(5, 7, direction="bidirect",
                                activation="relu"),
        lambda l, p, x, s: _rnn_call(l, p, x, None, s),
        [(3, 6, 5), _lens(6, 1, 4)]),
    "LSTM": (lambda nn: nn.LSTM(5, 7, 2), _rnn_call, [(3, 6, 5)]),
    "LSTM_bidirect_lengths": (
        lambda nn: nn.LSTM(5, 7, 2, direction="bidirect"),
        lambda l, p, x, s: _rnn_call(l, p, x, None, s),
        [(3, 6, 5), _lens(6, 3, 5)]),
    "LSTM_time_major_states": (
        lambda nn: nn.LSTM(5, 7, 2, direction="bidirectional",
                           time_major=True),
        lambda l, p, x, h, c: _rnn_call(l, p, x, (h, c)),
        [(6, 3, 5), (4, 3, 7), (4, 3, 7)]),
    "GRU": (lambda nn: nn.GRU(5, 7, 2), _rnn_call, [(3, 6, 5)]),
    "GRU_bidirect_states_lengths": (
        lambda nn: nn.GRU(5, 7, 2, direction="bidirect"),
        lambda l, p, x, h: _rnn_states(l, p, x, h, None),
        [(3, 6, 5), (4, 3, 7)]),
    "LSTM_states_lengths": (
        lambda nn: nn.LSTM(5, 7, 1), _rnn_states,
        [(3, 6, 5), (1, 3, 7), (1, 3, 7)]),
    "MultiHeadAttention": (lambda nn: nn.MultiHeadAttention(E, H),
                           lambda l, p, q: l(q), [(2, 5, E)]),
    "MultiHeadAttention_kv_bool_mask": (
        lambda nn: nn.MultiHeadAttention(E, 2, kdim=6, vdim=10,
                                         need_weights=True),
        lambda l, p, q, k, v, m: l(q, k, v, m)[0],
        [(2, 4, E), (2, 6, 6), (2, 6, 10), _BOOL_MASK]),
    "MultiHeadAttention_float_mask": (
        lambda nn: nn.MultiHeadAttention(E, H),
        lambda l, p, q, kv, m: l(q, kv, kv, m),
        [(2, 4, E), (2, 6, E), ("const", (2, 1, 4, 6))]),
    "MultiHeadAttention_cache": (lambda nn: nn.MultiHeadAttention(E, H),
                                 _mha_cache, [(2, 3, E), (2, 1, E)]),
    "MultiHeadAttention_static_cache": (
        lambda nn: nn.MultiHeadAttention(E, H), _mha_static,
        [(2, 4, E), (2, 6, E), np.asarray(_FLOAT_MASK)]),
    "TransformerEncoderLayer": (
        lambda nn: nn.TransformerEncoderLayer(E, H, FF, 0.0),
        lambda l, p, x, m: l(x, m), [(2, 7, E), _SRC_MASK]),
    "TransformerEncoderLayer_pre_gelu": (
        lambda nn: nn.TransformerEncoderLayer(
            E, H, FF, 0.0, "gelu", normalize_before=True),
        lambda l, p, x: l(x), [(2, 7, E)]),
    "TransformerEncoder": (
        lambda nn: nn.TransformerEncoder(
            nn.TransformerEncoderLayer(E, H, FF, 0.0), 2),
        lambda l, p, x, m: l(x, m), [(2, 7, E), _SRC_MASK]),
    "TransformerEncoder_pre_norm_cache": (
        lambda nn: nn.TransformerEncoder(
            nn.TransformerEncoderLayer(E, H, FF, 0.0,
                                       normalize_before=True),
            2, nn.LayerNorm(E)),
        lambda l, p, x: _flat(p, *l(x, None, l.gen_cache(x))),
        [(2, 5, E)]),
    "TransformerDecoderLayer": (
        lambda nn: nn.TransformerDecoderLayer(E, H, FF, 0.0),
        lambda l, p, t, m, tm: l(t, m, tm, None),
        [(2, 5, E), (2, 7, E), ("const", (5, 5))]),
    "TransformerDecoderLayer_pre_cache": (
        lambda nn: nn.TransformerDecoderLayer(E, H, FF, 0.0,
                                              normalize_before=True),
        _decoder_cache, [(2, 4, E), (2, 6, E)]),
    "TransformerDecoder": (
        lambda nn: nn.TransformerDecoder(
            nn.TransformerDecoderLayer(E, H, FF, 0.0), 2),
        lambda l, p, t, m, mm: l(t, m, None, mm),
        [(2, 5, E), (2, 7, E), _SRC_MASK]),
    "TransformerDecoder_pre_norm_cache": (
        lambda nn: nn.TransformerDecoder(
            nn.TransformerDecoderLayer(E, H, FF, 0.0,
                                       normalize_before=True),
            2, nn.LayerNorm(E)),
        _decoder_cache, [(2, 4, E), (2, 6, E)]),
    "TransformerDecoder_pre_gelu_cache": (
        lambda nn: nn.TransformerDecoder(
            nn.TransformerDecoderLayer(E, H, FF, 0.0, "gelu",
                                       normalize_before=True),
            2, nn.LayerNorm(E)),
        _decoder_cache, [(2, 4, E), (2, 6, E)]),
    "Transformer": (
        lambda nn: nn.Transformer(E, H, 2, 2, FF, 0.0),
        _transformer, [(2, 7, E), (2, 5, E), _SRC_MASK]),
    "Transformer_pre_norm": (
        lambda nn: nn.Transformer(E, H, 1, 2, FF, 0.0,
                                  normalize_before=True),
        _transformer, [(2, 7, E), (2, 5, E), _SRC_MASK]),
}
BF16 = ["LSTM_bidirect_lengths", "GRU", "SimpleRNN",
        "MultiHeadAttention_kv_bool_mask", "TransformerEncoderLayer",
        "TransformerDecoder_pre_gelu_cache", "Transformer"]


def _layer_names(module):
    return set(importlib.import_module(f"paddle_tpu.nn.layer.{module}")
               .__all__)


def test_every_reference_layer_has_a_case():
    names = {c.split("_")[0] for c in CASES}
    for m in ("rnn", "transformer"):
        ref = _layer_names(m)
        port = importlib.import_module(f"paddle_tpu_torch.nn.layer.{m}")
        assert sorted(port.__all__) == sorted(ref), m
        assert ref - {"RNNCellBase"} <= names, ref - names
    ref_nn = importlib.import_module("paddle_tpu.nn.decode")
    assert sorted(pt.nn.decode.__all__) == sorted(ref_nn.__all__)


def _build(case_id, dtype="float32"):
    make = CASES[case_id][0]
    paddle_tpu.set_default_dtype(dtype)
    pt.set_default_dtype(dtype)
    paddle_tpu.seed(3)
    jl = make(paddle_tpu.nn)
    tl = make(pt.nn)
    C.carry(jl, tl)
    assert [(k, tuple(v.shape)) for k, v in tl.state_dict().items()] == [
        (k, tuple(v.shape)) for k, v in jl.state_dict().items()]
    return jl, tl


def _run(case_id, dtype="float32"):
    _, call, specs = CASES[case_id]
    jl, tl = _build(case_id, dtype)
    arrays = C.make_inputs(specs, seed=len(case_id))
    jcall = types.MethodType(lambda self, *t: call(self, paddle_tpu, *t), jl)
    want, wg, wp = C.run_jax(jcall, arrays, len(case_id), dtype=dtype,
                             params=list(jl.named_parameters()))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got, gg, gp = C.run_port(lambda *t: call(tl, pt, *t), arrays,
                             len(case_id), dtype=tdt,
                             params=list(tl.named_parameters()))
    assert len(gg) == len(wg) and set(gp) == set(wp)
    return want, wg, wp, got, gg, gp


@pytest.mark.parametrize("case_id", sorted(CASES))
def test_layer_matches_reference(case_id):
    want, wg, wp, got, gg, gp = _run(case_id)
    tol = None if case_id.endswith("Cell") else STACK_TOL
    C.close(got, want, tol=tol, what="out")
    for i, (g, w) in enumerate(zip(gg, wg)):
        C.close(g, w, tol=tol, what=f"input grad {i}")
    for k in wp:
        C.close(gp[k], wp[k], tol=tol, what=f"grad of {k}")


@pytest.mark.parametrize("case_id", BF16)
def test_layer_matches_reference_bf16(case_id):
    want, wg, wp, got, gg, gp = _run(case_id, "bfloat16")
    top = RNN_BF16_TOP if case_id.split("_")[0] in (
        "LSTM", "GRU", "SimpleRNN") else ATTENTION_BF16_TOP

    def close(a, b, what, scale=None):
        scale = max(float(np.abs(b).max()) if scale is None else scale,
                    1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=top * scale,
                                   err_msg=what)
    close(got, want, "out")
    for i, (g, w) in enumerate(zip(gg, wg)):
        close(g, w, f"input grad {i}")
    for k in wp:
        if k.endswith("k_proj.bias"):   # 0 but for rounding on both sides
            scale = float(np.abs(wp[k[:-4] + "weight"]).max())
            assert np.abs(gp[k]).max() <= top * scale, k
            assert np.abs(wp[k]).max() <= top * scale, k
            continue
        close(gp[k], wp[k], f"grad of {k}")


def test_rnn_dropout_between_layers():
    """Dropout acts between the layers in training only: eval equals a
    dropout-free twin; training at p = 0.5 differs from it and repeats
    after the same seed."""
    pt.seed(0)
    a = pt.nn.LSTM(5, 7, 2, dropout=0.5)
    b = pt.nn.LSTM(5, 7, 2)
    b.set_state_dict(a.state_dict())
    x = torch.randn(3, 6, 5)
    a.eval()
    torch.testing.assert_close(a(x)[0], b(x)[0], rtol=0, atol=0)
    a.train()
    pt.seed(4)
    y1 = a(x)[0]
    pt.seed(4)
    assert torch.equal(a(x)[0], y1) and not torch.equal(y1, b(x)[0])


def test_square_subsequent_mask_and_need_weights():
    m = pt.nn.Transformer(E, H, 1, 1, FF, 0.0).generate_square_subsequent_mask(4)
    want = paddle_tpu.nn.Transformer(E, H, 1, 1, FF, 0.0) \
        .generate_square_subsequent_mask(4)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want.numpy()))
    mha = pt.nn.MultiHeadAttention(E, H, need_weights=True)
    out, w = mha(torch.randn(1, 3, E))
    assert w is None and tuple(out.shape) == (1, 3, E)


def _beam(pkg, beam, vocab=11, hidden=12, emb=6):
    nn = pkg.nn
    cell = nn.LSTMCell(emb, hidden)
    embed = nn.Embedding(vocab, emb)
    proj = nn.Linear(hidden, vocab)
    holder = nn.LayerList([cell, embed, proj])
    dec = nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                               beam_size=beam, embedding_fn=embed,
                               output_fn=proj)
    return holder, dec


@pytest.mark.parametrize("beam,steps", [(4, 8), (3, 12)])
def test_beam_search_decoder_matches_reference(beam, steps):
    """``dynamic_decode`` over an LSTM cell: the backtraced ids
    ([batch, T, beam]) and the lengths equal the reference's, from the
    same weights and initial states (random weights: no two scores of a
    step tie)."""
    paddle_tpu.seed(5)
    jh, jdec = _beam(paddle_tpu, beam)
    th, tdec = _beam(pt, beam)
    C.carry(jh, th)
    rng = np.random.RandomState(beam)
    h0, c0 = (rng.randn(2, 12).astype(np.float32) for _ in range(2))
    jout, jlen = paddle_tpu.nn.dynamic_decode(
        jdec, (paddle_tpu.to_tensor(h0), paddle_tpu.to_tensor(c0)),
        max_step_num=steps, return_length=True)
    tout, tlen = pt.nn.dynamic_decode(
        tdec, (torch.from_numpy(h0), torch.from_numpy(c0)),
        max_step_num=steps, return_length=True)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout.numpy()))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen.numpy()))
    tm, _ = pt.nn.dynamic_decode(tdec, (torch.from_numpy(h0),
                                        torch.from_numpy(c0)),
                                 max_step_num=steps, output_time_major=True,
                                 return_length=True)
    assert torch.equal(tm.movedim(0, 1), tout)


def test_beam_search_ties_take_the_lowest_index():
    """Equal scores: the beams are the lowest flat indices, in order,
    as ``jax.lax.top_k`` takes them."""
    class Flat(torch.nn.Module):
        def forward(self, x, states):
            return torch.zeros(x.shape[0], 6), states

    dec = pt.nn.BeamSearchDecoder(Flat(), 0, 5, 3)
    ids, st = dec.initialize(torch.zeros(2, 1))
    out, st, ids, fin = dec.step(0, ids, st)
    assert out["token"].tolist() == [[0, 1, 2]] * 2
    assert out["parent"].tolist() == [[0, 0, 0]] * 2
