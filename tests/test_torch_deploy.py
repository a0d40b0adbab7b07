"""The deploy path of paddle_tpu_torch against paddle_tpu's, on the CPU,
mirroring ``tests/test_inference.py``: ``jit.save`` / ``jit.load``, the
Predictor from a saved path and from a layer, the input and output handles,
``inference.aot``, ``Model.save(training=False)``, ``onnx.export``,
``convert_to_mixed_precision`` and the ``FileNotFoundError``s.

Each package saves and serves its own artifact from the same weights (the
JAX package's ``.stablehlo`` + ``.pdiparams``, the port's ``.pt2`` +
``.pdiparams``; the two are not interchangeable), and the Predictors'
outputs are held against each other. A saved program with None dims serves
two batch sizes (and, for the Llama, two sequence lengths) from one
program.

Tolerance: float32 on both sides (the JAX side at matmul precision
"highest"), atol = rtol = 1e-5, as ``tests/test_torch_llama.py`` holds the
Llama forward; the bf16 conversion is exact (the same float32 values, the
same rounding).
"""
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import torch_nn_cases as C
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_config
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import load_paddle_params
from paddle_tpu_torch.inference import aot
from paddle_tpu_torch.static import InputSpec
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

TOL = dict(atol=1e-5, rtol=1e-5)


def _tiny(nn, P):
    class TinyNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.fc2 = nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(P.tanh(self.fc1(x)))
    return TinyNet()


def _pair():
    jm, tm = _tiny(jnn, paddle), _tiny(tnn, pt)
    C.carry(jm, tm)
    return jm, tm


def _x(batch, seed):
    return np.random.RandomState(seed).randn(batch, 8).astype(np.float32)


def _cfg(prefix):
    cfg = tinf.Config(prefix)
    assert cfg.use_gpu() == torch.cuda.is_available()
    cfg.disable_gpu()
    return cfg


def test_jit_save_load_predictor_two_batches(tmp_path):
    jm, tm = _pair()
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    paddle.jit.save(jm, jp, input_spec=[paddle.static.InputSpec(
        [None, 8], "float32")])
    tjit.save(tm, tp, input_spec=[InputSpec([None, 8], "float32")])
    assert os.path.exists(tp + ".pdiparams") and os.path.exists(tp + ".pt2")
    # the program holds no weights: it is a few KB, whatever the layer
    sd = tjit.load(tp)
    assert list(sd) == list(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v)
    jpred = paddle.inference.create_predictor(paddle.inference.Config(jp))
    tpred = tinf.create_predictor(_cfg(tp))
    assert tpred.get_input_names() == ["x0"]
    for batch, seed in ((2, 3), (5, 4)):
        x = _x(batch, seed)
        got = tpred.run([x])[0]
        np.testing.assert_allclose(got, jpred.run([x])[0], **TOL)
        with torch.no_grad():
            want = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=0)
    blob = tpred.get_serialized_program()
    assert blob and len(blob) < os.path.getsize(tp + ".pt2") + 1024


def test_llama_predictor_two_shapes_from_one_program(tmp_path):
    paddle.seed(9)
    jm = JaxLlama(jax_config("tiny", num_hidden_layers=2))
    jm.eval()
    tm = pt.LlamaForCausalLM(pt.llama_config("tiny", num_hidden_layers=2),
                             device="cpu")
    load_paddle_params(tm, {k: np.asarray(p.value)
                            for k, p in jm.named_parameters()})
    tm.eval()
    tp = str(tmp_path / "llama")
    tjit.save(tm, tp, input_spec=[InputSpec([None, None], "int64")])
    pred = tinf.create_predictor(_cfg(tp))
    nodes = [str(n.target) for n in pred._exported.graph.nodes
             if str(n.target).startswith("paddle_tpu.")]
    assert {n.split(".")[1] for n in nodes} == {"rms_norm", "fused_rope",
                                                "flash_fwd"}
    rng = np.random.RandomState(2)
    for shape in ((1, 7), (3, 12)):
        ids = rng.randint(0, tm.config.vocab_size, shape)
        got = pred.run([ids])[0]
        want = np.asarray(jm(paddle.Tensor(ids.astype(np.int32))).value)
        np.testing.assert_allclose(got, want, **TOL)


def test_from_layer_and_handles():
    jm, tm = _pair()
    x = _x(2, 1)
    jpred = paddle.inference.Predictor.from_layer(jm, [x])
    tpred = tinf.Predictor.from_layer(tm, [x])
    np.testing.assert_allclose(tpred.run([x])[0], jpred.run([x])[0], **TOL)
    # one program, another batch (the JAX package compiles one shape)
    x4 = _x(4, 5)
    with torch.no_grad():
        want = tm(torch.from_numpy(x4)).numpy()
    np.testing.assert_allclose(tpred.run([x4])[0], want, rtol=0, atol=0)
    names = tpred.get_input_names()
    tpred.get_input_handle(names[0]).copy_from_cpu(x)
    assert tpred.run() is True
    out = tpred.get_output_handle("out0")
    assert out.shape() == [2, 4]
    np.testing.assert_allclose(out.copy_to_cpu(), jpred.run([x])[0], **TOL)


def test_from_layer_precision_matches_jax():
    """``precision`` casts the weights (and here the inputs) to bf16; the
    JAX package computes with the bf16 weights in fp32, the port in bf16:
    held at bf16's tolerance (2^-6 of the output's scale,
    ``torch_nn_cases.close``)."""
    jm, tm = _pair()
    x = _x(3, 7)
    want = paddle.inference.Predictor.from_layer(
        jm, [x], precision="bfloat16").run([x])[0]
    pred = tinf.Predictor.from_layer(tm, [x], precision="bfloat16")
    got = pred.run([x])[0]
    assert got.dtype == np.float32        # bf16 outputs come back as fp32
    C.close(got, np.asarray(want, np.float32), dtype="bfloat16")
    assert tm.fc1.weight.dtype == torch.float32     # the layer is untouched


def test_aot_export_roundtrip(tmp_path):
    from paddle_tpu.inference.aot import (export_fn as jexport,
                                          load_exported as jload,
                                          save_exported as jsave)

    x = np.random.RandomState(2).randn(4, 4).astype(np.float32)
    jp, tp = str(tmp_path / "f.stablehlo"), str(tmp_path / "f.pt2")
    jsave(jexport(lambda v: paddle.tanh(paddle.Tensor(v)).value * 2, x), jp)
    tex = aot.export_fn(lambda v: torch.tanh(v) * 2, torch.from_numpy(x))
    aot.save_exported(tex, tp)
    got = aot.load_exported(tp).module()(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(jload(jp).call(x)),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), np.tanh(x) * 2, rtol=1e-6)
    assert aot.serialize_exported(tex)


def test_model_save_inference_and_onnx(tmp_path):
    jm, tm = _pair()
    jmodel = paddle.Model(jm, inputs=[paddle.static.InputSpec([None, 8],
                                                              "float32")])
    tmodel = pt.Model(tm, inputs=[InputSpec([None, 8], "float32")])
    jp, tp = str(tmp_path / "jinfer"), str(tmp_path / "tinfer")
    jmodel.save(jp, training=False)
    tmodel.save(tp, training=False)
    x = _x(3, 6)
    want = paddle.inference.create_predictor(
        paddle.inference.Config(jp)).run([x])[0]
    np.testing.assert_allclose(
        tinf.create_predictor(_cfg(tp)).run([x])[0], want, **TOL)
    op = str(tmp_path / "onnx")
    with pytest.warns(UserWarning, match="NOT a .onnx file"):
        assert pt.onnx.export(tm, op, input_spec=[InputSpec([None, 8])]) \
            == op
    assert os.path.exists(op + ".pt2") and not os.path.exists(op + ".onnx")
    np.testing.assert_allclose(
        tinf.create_predictor(_cfg(op)).run([x])[0], want, **TOL)
    with pytest.raises(ValueError, match="input_spec"):
        pt.onnx.export(tm, op)


def test_mixed_precision_conversion(tmp_path):
    jm, tm = _pair()
    jp, tp = str(tmp_path / "jfp32"), str(tmp_path / "tfp32")
    paddle.jit.save(jm, jp)
    tjit.save(tm, tp)
    assert not os.path.exists(tp + ".pt2")     # no input_spec: no program
    jd, td = str(tmp_path / "j.pdiparams"), str(tmp_path / "t.pdiparams")
    paddle.inference.convert_to_mixed_precision(None, jp + ".pdiparams",
                                                None, jd)
    tinf.convert_to_mixed_precision(None, tp + ".pdiparams", None, td)
    from paddle_tpu.framework.io import load as jload

    want = jload(jd)
    got = pt.load(td, device="cpu")
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16, k
        w = np.asarray(getattr(want[k], "value", want[k])).astype(np.float32)
        np.testing.assert_array_equal(v.detach().float().numpy(), w,
                                      err_msg=k)


def test_missing_artifacts_raise(tmp_path):
    _, tm = _pair()
    with pytest.raises(FileNotFoundError, match="no serving artifact"):
        tinf.create_predictor(_cfg(str(tmp_path / "nothing")))
    p = str(tmp_path / "weights_only")
    tjit.save(tm, p)
    with pytest.raises(FileNotFoundError, match="input_spec"):
        tinf.create_predictor(_cfg(p))
    q = str(tmp_path / "program_only")
    tjit.save(tm, q, input_spec=[InputSpec([None, 8])])
    os.remove(q + ".pdiparams")
    with pytest.raises(FileNotFoundError, match="weights file"):
        tinf.create_predictor(_cfg(q))
    cfg = tinf.Config(q)
    with pytest.raises(NotImplementedError, match="TensorRT"):
        cfg.enable_tensorrt_engine()


def test_gpu_config_needs_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _pair()
    p = str(tmp_path / "m")
    tjit.save(tm, p, input_spec=[InputSpec([None, 8])])
    cfg = tinf.Config(p)
    assert not cfg.use_gpu()          # no card: the CPU, as the reference
    cfg.enable_use_gpu()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.create_predictor(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg.disable_gpu()
        assert tinf.create_predictor(cfg).run([_x(1, 0)])[0].shape == (1, 4)
