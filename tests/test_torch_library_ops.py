"""The kernels K1, K2, K3, K5 and K6 as ``paddle_tpu::`` library ops, on the
CPU (their plain versions).

- ``torch.library.opcheck`` of every op (schema, fake tensor, autograd
  registration, AOT dispatch with dynamic shapes) in float32 and bfloat16,
  causal and not, MHA and GQA, with and without dropout.
- Each op equals the eager wrapper it stands for, bitwise: the ops' CPU
  implementations are the plain versions the eager wrappers run, and the
  gradient of ``paddle_tpu::flash_fwd`` through ``flash_bwd_dq`` and
  ``flash_bwd_dkv`` equals ``FlashAttention``'s backward.
- ``torch.export`` of a 2-layer tiny Llama holds one node per kernel call
  (4 L + 1 ``rms_norm``, 2 L ``fused_rope``, L ``flash_fwd``), at a
  dynamic batch and sequence, and its logits equal the eager forward's and
  the JAX package's at two shapes from one program.
- The eager path is as it was: an eager call never enters the ops, the
  eager step's plain-version calls are the counts the card's launch counts
  follow (4 L + 1 ``rms_norm``, 6 L ``fused_rope``, 2 L ``flash_fwd``, L of
  each backward kernel under full recompute), and the program cost counter
  counts a kernel once, whether it is reached through its wrapper or its
  op (the op is not counted again as a dispatcher op).

Tolerance: the exported forward against the eager one is bitwise (the same
ops on the same inputs); against the JAX package atol = rtol = 1e-5, as
``tests/test_torch_llama.py``.
"""
import numpy as np
import pytest
import torch
from torch.library import opcheck

import paddle_tpu as paddle
import paddle_tpu_torch as pt
import torch_nn_cases as C
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_config
from paddle_tpu_torch import load_paddle_params
from paddle_tpu_torch.monitor import _programs
from paddle_tpu_torch.ops import flash_attention_kernel as fa
from paddle_tpu_torch.ops import fused_kernels as fk
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

OPS = torch.ops.paddle_tpu
TOL = dict(atol=1e-5, rtol=1e-5)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _randn(*shape, seed=0, dtype=torch.float32, grad=False):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_opcheck_rms_norm(dt):
    x = _randn(2, 5, 3, 64, seed=1, dtype=DTYPES[dt], grad=True)
    w = _randn(64, seed=2, dtype=DTYPES[dt], grad=True)
    opcheck(OPS.rms_norm.default, (x, w, 1e-6))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_opcheck_fused_rope(dt):
    x = _randn(2, 6, 3, 16, seed=3, dtype=DTYPES[dt], grad=True)
    cos, sin = _randn(6, 8, seed=4), _randn(6, 8, seed=5)
    opcheck(OPS.fused_rope.default, (x, cos.to(DTYPES[dt]),
                                     sin.to(DTYPES[dt])))


FLASH_CASES = {
    "causal_mha": dict(hkv=4, causal=True, p=0.0),
    "causal_gqa": dict(hkv=2, causal=True, p=0.0),
    "full_gqa": dict(hkv=1, causal=False, p=0.0),
    "causal_dropout": dict(hkv=2, causal=True, p=0.25),
}


def _flash_inputs(case, dt, grad):
    c = FLASH_CASES[case]
    q = _randn(2, 70, 4, 16, seed=6, dtype=DTYPES[dt], grad=grad)
    k = _randn(2, 70, c["hkv"], 16, seed=7, dtype=DTYPES[dt], grad=grad)
    v = _randn(2, 70, c["hkv"], 16, seed=8, dtype=DTYPES[dt], grad=grad)
    return q, k, v, c


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_opcheck_flash_ops(case, dt):
    q, k, v, c = _flash_inputs(case, dt, True)
    args = (c["causal"], None, c["p"], 11)
    opcheck(OPS.flash_fwd.default, (q, k, v) + args)
    out, lse = OPS.flash_fwd(q, k, v, *args)
    do = _randn(*out.shape, seed=9, dtype=out.dtype)
    bwd = (q.detach(), k.detach(), v.detach(), do, lse.detach(),
           fa._delta(out.detach(), do)) + args
    opcheck(OPS.flash_bwd_dq.default, bwd)
    opcheck(OPS.flash_bwd_dkv.default, bwd)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_op_equals_eager_wrapper(case):
    q, k, v, c = _flash_inputs(case, "f32", True)
    args = (c["causal"], None, c["p"], 11)
    out_e = fa.FlashAttention.apply(q, k, v, *args)
    do = _randn(*out_e.shape, seed=9)
    ge = torch.autograd.grad(out_e, (q, k, v), do)
    out_o, _ = OPS.flash_fwd(q, k, v, *args)
    go = torch.autograd.grad(out_o, (q, k, v), do)
    assert torch.equal(out_o, out_e)
    for a, b in zip(go, ge):
        assert torch.equal(a, b)


def test_norm_rope_ops_equal_eager_wrappers():
    x = _randn(2, 6, 3, 16, seed=3, grad=True)
    w = _randn(16, seed=2, grad=True)
    cos, sin = _randn(6, 8, seed=4), _randn(6, 8, seed=5)
    ct = _randn(2, 6, 3, 16, seed=10)
    for eager, op, ins in ((pt.ops.rms_norm, OPS.rms_norm, (x, w, 1e-6)),
                           (pt.ops.fused_rope, OPS.fused_rope,
                            (x, cos, sin))):
        ye, yo = eager(*ins), op(*ins)
        assert torch.equal(ye, yo)
        wrt = (x, w) if op is OPS.rms_norm else (x,)
        ge = torch.autograd.grad(ye, wrt, ct)
        go = torch.autograd.grad(yo, wrt, ct)
        for a, b in zip(go, ge):
            assert torch.equal(a, b)


def _pair(L=2, seed=4):
    paddle.seed(seed)
    jm = JaxLlama(jax_config("tiny", num_hidden_layers=L))
    jm.eval()
    tm = pt.LlamaForCausalLM(pt.llama_config("tiny", num_hidden_layers=L),
                             device="cpu")
    load_paddle_params(tm, {k: np.asarray(p.value)
                            for k, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def _op_nodes(ep):
    out = {}
    for n in ep.graph.nodes:
        if n.op == "call_function" and str(n.target).startswith(
                "paddle_tpu."):
            name = str(n.target).split(".")[1]
            out[name] = out.get(name, 0) + 1
    return out


def test_export_llama_holds_the_kernel_nodes():
    L = 2
    jm, tm = _pair(L)
    B = torch.export.Dim("batch", min=1, max=64)
    S = torch.export.Dim("seq", min=1, max=1024)
    ids = torch.zeros(2, 8, dtype=torch.int64)
    ep = torch.export.export(tm, (ids,), dynamic_shapes=({0: B, 1: S},),
                             strict=False)
    assert _op_nodes(ep) == {"rms_norm": 2 * L + 1, "fused_rope": 2 * L,
                             "flash_fwd": L}
    rng = np.random.RandomState(8)
    for shape in ((1, 5), (3, 17)):
        x = rng.randint(0, tm.config.vocab_size, shape)
        got = ep.module()(torch.from_numpy(x)).detach()
        with torch.no_grad():
            want = tm(torch.from_numpy(x))
        assert torch.equal(got, want)
        jw = np.asarray(jm(paddle.Tensor(x.astype(np.int32))).value)
        np.testing.assert_allclose(got.numpy(), jw, **TOL)


def test_eager_path_never_enters_the_ops(monkeypatch):
    """The eager forward and backward run the wrappers as before: a call
    through the dispatcher to any paddle_tpu:: op would be counted here."""
    entered = []

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "paddle_tpu":
                entered.append(func.name())
            return func(*args, **(kwargs or {}))

    _, tm = _pair(2)
    tm.train()
    tm.config.recompute = "full"
    ids = torch.randint(0, tm.config.vocab_size, (2, 9))
    with Spy():
        tm(ids, ids).backward()
    assert entered == []


def test_cost_counter_counts_a_kernel_once():
    x = _randn(4, 64, seed=1)
    w = _randn(64, seed=2)
    _, via_wrapper = _programs.count_cost(lambda: pt.ops.rms_norm(x, w))
    _, via_op = _programs.count_cost(lambda: OPS.rms_norm(x, w, 1e-6))
    flops, nbytes = fk._rms_norm_cost(x, w)
    assert via_wrapper == via_op == {"flops": float(flops),
                                     "bytes_accessed": float(nbytes)}
