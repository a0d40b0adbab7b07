"""The monitor's per-op part against the JAX package's
(``paddle_tpu_torch.monitor`` vs ``paddle_tpu.monitor``):

- ``paddle_tpu_op_latency_seconds{op}``: one observation per outermost op
  of a short program, the same op names and counts as the reference's
  histogram for the same program (the reference's ``impl`` for ``mean``
  is ROADMAP C-ref-9);
- the flag push: ``FLAGS_enable_monitor`` installs the hook and puts the
  record point's mode on torch's stack, turning it off leaves
  ``op_span_hook`` at None and the stack empty;
- ``monitored_jit`` over ``torch.compile`` on the CPU: one miss and one
  compile-seconds series per program (shape signature), program ids
  ``<name>:<hash>`` as the reference's; ``jit.to_static`` registers
  through it and compiles with the monitor on (the record point stays out
  of the graph).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import monitor as jmon
import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.core import op_hooks as thooks
from paddle_tpu_torch.nn import functional as F

from torch_jax_state import jax_reference_state, one_thread  # noqa: F401

BACKEND = "aot_eager"   # inductor's first CPU compile takes ~30 s


@pytest.fixture(autouse=True, scope="module")
def cpu_place():
    from paddle_tpu_torch.core import place

    saved = place._current[0]
    pt.set_device("cpu")
    yield
    place._current[0] = saved


@pytest.fixture
def both():
    tmon.enable()
    jmon.enable()
    tmon.reset()
    jmon.reset()
    try:
        yield
    finally:
        tmon.reset()
        jmon.reset()
        tmon.disable()
        jmon.disable()
    assert thooks.op_span_hook is None
    assert torch._C._len_torch_function_stack() == 0


def _counts(mon, rename=None):
    snap = mon.snapshot()["metrics"]
    out = {}
    for s in snap["paddle_tpu_op_latency_seconds"]["samples"]:
        op = s["labels"]["op"]
        op = (rename or {}).get(op, op)
        out[op] = out.get(op, 0) + s["count"]
    return out


def test_latency_histogram_equals_the_reference(both):
    xs = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    ws = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    tx, tw = torch.from_numpy(xs), torch.from_numpy(ws)
    tlin = pt.nn.Linear(8, 2)
    jx, jw = jpaddle.to_tensor(xs), jpaddle.to_tensor(ws)
    jlin = jpaddle.nn.Linear(8, 2)
    tmon.reset()
    jmon.reset()
    for _ in range(3):
        F.gelu(pt.matmul(tx, tw) + 1.0).mean()
        tlin(tx)
        jpaddle.nn.functional.gelu(jpaddle.matmul(jx, jw) + 1.0).mean()
        jlin(jx)
    mine = _counts(tmon)
    ref = _counts(jmon, {"impl": "mean"})
    assert mine == ref == {"matmul": 3, "add": 3, "gelu": 3, "mean": 3,
                           "linear": 3}
    snap = tmon.snapshot()["metrics"]["paddle_tpu_op_latency_seconds"]
    jsnap = jmon.snapshot()["metrics"]["paddle_tpu_op_latency_seconds"]
    assert snap["type"] == jsnap["type"] and snap["help"] == jsnap["help"]
    assert all(s["sum"] > 0 for s in snap["samples"])


def test_kernel_ops_count_forward_calls_only(both):
    """A kernel wrapper is one observation a call; its backward reaches no
    op hook (the reference's backward does not pass apply_op either)."""
    x = torch.randn(2, 6, 3, 16, requires_grad=True)
    w = torch.ones(16, requires_grad=True)
    cos, sin = torch.randn(6, 8), torch.randn(6, 8)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    tmon.reset()
    for _ in range(2):
        y = pt.ops.fused_rope(pt.ops.rms_norm(x, w, 1e-6), cos, sin)
        o = pt.ops.flash_attention(q, q, q, causal=True)
        (y.sum() + o.sum()).backward()
    c = _counts(tmon)
    assert (c["rms_norm"], c["fused_rope"], c["flash_attention"]) == (2, 2, 2)


@pytest.mark.parametrize("on", [True, False])
def test_flag_push_installs_the_hook(on):
    pt.set_flags({"FLAGS_enable_monitor": on})
    try:
        assert tmon.enabled() == on
        assert (thooks.op_span_hook is not None) == on
        assert torch._C._len_torch_function_stack() == int(on)
    finally:
        pt.set_flags({"FLAGS_enable_monitor": False})
    assert not tmon.enabled()
    assert thooks.op_span_hook is None
    assert torch._C._len_torch_function_stack() == 0
    pt.matmul(torch.ones(4, 4), torch.ones(4, 4))
    assert thooks.op_span_hook is None


def _misses(mon, fn):
    snap = mon.snapshot()["metrics"]
    miss = [s for s in snap["paddle_tpu_jit_cache_miss_total"]["samples"]
            if s["labels"]["fn"] == fn]
    secs = [s for s in
            snap["paddle_tpu_jit_compile_seconds_total"]["samples"]
            if s["labels"]["fn"] == fn]
    return miss, secs


def test_monitored_jit_counts_misses_per_program(both):
    import jax.numpy as jnp

    f = tmon.monitored_jit(lambda x: x + 1, name="t_f", backend=BACKEND)
    g = jmon.monitored_jit(lambda x: x + 1, name="t_f")
    for shape in ((2, 2), (2, 2), (3, 3)):
        out = f(torch.ones(shape))
        ref = g(jnp.ones(shape))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert f.compiles == 2
    for mon in (tmon, jmon):
        miss, secs = _misses(mon, "t_f")
        assert len(miss) == 2 and all(s["value"] == 1 for s in miss)
        pids = {s["labels"]["program"] for s in miss}
        assert len(pids) == 2 and all(p.startswith("t_f:") for p in pids)
        assert len(secs) == 2 and all(s["value"] > 0 for s in secs)
        assert {s["labels"]["program"] for s in secs} == pids


def test_to_static_registers_through_monitored_jit(both):
    def f(x):
        return torch.tanh(x) * 2.0

    sf = pt.jit.to_static(f, backend=BACKEND)
    x = torch.randn(3, 4)
    want = (torch.tanh(x) * 2).numpy()
    tmon.reset()
    np.testing.assert_allclose(sf(x).numpy(), want, rtol=1e-6)
    sf(x)
    assert sf.compiles == 1
    miss, secs = _misses(tmon, "to_static:f")
    assert [s["value"] for s in miss] == [1]
    assert secs and secs[0]["value"] > 0
    # the compiled call ran with the record point suspended: no op of its
    # graph reached the histogram
    ops = _counts(tmon) if tmon.snapshot()["metrics"].get(
        "paddle_tpu_op_latency_seconds", {}).get("samples") else {}
    assert "tanh" not in ops and "mul" not in ops
