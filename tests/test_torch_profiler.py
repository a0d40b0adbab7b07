"""The port's profiler and op-hook chain against the JAX package's
(``paddle_tpu_torch.profiler`` vs ``paddle_tpu.profiler``; the record
point ``paddle_tpu_torch/core/dispatch.py`` vs ``apply_op``).

- ``make_scheduler`` and the tuple scheduler: the same state for every
  step as the reference's;
- ``RecordEvent`` spans and the op hook's ``op::<name>`` spans, the
  Chrome trace's schema and op names for one short program against the
  reference's trace of the same program (the reference names ``mean``
  ``impl``: ROADMAP C-ref-9; the port says ``mean``);
- ``load_profiler_result`` round trips, ``export_chrome_tracing`` and
  ``export_protobuf`` write their files;
- the op-hook chain with the monitor's hook, in either order: fan out,
  no cycle on re-enable, stranded hooks pruned, the slot and torch's mode
  stack empty afterwards (the port's counterpart of the reference's
  ``test_hook_removed_after_stop``, which must pass in any order here);
- a kernel wrapper is one op: one span under its kernel's name, none for
  the torch calls inside it.

Every profiler is stopped and the monitor turned off in ``finally``.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import profiler as jprof
from paddle_tpu.core import op_hooks as jhooks
import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.core import op_hooks as thooks
from paddle_tpu_torch.nn import functional as F

from torch_jax_state import jax_reference_state, one_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def cpu_place():
    from paddle_tpu_torch.core import place

    saved = place._current[0]
    pt.set_device("cpu")
    yield
    place._current[0] = saved


@pytest.fixture(autouse=True)
def clean_slot():
    """Each test starts and ends with no hook and no mode on the stack."""
    assert thooks.op_span_hook is None
    yield
    tmon.disable()
    assert thooks.op_span_hook is None
    assert torch._C._len_torch_function_stack() == 0


def _cases():
    return [dict(closed=1, ready=1, record=2, repeat=1),
            dict(closed=0, ready=0, record=1, skip_first=2),
            dict(closed=2, ready=1, record=3, repeat=2),
            dict(closed=0, ready=2, record=1)]


@pytest.mark.parametrize("kw", _cases())
def test_make_scheduler_states_equal_the_reference(kw):
    s, r = tprof.make_scheduler(**kw), jprof.make_scheduler(**kw)
    for step in range(14):
        assert s(step).name == r(step).name, step


@pytest.mark.parametrize("window", [(1, 3), (0, 2), (2, 4)])
def test_tuple_scheduler_equals_the_reference(window):
    s = tprof.Profiler(scheduler=window).scheduler
    r = jprof.Profiler(scheduler=window).scheduler
    for step in range(8):
        assert s(step).name == r(step).name, step


def _short_program_port():
    """The program over inputs and a layer made beforehand (their
    creation ops are the packages' own, not the program's)."""
    x = pt.to_tensor(np.ones((4, 8), np.float32), place="cpu")
    w = pt.to_tensor(np.full((8, 8), 0.5, np.float32), place="cpu")
    lin = pt.nn.Linear(8, 2)

    def run():
        y = pt.matmul(x, w) + 1.0
        return F.gelu(y).mean(), lin(x)

    return run


def _short_program_ref():
    x = jpaddle.to_tensor(np.ones((4, 8), np.float32))
    w = jpaddle.to_tensor(np.full((8, 8), 0.5, np.float32))
    lin = jpaddle.nn.Linear(8, 2)

    def run():
        y = jpaddle.matmul(x, w) + 1.0
        return jpaddle.nn.functional.gelu(y).mean(), lin(x)

    return run


# C-ref-9: the reference names mean's apply_op after its inner function
REF_NAMES = {"impl": "mean"}


def _ref_names():
    seen = []
    prev = jhooks.op_span_hook
    run = _short_program_ref()
    jhooks.op_span_hook = lambda n, a, b: seen.append(n)
    try:
        run()
    finally:
        jhooks.op_span_hook = prev
    return [REF_NAMES.get(n, n) for n in seen]


def test_op_hook_names_equal_the_reference():
    seen = []
    run = _short_program_port()
    thooks.op_span_hook = lambda n, a, b: seen.append(n)
    try:
        run()
    finally:
        thooks.op_span_hook = None
    assert seen == _ref_names() == ["matmul", "add", "gelu", "mean",
                                    "linear"]


def _trace(prof_mod, make, tmp_path, name):
    program = make()
    p = prof_mod.Profiler(targets=[prof_mod.ProfilerTarget.CPU])
    p.start()
    try:
        with prof_mod.RecordEvent("outer"):
            program()
    finally:
        p.stop()
    return json.load(open(p.export(str(tmp_path / name))))


def test_chrome_trace_schema_and_names_equal_the_reference(tmp_path):
    mine = _trace(tprof, _short_program_port, tmp_path, "port.json")
    ref = _trace(jprof, _short_program_ref, tmp_path, "ref.json")
    assert set(mine) == set(ref) == {"traceEvents", "displayTimeUnit"}
    assert mine["displayTimeUnit"] == ref["displayTimeUnit"]
    for doc in (mine, ref):
        for ev in doc["traceEvents"]:
            assert {"name", "ph", "cat", "ts", "dur", "pid", "tid"} <= set(ev)
            assert ev["ph"] == "X" and ev["dur"] >= 0
            assert ev["cat"] == ("op" if ev["name"].startswith("op::")
                                 else "user")
    names = [e["name"] for e in mine["traceEvents"]]
    ref_names = [e["name"].replace("op::impl", "op::mean")
                 for e in ref["traceEvents"]]
    # ordered by end: the spans, then the enclosing user span
    assert names == ref_names == ["op::matmul", "op::add", "op::gelu",
                                  "op::mean", "op::linear", "outer"]


def test_load_profiler_result_round_trips(tmp_path):
    doc = _trace(tprof, _short_program_port, tmp_path, "t.json")
    back = tprof.load_profiler_result(str(tmp_path / "t.json"))
    assert back == doc
    assert back == jprof.load_profiler_result(str(tmp_path / "t.json"))


@pytest.mark.parametrize("kind", ["chrome", "protobuf"])
def test_on_trace_ready_exporters_write(kind, tmp_path):
    make = (tprof.export_chrome_tracing if kind == "chrome"
            else tprof.export_protobuf)
    p = tprof.Profiler(on_trace_ready=make(str(tmp_path), "w0"))
    p.start()
    try:
        with tprof.RecordEvent("x"):
            pass
    finally:
        p.stop()
    pat = "*.paddle_trace.json" if kind == "chrome" else "w0.pb.json"
    files = list(tmp_path.glob(pat))
    assert len(files) == 1 and str(files[0]) == p.last_export
    assert [e["name"] for e in tprof.load_profiler_result(
        str(files[0]))["traceEvents"]] == ["x"]


def test_closed_state_records_nothing():
    p = tprof.Profiler(scheduler=lambda s: tprof.ProfilerState.CLOSED)
    p.start()
    try:
        with tprof.RecordEvent("ghost"):
            pass
    finally:
        p.stop()
    assert not p._events


def test_step_schedule_arms_and_disarms():
    fired = []
    p = tprof.Profiler(
        scheduler=tprof.make_scheduler(closed=1, ready=0, record=1,
                                       repeat=1),
        on_trace_ready=lambda pr: fired.append(True))
    x = torch.ones(4)
    p.start()                   # step 0: CLOSED
    try:
        torch.tanh(x)
        p.step()                # -> step 1: RECORD_AND_RETURN (armed)
        torch.tanh(x)
        p.step()                # -> step 2: CLOSED (disarm + callback)
    finally:
        p.stop()
    assert fired == [True]
    assert [e[0] for e in p._events].count("op::tanh") == 1


def test_hook_removed_after_stop():
    p = tprof.Profiler()
    p.start()
    assert thooks.op_span_hook is not None
    assert torch._C._len_torch_function_stack() == 1
    p.stop()
    assert thooks.op_span_hook is None
    assert torch._C._len_torch_function_stack() == 0


def _latency(op):
    snap = tmon.snapshot()["metrics"]
    samples = snap.get("paddle_tpu_op_latency_seconds", {}).get("samples",
                                                                [])
    return sum(s["count"] for s in samples if s["labels"]["op"] == op)


@pytest.mark.parametrize("order", ["monitor_first", "profiler_first"])
def test_op_hook_fans_out_to_monitor(order):
    x = torch.ones(8, 8)
    p = tprof.Profiler()
    try:
        if order == "monitor_first":
            tmon.enable()
            tmon.reset()
            p.start()
        else:
            p.start()
            tmon.enable()
            tmon.reset()
        pt.matmul(x, x)
        p.stop()
        assert [e[0] for e in p._events].count("op::matmul") == 1
        assert thooks.op_span_hook is not None   # the monitor's stays
        assert _latency("matmul") == 1
        pt.matmul(x, x)                          # after stop: monitor only
        assert _latency("matmul") == 2
    finally:
        p.stop()
        tmon.reset()
        tmon.disable()


def test_reenable_under_profiler_does_not_cycle():
    x = torch.ones(4)
    tmon.enable()
    p = tprof.Profiler()
    try:
        p.start()
        tmon.enable()     # idempotent re-enable mid-window
        tmon.disable()    # cannot leave the chain (the profiler is on top)
        tmon.enable()     # ...and must not chain a second copy
        torch.tanh(x)     # RecursionError if cyclic
        p.stop()
        torch.tanh(x)
    finally:
        p.stop()
        tmon.disable()


def test_stranded_hook_does_not_double_count_later_windows():
    x = torch.ones(4, 4)
    p1 = tprof.Profiler()
    p1.start()
    tmon.enable()         # installs on top of p1's hook
    try:
        p1.stop()         # p1's hook is stranded under the monitor
        p2 = tprof.Profiler()
        p2.start()
        pt.matmul(x, x)
        p2.stop()
        assert [e[0] for e in p2._events].count("op::matmul") == 1
    finally:
        tmon.disable()


def test_kernel_wrapper_is_one_op():
    x = torch.randn(2, 6, 3, 16)
    w = torch.ones(16)
    cos, sin = torch.randn(6, 8), torch.randn(6, 8)
    q = torch.randn(1, 8, 2, 16)
    seen = []
    thooks.op_span_hook = lambda n, a, b: seen.append(n)
    try:
        pt.ops.rms_norm(x, w, 1e-6)
        pt.ops.fused_rope(x, cos, sin)
        pt.ops.flash_attention(q, q, q, causal=True)
    finally:
        thooks.op_span_hook = None
    assert seen == ["rms_norm", "fused_rope", "flash_attention"]
