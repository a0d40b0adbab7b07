"""The port's op record point: the counterpart of the two branches of the
JAX package's ``apply_op`` (``paddle_tpu/core/autograd.py:153-170``).

There every op passes one Python function, which times it for
``op_hooks.op_span_hook`` and, while static mode is on, records it into
the default Program instead of running it. The port's tensor is
``torch.Tensor`` itself, so most ops are torch's own functions and
methods (``a + 1.0``, ``x.mean()``, ``F.gelu``), which no decorator of the
port's would see. The record point is therefore two things:

- a ``torch.overrides.TorchFunctionMode``, :class:`_RecordPoint`, on
  torch's mode stack of a thread only while a hook is installed or the
  thread records a program (:func:`sync` puts it on and takes it off).
  It sees every outermost torch function call; torch takes a mode off its
  stack while the mode handles a call, so the calls inside an op's body
  never reach it, as an op's body never re-enters ``apply_op``;
- :func:`op`, a decorator for the port's functions that are one op of the
  reference: the kernel wrappers (``rms_norm``, ``fused_rope``,
  ``flash_attention``: their ``ctypes`` launches are outside torch's
  dispatcher) and the ``nn.functional`` ops under ``amp_op``. A decorated
  call is one op: one span under its reference name, one recorded node,
  and the torch calls inside it report and record nothing.

An op records (``static/record.py::record_call``) when this thread records
and one of its inputs is symbolic: a tensor on the ``meta`` device (a
``static.data`` placeholder or a recorded op's output), or a ``meta``
device argument (a creation op given ``device=x.device``). The output's
shape and dtype come from running the op on ``meta`` tensors, or, for a
kernel, from its library op's registered fake (``meta=``). An op with no
symbolic input runs eagerly, in static mode too: layer construction and
the initializers run that way.

With no hook installed and no program recording, nothing is on torch's
mode stack and a decorated op pays one call and one bool test. Compiled
programs (``jit.to_static``, ``monitored_jit``, ``torch.export``) run
under :func:`suspended`: the mode comes off the stack and decorated ops
go straight through, so nothing of the record point enters a graph.

The torch mode stack is per thread: ``sync`` puts the mode on the stack
of the thread that installs a hook or enables static mode. A decorated op
reports its span from any thread; torch's own ops report only from the
threads whose stack holds the mode.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from . import op_hooks

__all__ = ["op", "sync", "suspended", "internal", "replaying", "recording",
           "set_recording", "op_name", "is_symbolic", "has_symbolic"]

# torch's names that differ from the reference's op names
_NAMES = {
    "__add__": "add", "__radd__": "add", "__iadd__": "add",
    "__sub__": "sub", "__rsub__": "sub", "__isub__": "sub", "rsub": "sub",
    "__mul__": "mul", "__rmul__": "mul", "__imul__": "mul",
    "__truediv__": "div", "__rtruediv__": "div", "__itruediv__": "div",
    "__div__": "div", "__rdiv__": "div", "true_divide": "div",
    "__floordiv__": "floordiv", "__rfloordiv__": "floordiv",
    "floor_divide": "floordiv",
    "__mod__": "mod", "__rmod__": "mod", "remainder": "mod",
    "__pow__": "pow", "__rpow__": "pow", "__ipow__": "pow",
    "__matmul__": "matmul", "__rmatmul__": "matmul",
    "__neg__": "neg", "negative": "neg", "__abs__": "abs",
    "__invert__": "not", "__eq__": "eq", "__ne__": "ne", "__lt__": "lt",
    "__le__": "le", "__gt__": "gt", "__ge__": "ge", "__and__": "and",
    "__or__": "or", "__xor__": "xor",
}


class _TLS(threading.local):
    def __init__(self):
        self.mode = None        # our mode, while on this thread's stack
        self.depth = 0          # > 0 inside a decorated op
        self.off = 0            # > 0 under suspended()
        self.recording = False  # this thread records a program


_tls = _TLS()
_recording_threads = [0]
# True while a hook is installed or some thread records: the decorated
# ops' one test
_active = False


def op_name(func) -> str:
    """The reference's name of a torch function (``__add__`` -> ``add``;
    a property getter by its property's name)."""
    n = getattr(func, "__name__", None) or type(func).__name__
    if n in ("__get__", "__set__"):
        n = getattr(getattr(func, "__self__", None), "__name__", n)
    return _NAMES.get(n, n)


def _getter(func) -> bool:
    return getattr(func, "__name__", "") in ("__get__", "__set__")


def _meta_leaf(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_meta
    if isinstance(x, torch.device):
        return x.type == "meta"
    return isinstance(x, str) and x == "meta"


def has_symbolic(args, kwargs=None) -> bool:
    """Whether a call of ``args``/``kwargs`` records: a meta tensor or a
    meta device among its leaves."""
    return any(_meta_leaf(x) for x in pytree.tree_leaves((args, kwargs)))


def is_symbolic(x) -> bool:
    """Whether ``x`` is a symbolic value of a program being recorded."""
    return isinstance(x, torch.Tensor) and x.is_meta


def _holds_tensor(out) -> bool:
    if isinstance(out, torch.Tensor):
        return True
    if isinstance(out, (tuple, list)):
        return any(isinstance(o, torch.Tensor) for o in out)
    return False


def _record(name, fn, args, kwargs, meta=None):
    from ..static.record import record_call

    return record_call(name, fn, args, kwargs, meta)


class _RecordPoint(TorchFunctionMode):
    """Sees each outermost torch function call of its thread: records it
    while the thread records and an input is symbolic, else runs it and
    reports its span to ``op_hooks.op_span_hook``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        st = _tls
        if st.depth or st.off:
            return func(*args, **kwargs)
        if st.recording and has_symbolic(args, kwargs):
            return _record(op_name(func), func, args, kwargs)
        hook = op_hooks.op_span_hook
        if hook is None or _getter(func):
            return func(*args, **kwargs)
        t0 = time.perf_counter_ns()
        out = func(*args, **kwargs)
        if _holds_tensor(out):
            hook(op_name(func), t0, time.perf_counter_ns())
        return out


def _stack_top():
    n = torch._C._len_torch_function_stack()
    return torch._C._get_function_stack_at(n - 1) if n else None


def sync() -> None:
    """Put the mode on this thread's stack while a hook is installed or
    the thread records, take it off (when it is on top) otherwise, and
    update the decorated ops' test."""
    global _active
    st = _tls
    want = op_hooks.op_span_hook is not None or st.recording
    if want and st.mode is None:
        st.mode = _RecordPoint()
        torch.overrides._push_mode(st.mode)
    elif not want and st.mode is not None and _stack_top() is st.mode:
        torch.overrides._pop_mode()
        st.mode = None
    _active = (op_hooks.op_span_hook is not None
               or _recording_threads[0] > 0)


def set_recording(on: bool) -> None:
    """Static mode of this thread on or off (``static.enable_static`` /
    ``disable_static``)."""
    st = _tls
    on = bool(on)
    if on != st.recording:
        _recording_threads[0] += 1 if on else -1
        st.recording = on
    sync()


def recording() -> bool:
    """Whether this thread records (static mode on)."""
    return _tls.recording


@contextlib.contextmanager
def suspended():
    """Nothing of the record point on this thread for the block: the mode
    off the stack (when it is on top) and decorated ops straight through.
    Compiled programs and quiet replays run so."""
    st = _tls
    st.off += 1
    popped = st.mode is not None and _stack_top() is st.mode
    if popped:
        torch.overrides._pop_mode()
    try:
        yield
    finally:
        if popped:
            torch.overrides._push_mode(st.mode)
        st.off -= 1


@contextlib.contextmanager
def internal():
    """The record point's own work (making a symbolic value, a pass over a
    program): the block's torch calls are not ops of the program."""
    _tls.depth += 1
    try:
        yield
    finally:
        _tls.depth -= 1


@contextlib.contextmanager
def replaying():
    """Run real tensors through a recorded program: this thread does not
    record for the block, and ops report spans if a hook is installed."""
    st = _tls
    was = st.recording
    st.recording = False
    try:
        yield
    finally:
        st.recording = was


def _run(name, fn, meta, args, kwargs):
    st = _tls
    if st.depth or st.off:
        return fn(*args, **kwargs)
    st.depth += 1
    try:
        if st.recording and has_symbolic(args, kwargs):
            return _record(name, _entry[fn], args, kwargs, meta)
        hook = op_hooks.op_span_hook
        if hook is None:
            return fn(*args, **kwargs)
        t0 = time.perf_counter_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            hook(name, t0, time.perf_counter_ns())
    finally:
        st.depth -= 1


# the body of a decorated op -> the decorated op (what a node replays)
_entry = {}


def op(name: str, meta: Optional[Callable] = None):
    """Make a function one op of the record point, named ``name`` (the
    reference's op name). ``meta`` computes its outputs on ``meta``
    tensors where the function itself cannot run there (a kernel
    wrapper: its library op, whose registered fake gives the shapes)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if torch.compiler.is_compiling() or not _active:
                return fn(*args, **kwargs)
            return _run(name, fn, meta, args, kwargs)

        _entry[fn] = call
        call.op_name = name
        return call
    return wrap
