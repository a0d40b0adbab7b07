"""Static graph core: Program, Scope and record mode (port of
``paddle_tpu/static/program.py``; reference python/paddle/fluid/framework.py
Program:5206, Block:3540, Variable:1238).

A Program is the list of ops recorded at the record point
(``core/dispatch.py``) while ``enable_static()`` is on: each
:class:`StaticNode` holds the op, where its inputs come from (a program
variable or a constant) and which variables its outputs are. A variable
is a symbolic value, a tensor on the ``meta`` device that carries the
shape and dtype (the JAX package's ``jax.ShapeDtypeStruct``).
``Executor.run`` replays the nodes on real tensors (``executor.py``).
Parameters met while recording are registered by name and read from the
Scope at run time, which gives static training (``append_backward`` /
``minimize``) the reference's semantics.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core import dispatch

__all__ = ["Program", "StaticNode", "static_state", "in_static_mode",
           "default_main_program", "default_startup_program",
           "program_guard", "enable_static", "disable_static", "Scope",
           "global_scope"]


class Scope:
    """Name -> tensor store (reference framework/scope.h)."""

    def __init__(self):
        self.vars: Dict[str, Any] = {}

    def var(self, name):
        return self.vars.get(name)

    def set(self, name, value):
        self.vars[name] = value

    def find_var(self, name):
        return self.vars.get(name)


_SCOPE_STACK: List[Scope] = [Scope()]


def global_scope() -> Scope:
    """The ACTIVE scope (top of the scope_guard stack)."""
    return _SCOPE_STACK[-1]


def _push_scope(scope: Scope):
    _SCOPE_STACK.append(scope)


def _pop_scope():
    if len(_SCOPE_STACK) > 1:
        _SCOPE_STACK.pop()


class StaticNode:
    """One recorded op: ``fn(*flat)`` over the values of ``in_ids``
    (``("var", id)``, ``("const", value)`` or ``("device", None)``, the
    executor's device where the op was given the meta device) returns the
    op's output, whose tensors become the variables ``out_ids`` in
    order."""

    __slots__ = ("fn", "in_ids", "const_args", "out_ids", "name")

    def __init__(self, fn, in_ids, const_args, out_ids, name):
        self.fn = fn
        self.in_ids = in_ids
        self.const_args = const_args
        self.out_ids = out_ids
        self.name = name

    def __repr__(self):
        return f"StaticNode({self.name}, in={len(self.in_ids)}, " \
               f"out={len(self.out_ids)})"


class Program:
    """reference Program:5206: records ops; run through Executor."""

    _counter = [0]

    def __init__(self):
        Program._counter[0] += 1
        self.id = Program._counter[0]
        self.nodes: List[StaticNode] = []
        self.var_meta: Dict[int, Tuple[str, Any]] = {}   # id -> (name, meta)
        self.feed_vars: Dict[str, int] = {}              # data() name -> id
        self.param_vars: Dict[str, int] = {}             # param name -> id
        self.param_objs: Dict[str, Any] = {}
        self.train_config = None  # (optimizer, loss var id)
        self._var_names: Dict[int, str] = {}
        self.random_seed = None

    # -- recording helpers (called from the record point) -----------------
    def add_var(self, vid: int, name: str, value):
        self.var_meta[vid] = (name, value)

    def add_node(self, node: StaticNode):
        self.nodes.append(node)

    def register_param(self, param) -> int:
        name = param_name(param)
        vid = id(param)
        if name not in self.param_vars:
            self.param_vars[name] = vid
            self.param_objs[name] = param
            self.add_var(vid, name, param)
        return self.param_vars[name]

    def list_vars(self):
        return list(self.var_meta.values())

    def clone(self, for_test: bool = False) -> "Program":
        p = Program.__new__(Program)
        # a fresh id: the executor caches replays by node identity, and a
        # transformed clone must never alias the original's; _origin_id
        # keeps the optimizer's state continuous across clones
        Program._counter[0] += 1
        p.id = Program._counter[0]
        p._origin_id = getattr(self, "_origin_id", self.id)
        p.nodes = list(self.nodes)
        p.var_meta = dict(self.var_meta)
        p.feed_vars = dict(self.feed_vars)
        p.param_vars = dict(self.param_vars)
        p.param_objs = dict(self.param_objs)
        p.train_config = None if for_test else self.train_config
        p._var_names = dict(self._var_names)
        p.random_seed = self.random_seed
        # gradient-fetch bookkeeping survives transforms: without it a
        # grad fetch on the clone would take the non-grad path
        for attr in ("grad_vars", "input_grad_vars", "loss_id"):
            if hasattr(self, attr):
                v = getattr(self, attr)
                setattr(p, attr, dict(v) if isinstance(v, dict) else v)
        return p

    def __repr__(self):
        return (f"Program(id={self.id}, ops={len(self.nodes)}, "
                f"feeds={list(self.feed_vars)}, params={list(self.param_vars)})")

    global_block = lambda self: _BlockView(self)


class _BlockView:
    """Minimal Block facade (reference Block:3540) over a Program."""

    def __init__(self, program):
        self.program = program

    @property
    def ops(self):
        return self.program.nodes

    def var(self, name):
        for vid, (n, value) in self.program.var_meta.items():
            if n == name:
                return value
        raise KeyError(name)


# names of parameters that carry none (a model's plain torch.nn.Parameter)
_plain_names: "dict" = {}
_plain_counter = [0]


def param_name(param) -> str:
    """A parameter's name: the port's ``Parameter.name``, else a name made
    once per tensor (``tensor_param_<i>``) for a plain
    ``torch.nn.Parameter``."""
    name = getattr(param, "name", None)
    if isinstance(name, str) and name:
        return name
    key = id(param)
    hit = _plain_names.get(key)
    if hit is None or hit[0]() is not param:
        import weakref

        hit = (weakref.ref(param), f"tensor_param_{_plain_counter[0]}")
        _plain_counter[0] += 1
        _plain_names[key] = hit
    return hit[1]


def is_param(t) -> bool:
    return isinstance(t, torch.nn.Parameter)


class _StaticState(threading.local):
    def __init__(self):
        self.enabled = False
        self.main_program: Optional[Program] = None
        self.startup_program: Optional[Program] = None


static_state = _StaticState()


def in_static_mode() -> bool:
    return static_state.enabled


def enable_static():
    static_state.enabled = True
    if static_state.main_program is None:
        static_state.main_program = Program()
        static_state.startup_program = Program()
    dispatch.set_recording(True)


def disable_static():
    static_state.enabled = False
    dispatch.set_recording(False)


def default_main_program() -> Program:
    if static_state.main_program is None:
        static_state.main_program = Program()
        static_state.startup_program = Program()
    return static_state.main_program


def default_startup_program() -> Program:
    if static_state.startup_program is None:
        static_state.startup_program = Program()
    return static_state.startup_program


class program_guard:
    """reference fluid/framework.py:7228."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program or Program()

    def __enter__(self):
        self._prev = (static_state.main_program, static_state.startup_program)
        static_state.main_program = self.main
        static_state.startup_program = self.startup
        return self

    def __exit__(self, *exc):
        static_state.main_program, static_state.startup_program = self._prev
        return False
