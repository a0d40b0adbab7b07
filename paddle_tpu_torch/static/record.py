"""Record-mode op capture, the static graph's counterpart of OpDesc
appending (port of ``paddle_tpu/static/record.py``).

When ``enable_static()`` is on, an op that reaches the record point
(``core/dispatch.py``) with a symbolic input lands here instead of running:
its outputs' shapes and dtypes come from running it on ``meta`` tensors
(the InferShape/InferMeta analog, phi/infermeta/; the JAX package uses
``jax.eval_shape``), or from a kernel's registered fake, and a StaticNode
is appended to the default main Program. A parameter input is registered
by name; a concrete tensor that is no parameter is captured as a
constant.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..core import dispatch
from ..core.dispatch import is_symbolic  # noqa: F401  (the reference's name)
from .program import StaticNode, default_main_program, is_param

__all__ = ["record_op", "record_call", "make_symbolic", "is_symbolic",
           "symbolic_seed"]


def make_symbolic(shape, dtype, name=None):
    """A symbolic value of ``shape`` and ``dtype``, registered as a
    variable of the default main Program."""
    with dispatch.internal():
        t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    prog = default_main_program()
    prog.add_var(id(t), name or f"tmp_{len(prog.var_meta)}", t)
    return t


def _to_meta(t: torch.Tensor) -> torch.Tensor:
    m = torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                            dtype=t.dtype, device="meta")
    return m.requires_grad_(True) if t.requires_grad else m


def _device_leaf(x):
    """``x`` as a device where it names one (a ``torch.device`` or the
    strings ``"cpu"``, ``"meta"``, ``"cuda[:i]"``), else None."""
    if isinstance(x, torch.device):
        return x
    if isinstance(x, str) and (x in ("cpu", "meta") or x.startswith("cuda")):
        return torch.device(x)
    return None


def _replay_fn(fn, spec):
    def node_fn(*flat):
        a, k = pytree.tree_unflatten(list(flat), spec)
        return fn(*a, **k)

    return node_fn


def record_call(name, fn, args, kwargs, meta=None):
    """Record ``fn(*args, **kwargs)`` as one node named ``name`` of the
    default main Program and return its symbolic outputs. ``meta``, where
    given, stands for ``fn`` in the shape computation."""
    prog = default_main_program()
    leaves, spec = pytree.tree_flatten((args, kwargs or {}))
    slots, shaped, foreign = [], [], False
    for x in leaves:
        if isinstance(x, torch.Tensor):
            if x.is_meta:
                foreign = foreign or id(x) not in prog.var_meta
                slots.append(("var", id(x)))
                shaped.append(x)
            elif is_param(x):
                slots.append(("var", prog.register_param(x)))
                shaped.append(_to_meta(x))
            else:
                slots.append(("const", x))
                shaped.append(_to_meta(x))
            continue
        dev = _device_leaf(x)
        if dev is not None:
            slots.append(("device", None) if dev.type == "meta"
                         else ("const", x))
            shaped.append(torch.device("meta"))
        else:
            slots.append(("const", x))
            shaped.append(x)
    a, k = pytree.tree_unflatten(shaped, spec)
    out = (meta or fn)(*a, **k)
    out_leaves, out_spec = pytree.tree_flatten(out)
    if not any(isinstance(o, torch.Tensor) for o in out_leaves) \
            and name != "__setitem__":
        return out          # a query (shape, dtype, device, dim, ...)
    if foreign:
        raise ValueError(
            f"static: op {name!r} got a symbolic value that is no variable "
            f"of the program being recorded (recorded under another "
            f"program, or made on the meta device outside the record "
            f"point)")
    out_ids = []
    for i, o in enumerate(out_leaves):
        if not isinstance(o, torch.Tensor):
            continue
        if id(o) not in prog.var_meta or is_param(o):
            prog.add_var(id(o), f"{name}_{len(prog.nodes)}_{i}", o)
        out_ids.append(id(o))
    prog.add_node(StaticNode(fn=_replay_fn(fn, spec), in_ids=slots,
                             const_args=None, out_ids=out_ids, name=name))
    return out


def record_op(fn, args, kwargs, op_name):
    """The JAX package's entry (``record_op(fn, args, kwargs, op_name)``):
    record ``fn`` as one op."""
    return record_call(op_name or getattr(fn, "__name__", "op"), fn, args,
                       kwargs)


def _draw_seed_tensor():
    from ..core.random import draw_seed

    return torch.tensor(draw_seed(), dtype=torch.int64)


def symbolic_seed():
    """A recorded draw of one seed: every replay draws a fresh one from
    the port's generator (a host int64 scalar), so a recorded program's
    dropout masks are new on each ``Executor.run``, and repeat under
    ``paddle.seed``."""
    prog = default_main_program()
    with dispatch.internal():
        out = torch.empty((), dtype=torch.int64, device="meta")
    prog.add_var(id(out), f"seed_{len(prog.nodes)}", out)
    prog.add_node(StaticNode(fn=_draw_seed_tensor, in_ids=[],
                             const_args=None, out_ids=[id(out)],
                             name="seed"))
    return out
